"""The port's models: the paper's MLP (:mod:`repro_torch.models.mlp`),
the RWKV-6 LM (:mod:`repro_torch.models.rwkv6`,
:mod:`repro_torch.models.ssm_models`) and the dense transformers
(:mod:`repro_torch.models.transformer`) behind
:class:`repro_torch.models.model_api.Model`."""
