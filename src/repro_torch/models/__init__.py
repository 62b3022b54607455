"""The port's models: the paper's MLP (:mod:`repro_torch.models.mlp`),
the RWKV-6 LM (:mod:`repro_torch.models.rwkv6`), the Zamba2 hybrid
(:mod:`repro_torch.models.mamba2`; both in
:mod:`repro_torch.models.ssm_models`) and the dense and MoE transformers
(:mod:`repro_torch.models.transformer`, :mod:`repro_torch.models.moe`)
behind :class:`repro_torch.models.model_api.Model`."""
