"""The paper's MLP (:mod:`repro_torch.models.mlp`)."""
