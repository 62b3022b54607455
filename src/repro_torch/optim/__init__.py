"""The paper's SGD (:mod:`repro_torch.optim.sgd`)."""
