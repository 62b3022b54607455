"""Optimizers of the port (counterpart of ``repro.optim``): the paper's
SGD (:mod:`repro_torch.optim.sgd`), AdamW for the LLM-scale path
(:mod:`repro_torch.optim.adamw`) and its learning-rate schedules
(:mod:`repro_torch.optim.schedules`)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import (constant_lr, cosine_decay_lr,
                                         warmup_cosine_lr)
from repro_torch.optim.sgd import SGDState, sgd_init, sgd_update

__all__ = [
    "SGDState", "sgd_init", "sgd_update",
    "AdamWState", "adamw_init", "adamw_update",
    "constant_lr", "cosine_decay_lr", "warmup_cosine_lr",
]
