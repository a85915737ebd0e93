"""AdamW and learning-rate schedules as plain tensor functions (ports
:mod:`repro.optim`; no ``torch.optim``)."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
]
