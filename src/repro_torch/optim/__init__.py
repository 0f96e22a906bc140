"""The optimizer and its schedules (the port's copy of `repro.optim`)."""
from .adamw import AdamWConfig, adamw_init, adamw_update
from .schedules import cosine_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_warmup"]
