"""repro_torch.optim — optimizers and schedules (the counterpart of
``repro.optim``).  Gradient compression (``repro.optim.compress``) comes
with the distributed slice (see ROADMAP.md)."""

from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         pick_optimizer)
from .schedules import cosine_schedule, linear_warmup

__all__ = ["Optimizer", "adamw", "adafactor", "pick_optimizer",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup"]
