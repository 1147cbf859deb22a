"""repro_torch.optim — optimizers, schedules and gradient compression (the
counterpart of ``repro.optim``)."""

from .compress import (compressed_all_reduce, int8_compress_decompress,
                       make_error_feedback)
from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         pick_optimizer)
from .schedules import cosine_schedule, linear_warmup

__all__ = ["Optimizer", "adamw", "adafactor", "pick_optimizer",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup",
           "int8_compress_decompress", "make_error_feedback",
           "compressed_all_reduce"]
