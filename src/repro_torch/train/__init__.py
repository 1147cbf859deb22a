"""repro_torch.train — the microbatched train step and the fault-tolerant
loop (the counterpart of ``repro.train``)."""

from .loop import LoopConfig, LoopState, PreemptionError, TrainLoop
from .step import make_train_step

__all__ = ["make_train_step", "TrainLoop", "LoopConfig",
           "LoopState", "PreemptionError"]
