"""repro_torch.models — the LM substrate of the port.

A :class:`ModelConfig` + the generic :mod:`repro_torch.models.model`
machinery, as in ``repro.models``.
"""

from .config import ModelConfig
from .convert import params_from_numpy
from .model import (decode_step, forward, init_decode_state, init_params,
                    loss_fn, prefill)

__all__ = ["ModelConfig", "init_params", "forward", "loss_fn", "prefill",
           "decode_step", "init_decode_state", "params_from_numpy"]
