"""repro_torch.kernels — hand-written Hopper kernels for the LM hot spots.

Each kernel keeps the trio of ``repro.kernels``:

* ``kernel.py`` — the launch of the hand-written kernel (CUDA C++ under
  ``repro_torch/csrc``, or Triton) with its argument checks and launch count,
* ``ops.py``    — the public wrapper, dispatching on the input's device (CPU →
                  plain version; CUDA → kernel, raising on failure),
* ``ref.py``    — the plain PyTorch version: the CPU path and the oracle the
                  kernel is held against on the card.
"""

from .cross_entropy.ops import fused_cross_entropy
from .decode_attention.ops import decode_attention
from .flash_attention.ops import flash_attention
from .moe_gmm.ops import moe_gmm
from .rmsnorm.ops import rmsnorm
from .ssd.ops import ssd_scan

__all__ = ["rmsnorm", "flash_attention", "decode_attention",
           "fused_cross_entropy", "ssd_scan", "moe_gmm"]
