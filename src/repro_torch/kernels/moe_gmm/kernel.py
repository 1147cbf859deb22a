"""Launch of the CUDA grouped expert matmul (``csrc/moe_gmm.cu``).

Replaces ``src/repro/kernels/moe_gmm/kernel.py:moe_gmm_pallas``; the
source's header says what bounds the kernel on the H100 and how its two
designs answer that.  This module checks what the kernel takes, picks the
design from the shapes, allocates the output, launches on PyTorch's current
stream and counts the launch.  The group sizes stay on the device: the
kernel reads them itself, so a call never waits for the card.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

# experts a call may have: MAX_E in csrc/moe_gmm.cu
MAX_EXPERTS = 512
# rows of the decode design's tile (D_BT in csrc/moe_gmm.cu)
DECODE_ROWS = 16
DESIGNS = ("prefill", "decode")


def gmm_design(T: int, E: int) -> str:
    """The kernel design for T rows over E experts: "decode" (16-row tiles,
    the weights streamed) when the rows average at most 16 an expert, else
    "prefill" (128 x 256 tiles on the tensor cores).  It reads the shapes
    only: the group sizes stay on the device, and both designs are right for
    any sizes."""
    return "decode" if T <= DECODE_ROWS * E else "prefill"


def gmm_launch_args(x, w, group_sizes, out) -> tuple:
    """Check x, w, group_sizes and the output for the kernel and return
    the C call's scalar arguments: (T, D, F, E)."""
    if x.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError("moe_gmm takes x (T, D), w (E, D, F), group_sizes "
                         "(E,)")
    T, D = x.shape
    E, Dw, F = w.shape
    if Dw != D:
        raise ValueError(f"x has {D} columns, w has {Dw} rows per expert")
    if group_sizes.numel() != E:
        raise ValueError(f"{group_sizes.numel()} group sizes for {E} "
                         "experts")
    if out.shape != (T, F):
        raise ValueError(f"output must be ({T}, {F}), got {tuple(out.shape)}")
    if T == 0:
        raise ValueError("moe_gmm kernel needs T > 0")
    if not 0 < E <= MAX_EXPERTS:
        raise ValueError(f"moe_gmm kernel takes 1 to {MAX_EXPERTS} experts, "
                         f"not {E}")
    if D % 8 or F % 8:
        raise ValueError(f"moe_gmm kernel needs D and F multiples of 8 "
                         f"(16-byte rows), got {D} and {F}")
    for name, t in (("x", x), ("w", w), ("out", out)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"moe_gmm kernel takes bf16, {name} is "
                            f"{t.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"moe_gmm kernel takes int32 group sizes, got "
                        f"{group_sizes.dtype}")
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes),
                    ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"moe_gmm kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return T, D, F, E


def moe_gmm_cuda(x, w, group_sizes, design: str | None = None):
    """x: (T, D) bf16, rows sorted by expert; w: (E, D, F) bf16;
    group_sizes: (E,) int32; all contiguous on one CUDA device.  Returns
    (T, F) bf16: each row times its expert's weights, accumulated in fp32
    and rounded once; rows past ``sum(group_sizes)`` are zero.  ``design``
    overrides ``gmm_design``'s pick (the chip checks run both)."""
    out = torch.empty((x.shape[0], w.shape[-1]), dtype=torch.bfloat16,
                      device=x.device)
    args = gmm_launch_args(x, w, group_sizes, out)
    T, _, _, E = args
    design = design or gmm_design(T, E)
    if design not in DESIGNS:
        raise ValueError(f"moe_gmm design must be one of {DESIGNS}, not "
                         f"{design!r}")
    fn = (library().moe_gmm_decode_fwd if design == "decode"
          else library().moe_gmm_fwd)
    status = fn(
        x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        *args, stream_ptr(x.device))
    check_status("moe_gmm", status)
    count_launch("moe_gmm")
    return out
