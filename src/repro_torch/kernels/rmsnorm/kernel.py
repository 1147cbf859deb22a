"""RMSNorm for Hopper in Triton.

Replaces ``src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas`` (body
``_rms_kernel``).

What bounds it on the H100: bytes.  A row reduction and an elementwise scale,
no product: each row of x is read once and written once (at the prefill shape
(8192, 3584) bf16, 117 MB: 35 us at 3.35 TB/s).  One program per row holds the
whole row in registers (``BLOCK_D`` = next power of two ≥ D, masked), so x
crosses device memory once, as in the TPU kernel's single VMEM pass;
statistics are fp32 and the weight is fp32, the output is in x's dtype.

Triton is imported, and the kernel compiled, inside the launching function:
the CPU tests import this module where Triton is absent.
"""

from __future__ import annotations

import torch

from ..common import count_launch

tl = None  # triton.language, bound at the first launch


def _rms_row(x_ptr, w_ptr, o_ptr, n_cols, stride_x, stride_o, eps,
             BLOCK_D: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * rstd * w
    tl.store(o_ptr + row * stride_o + cols, y.to(o_ptr.dtype.element_ty),
             mask=mask)


_JIT = None


def _kernel():
    global _JIT, tl
    if _JIT is None:
        import triton
        import triton.language

        tl = triton.language
        _JIT = triton.jit(_rms_row)
    return _JIT


def rmsnorm_triton(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) bf16/fp16/fp32 on CUDA, last dim contiguous; weight (D,)
    fp32.  Returns x's shape and dtype."""
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"rmsnorm kernel takes bf16/fp16/fp32 x, not "
                        f"{x.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes an fp32 weight, not "
                        f"{weight.dtype}")
    D = x.shape[-1]
    if weight.shape != (D,) or not weight.is_contiguous():
        raise ValueError(f"weight must be contiguous ({D},), got "
                         f"{tuple(weight.shape)}")
    if D > 65536:
        raise ValueError(f"rmsnorm kernel holds a row in registers; D={D} "
                         "is too wide")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        raise ValueError("rmsnorm kernel needs unit stride on the last dim")
    rows = x2.shape[0]
    out = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out.reshape(x.shape)
    block_d = 1 << (D - 1).bit_length()
    num_warps = 8 if block_d >= 4096 else 4
    _kernel()[(rows,)](x2, weight, out, D, x2.stride(0), out.stride(0),
                       float(eps), BLOCK_D=block_d, num_warps=num_warps)
    count_launch("rmsnorm")
    return out.reshape(x.shape)
