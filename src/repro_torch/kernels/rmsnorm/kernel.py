"""RMSNorm for Hopper in Triton: the forward and its backward.

The forward replaces ``src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas``
(body ``_rms_kernel``).  The backward has no Pallas counterpart: the JAX
package cannot differentiate through ``rmsnorm_pallas`` (``pallas_call`` has
no reverse-mode rule and the kernel no ``custom_vjp``); it computes the
gradient of ``repro.kernels.rmsnorm.ref.rmsnorm_ref``.

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


def _rms_bwd_rows(x_ptr, w_ptr, dy_ptr, dx_ptr, dwp_ptr, n_rows, n_cols,
                  rows_per_prog, stride_x, stride_dy, stride_dx, eps,
                  BLOCK_D: "tl.constexpr"):
    # One program walks a contiguous run of rows: dx row by row, and its own
    # fp32 partial of dw in registers, written once at the end.
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < n_cols
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
    row0 = pid * rows_per_prog
    row1 = tl.minimum(row0 + rows_per_prog, n_rows)
    for row in range(row0, row1):
        r = row.to(tl.int64)
        x = tl.load(x_ptr + r * stride_x + cols, mask=mask,
                    other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + r * stride_dy + cols, mask=mask,
                     other=0.0).to(tl.float32)
        rstd = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / n_cols + eps)
        xhat = x * rstd
        g = dy * w
        c = tl.sum(g * xhat, axis=0) / n_cols
        dx = (g - xhat * c) * rstd
        tl.store(dx_ptr + r * stride_dx + cols,
                 dx.to(dx_ptr.dtype.element_ty), mask=mask)
        acc += dy * xhat
    tl.store(dwp_ptr + pid.to(tl.int64) * n_cols + cols, acc, mask=mask)


def _dw_sum(dwp_ptr, dw_ptr, n_prog, n_cols, BLOCK_C: "tl.constexpr"):
    # The second pass: sum the per-program partials of dw in a fixed order,
    # so dw is deterministic (no atomics).
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    mask = cols < n_cols
    acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
    for p in range(0, n_prog):
        acc += tl.load(dwp_ptr + p * n_cols + cols, mask=mask, other=0.0)
    tl.store(dw_ptr + cols, acc, mask=mask)


_JIT: dict = {}


def _kernel(fn=_rms_row):
    global tl
    if fn.__name__ not in _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT[fn.__name__] = triton.jit(fn)
    return _JIT[fn.__name__]


def _check(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Check x and weight for the kernels; returns x as (rows, D)."""
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
    return x2


def rmsnorm_triton(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) bf16/fp16/fp32 on CUDA, last dim contiguous; weight (D,)
    fp32.  Returns x's shape and dtype."""
    x2 = _check(x, weight)
    D = x.shape[-1]
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


def rmsnorm_bwd_triton(x: torch.Tensor, weight: torch.Tensor,
                       dy: torch.Tensor, eps: float = 1e-6):
    """The gradient of rmsnorm: (dx in x's shape and dtype, dw (D,) fp32).

    What bounds it on the H100: bytes.  It reads x and dy and writes dx (at
    (8192, 3584) bf16, 176 MB: 53 us at 3.35 TB/s); the dw partials are
    2 programs a streaming multiprocessor × D fp32, a few MB.  Each program
    takes a contiguous run of rows, one row at a time in registers, and
    keeps its dw partial in registers; a second launch sums the partials
    over the programs in a fixed order, so dw is deterministic."""
    x2 = _check(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} vs "
                         f"{tuple(x.shape)} {x.dtype}")
    D = x.shape[-1]
    dy2 = dy.reshape(-1, D)
    if dy2.stride(-1) != 1:
        dy2 = dy2.contiguous()
    rows = x2.shape[0]
    dx = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    dw = torch.zeros((D,), dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx.reshape(x.shape), dw
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per = -(-rows // min(rows, 2 * sms))
    n_prog = -(-rows // per)
    partial = torch.empty((n_prog, D), dtype=torch.float32, device=x.device)
    block_d = 1 << (D - 1).bit_length()
    num_warps = 8 if block_d >= 4096 else 4
    _kernel(_rms_bwd_rows)[(n_prog,)](
        x2, weight, dy2, dx, partial, rows, D, per, x2.stride(0),
        dy2.stride(0), dx.stride(0), float(eps), BLOCK_D=block_d,
        num_warps=num_warps)
    block_c = 128
    _kernel(_dw_sum)[(-(-D // block_c),)](partial, dw, n_prog, D,
                                          BLOCK_C=block_c, num_warps=4)
    count_launch("rmsnorm_bwd")
    return dx.reshape(x.shape), dw
