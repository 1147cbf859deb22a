"""RMSNorm for Hopper: the forward in Triton, the backward in CUDA C++.

The forward replaces ``src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas``
(body ``_rms_kernel``).  What bounds it on the H100: bytes.  A row reduction
and an elementwise scale, no product: each row of x is read once and written
once (at the prefill shape (8192, 3584) bf16, 117 MB: 35 us at 3.35 TB/s).
One program per row holds the whole row in registers (``BLOCK_D`` = next
power of two ≥ D, masked), so x crosses device memory once, as in the TPU
kernel's single VMEM pass; statistics are fp32 and the weight is fp32, the
output is in x's dtype.  Triton is imported, and the kernel compiled, inside
the launching function: the CPU tests import this module where Triton is
absent.

The backward (``csrc/rmsnorm_bwd.cu``) has no Pallas counterpart: the JAX
package cannot differentiate through ``rmsnorm_pallas`` (``pallas_call`` has
no reverse-mode rule and the kernel no ``custom_vjp``); it computes the
gradient of ``repro.kernels.rmsnorm.ref.rmsnorm_ref``.  The source's header
says what bounds it and how its design answers that; this module picks its
launch (:func:`rmsnorm_bwd_launch_args`), allocates dx, dw and the per-block
dw partials, launches on PyTorch's current stream and counts the launch.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

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
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language

        tl = triton.language
        _JIT = triton.jit(_rms_row)
    return _JIT


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


# ---------------------------------------------------------------------------
# the backward (csrc/rmsnorm_bwd.cu)
# ---------------------------------------------------------------------------

H100_SMS = 132
# element codes of the C entry point
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# these four mirror csrc/rmsnorm_bwd.cu: dynamic shared memory a block can
# opt into on the H100, the bytes ahead of w's copy (the slots' mbarriers
# and the row-sum buffers), the block's thread limit, and the warps of the
# dw sum
SMEM_LIMIT = 232448
HEAD_BYTES = 384
MAX_THREADS = 512
DW_SUM_WARPS = 8
# 16-byte vectors a thread of the bulk path takes (its template instances)
VECTORS = (1, 2, 4, 8)
# ring slots an SM, at most: two blocks of 2 or one of 4 (chip_smoke.py
# times the other launches at the train shape)
MAX_STAGES = 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def rmsnorm_bwd_launch_args(x, weight, dy, sms: int = H100_SMS) -> tuple:
    """Check x, weight and dy for the backward kernel and pick its launch.

    Returns (x as (rows, D), dy as (rows, D), args), args a dict: rows, D,
    the row strides sx and sdy (elements), kind (0 fp32, 1 bf16, 2 fp16),
    path ("bulk" or "rows"), grid, threads, vpt (16-byte vectors a thread;
    0 on the rows path), stages (ring slots; 0 on the rows path) and smem
    (dynamic shared bytes).

    The bulk path takes rows whose bytes and starts are 16-byte aligned and
    whose x and dy fit a ring of at least 2 slots beside w's fp32 copy; any
    other row goes the rows path.  The grid is persistent: at most two
    blocks an SM where a thread takes one vector (that kernel's launch
    bounds fit two), else one, and no more blocks than rows; block b takes
    rows b, b + grid, ...."""
    x2 = _check(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} vs "
                         f"{tuple(x.shape)} {x.dtype}")
    D = x.shape[-1]
    dy2 = dy.reshape(-1, D)
    if dy2.stride(-1) != 1:
        raise ValueError("rmsnorm kernel needs unit stride on dy's last dim")
    rows, es = x2.shape[0], x2.element_size()
    row_bytes, n_vec = D * es, D * es // 16
    aligned = row_bytes % 16 == 0 and weight.data_ptr() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) * es % 16 == 0
        for t in (x2, dy2))
    vpt = next((v for v in VECTORS if _ceil(n_vec, v) <= MAX_THREADS), None)
    blocks_per_sm = 2 if vpt == 1 else 1
    fixed = HEAD_BYTES + 4 * D
    # the card keeps 1 KB of an SM's shared memory for each block
    budget = SMEM_LIMIT // blocks_per_sm - 1024 * (blocks_per_sm - 1)
    stages = min(MAX_STAGES // blocks_per_sm,
                 (budget - fixed) // (2 * row_bytes))
    args = dict(rows=rows, D=D, sx=x2.stride(0), sdy=dy2.stride(0),
                kind=_KIND[x.dtype])
    if aligned and vpt is not None and stages >= 2:
        threads = 32 * _ceil(_ceil(n_vec, vpt), 32)
        args.update(path="bulk", threads=threads, vpt=vpt, stages=stages,
                    smem=fixed + stages * 2 * row_bytes)
    else:
        blocks_per_sm = 1
        args.update(path="rows", threads=min(MAX_THREADS, 32 * _ceil(D, 32)),
                    vpt=0, stages=0, smem=0)
    args["grid"] = min(rows, sms * blocks_per_sm)
    return x2, dy2, args


def rmsnorm_bwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                     dy: torch.Tensor, eps: float = 1e-6):
    """The gradient of rmsnorm on one CUDA device: (dx in x's shape and
    dtype, dw (D,) fp32).  x: (..., D) bf16/fp16/fp32, last dim contiguous;
    weight (D,) fp32; dy like x (copied if its last dim is strided)."""
    if dy.shape == x.shape and dy.dim() and dy.stride(-1) != 1:
        dy = dy.contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    x2, dy2, a = rmsnorm_bwd_launch_args(x, weight, dy, sms)
    rows, D = a["rows"], a["D"]
    dx = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows == 0:
        return dx.reshape(x.shape), torch.zeros((D,), dtype=torch.float32,
                                                device=x.device)
    dw = torch.empty((D,), dtype=torch.float32, device=x.device)
    partial = torch.empty((a["grid"], D), dtype=torch.float32,
                          device=x.device)
    status = library().rmsnorm_bwd(
        x2.data_ptr(), weight.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), rows, D, a["sx"], a["sdy"], D,
        float(eps), a["kind"], int(a["path"] == "bulk"), a["grid"],
        a["threads"], a["vpt"], a["stages"], a["smem"], stream_ptr(x.device))
    check_status("rmsnorm_bwd", status)
    count_launch("rmsnorm_bwd")
    return dx.reshape(x.shape), dw
