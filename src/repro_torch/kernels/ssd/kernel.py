"""Launch of the CUDA chunked SSD-scan kernels: ``csrc/ssd_scan.cu`` for
zamba2's N = P = 64 and ``csrc/ssd_scan_wide.cu`` for xlstm's N = 512,
P = 513 (q and k as c and b, v with a column of ones as x); and of the
backward at both shapes, ``csrc/ssd_scan_bwd.cu`` (64 / 64) and
``csrc/ssd_scan_bwd_wide.cu`` (512 / 513).

Both forwards replace ``src/repro/kernels/ssd/kernel.py:ssd_scan_pallas``;
each source's header says what bounds it on the H100 and how its design
answers that.  This module checks what the kernels take, picks one by (N,
P), allocates the outputs and the workspaces, launches on PyTorch's current
stream and counts each launch under its kernel's name.  The wide scan is
two kernels: a first pass (``ssd_wide_prep``) writes each chunk's masked,
decayed c·bᵀ and gates into the workspace, then the scan
(``ssd_scan_wide``) reads them.

The JAX wrapper pads S to a multiple of the chunk with zeros; the kernels
mask the ragged last chunk themselves (rows past S act as log_a = 0,
gate = 0), so no padded copy is made.

c and b may have a head dim of 1 (zamba2's Mamba2 block: one b and c for
all heads, the JAX block's ``broadcast_to``): the forward reads them over
x's heads with a head stride of 0, and the backward returns their gradients
summed over the heads, in that shape.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

# (N, P) → launch counter: zamba2's state 64 and head dim 64; xlstm's
# d_head 512 and d_head + 1 (the normalizer's column of ones)
KERNELS = {(64, 64): "ssd_scan", (512, 513): "ssd_scan_wide"}
SHAPES = tuple(KERNELS)
WIDE = (512, 513)
# (N, P) the backward kernels take: zamba2's and xlstm's
BWD_SHAPES = ((64, 64), WIDE)

# The wide kernel's first pass: one record a (batch, head, 64-row chunk),
# M's bf16 high part and remainder as two 64 x 64 tiles (8 KB each) and the
# chunk's gates in 1 KB (csrc/ssd_scan_wide.cu: REC).
WIDE_CHUNK = 64
WIDE_RECORD = 2 * 8192 + 1024


def wide_workspace_bytes(B: int, H: int, S: int) -> int:
    """Bytes of the wide kernel's workspace: a record per chunk."""
    return B * H * -(-S // WIDE_CHUNK) * WIDE_RECORD


def padded_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of x's shape, dtype and device whose dims are laid
    out in the order of x's strides (a (B, H, S, P) view of a (B, S, H, P)
    tensor gets the same layout) with the last dim's pitch rounded up to a
    multiple of 8 elements, so each row starts 16-byte aligned.  For a dense
    x with such a pitch it is ``torch.empty_like(x)``."""
    lead = sorted(range(x.dim() - 1), key=lambda d: -x.stride(d))
    last = x.shape[-1]
    full = torch.empty([x.shape[d] for d in lead] + [-(-last // 8) * 8],
                       dtype=x.dtype, device=x.device)
    inv = [lead.index(d) for d in range(x.dim() - 1)] + [x.dim() - 1]
    return full[..., :last].permute(inv)


def broadcast_heads(c, b, x):
    """c and b seen over x's heads: a head dim of 1 expanded with a head
    stride of 0 (no copy); any other shape as it is."""
    if c.dim() == 4 and x.dim() == 4 and c.shape[1] == 1 and x.shape[1] > 1:
        shape = (c.shape[0], x.shape[1], *c.shape[2:])
        return c.expand(shape), b.expand(shape)
    return c, b


def ssd_launch_args(c, b, x, log_a, gate, y) -> tuple:
    """Check the inputs and the output y for the kernel and return the C
    call's scalar arguments: (B, H, S, N, P, 18 strides) with the
    (batch, head, seq) strides of c, b, x, y, log_a and gate.  c and b of
    a head dim of 1 are read over x's heads (``broadcast_heads``)."""
    c, b = broadcast_heads(c, b, x)
    if c.dim() != 4 or b.shape != c.shape or x.dim() != 4:
        raise ValueError("ssd scan takes c, b (B,H,S,N) and x (B,H,S,P)")
    B, H, S, N = c.shape
    P = x.shape[-1]
    if x.shape[:3] != (B, H, S) or y.shape != x.shape:
        raise ValueError(f"shapes disagree: c {tuple(c.shape)}, x "
                         f"{tuple(x.shape)}, y {tuple(y.shape)}")
    if log_a.shape != (B, H, S) or gate.shape != (B, H, S):
        raise ValueError(f"log_a and gate must be ({B}, {H}, {S}), got "
                         f"{tuple(log_a.shape)} and {tuple(gate.shape)}")
    if (N, P) not in SHAPES:
        raise ValueError(
            f"ssd kernels take (N, P) in {SHAPES} (zamba2, xlstm), not "
            f"({N}, {P}); another shape needs its own tiling (ROADMAP.md)")
    if B == 0 or H == 0 or S == 0:
        raise ValueError("ssd kernel needs B, H and S > 0")
    for name, t in (("c", c), ("b", b), ("x", x), ("y", y)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ssd kernel takes bf16 c, b, x; {name} is "
                            f"{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride on its last dim")
        # cp.async / 4-byte stores need 16-byte aligned rows; a head stride
        # of 0 (b and c shared by all heads) is allowed.  A dense row of 513
        # bf16 (1,026 bytes) is not aligned: such rows go in a buffer whose
        # pitch is a multiple of 8 elements, passed as a [..., :513] view
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name} rows must be 16-byte aligned (strides "
                f"{t.stride()}): allocate them with a row pitch that is a "
                f"multiple of 8 elements and pass a [..., :{t.shape[-1]}] "
                "view")
    for name, t in (("log_a", log_a), ("gate", gate)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd kernel takes fp32 {name}, got {t.dtype}")
    strides = (*c.stride()[:3], *b.stride()[:3], *x.stride()[:3],
               *y.stride()[:3], *log_a.stride(), *gate.stride())
    return (B, H, S, N, P, *strides)


def ssd_wide_prep_cuda(c, b, log_a, gate) -> torch.Tensor:
    """The wide kernel's first pass on c, b (B, H, S, 512) bf16 and log_a,
    gate (B, H, S) fp32 on one CUDA device: the records (B·H·chunks ×
    WIDE_RECORD bytes, uint8) that ``ssd_scan_wide`` reads."""
    B, H, S, _ = c.shape
    ws = torch.empty(wide_workspace_bytes(B, H, S), dtype=torch.uint8,
                     device=c.device)
    lib = library()
    if lib.ssd_scan_wide_workspace(B, H, S) != ws.numel():
        raise RuntimeError("the wide ssd record size disagrees with "
                           "csrc/ssd_scan_wide.cu")
    status = lib.ssd_scan_wide_prep(
        c.data_ptr(), b.data_ptr(), log_a.data_ptr(), gate.data_ptr(),
        ws.data_ptr(), B, H, S, *c.stride()[:3], *b.stride()[:3],
        *log_a.stride(), *gate.stride(), stream_ptr(c.device))
    check_status("ssd_wide_prep", status)
    count_launch("ssd_wide_prep")
    return ws


def ssd_scan_cuda(c, b, x, log_a, gate):
    """c, b: (B, H, S, N) or (B, 1, S, N) bf16; x: (B, H, S, P) bf16;
    log_a, gate: (B, H, S) fp32; all on one CUDA device, read through their
    strides (zamba2's b and c may have a head stride of 0).  Returns y
    (B, H, S, P) bf16 in x's layout with a row pitch of a multiple of 8
    (:func:`padded_like`), and s_final (B, H, N, P) fp32."""
    c, b = broadcast_heads(c, b, x)
    y = padded_like(x)
    args = ssd_launch_args(c, b, x, log_a, gate, y)
    B, H, _, N, P = args[:5]
    s_final = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    ptrs = (c.data_ptr(), b.data_ptr(), x.data_ptr(), log_a.data_ptr(),
            gate.data_ptr(), y.data_ptr(), s_final.data_ptr())
    name = KERNELS[N, P]
    if (N, P) == WIDE:
        ws = ssd_wide_prep_cuda(c, b, log_a, gate)
        status = library().ssd_scan_wide_fwd(*ptrs, ws.data_ptr(), *args,
                                             stream_ptr(x.device))
    else:
        status = library().ssd_scan_fwd(*ptrs, *args, stream_ptr(x.device))
    check_status(name, status)
    count_launch(name)
    return y, s_final


def check_bwd_shape(N: int, P: int) -> None:
    """Raise ``NotImplementedError`` for an (N, P) no backward kernel
    takes."""
    if (N, P) not in BWD_SHAPES:
        raise NotImplementedError(
            f"the SSD scan's backward kernels take (N, P) in {BWD_SHAPES} "
            f"(zamba2, xlstm), not ({N}, {P}): another shape needs its own "
            "tiling (ROADMAP.md B5)")


# The backward's workspace at 64 / 64: each (batch, head, 64-row chunk)'s
# state entering the chunk and the gradient reaching its end, each a 64 x 64
# fp32 matrix in the order of the wgmma accumulators that hold it
# (csrc/ssd_scan_bwd.cu: STATE_BYTES).  At 512 / 513 the states stay on the
# chip: each chunk's record (M and dM∘D in three bf16 parts each, 48 KB, and
# the gates, dgate's first term and x's, dy's and (Mᵀ dy)'s column 512 in
# 3 KB) and the eight bands' shares of c·dc, q and (B G)[:, 512] (fp32),
# and each (batch, head)'s eight shares of ⟨ds_final, S_in⟩
# (csrc/ssd_scan_bwd_wide.cu: REC, SHARE, BANDS).
BWD_CHUNK = 64
BWD_STATE_BYTES = 64 * 64 * 4
WIDE_BWD_CHUNK_BYTES = (6 * 8192 + 3072) + 4 * 3 * 8 * 64
WIDE_BWD_HEAD_BYTES = 4 * 8


def bwd_workspace_bytes(B: int, H: int, S: int, shape=(64, 64)) -> int:
    """Bytes of the backward's workspace at ``shape`` = (N, P): two states
    a chunk at 64 / 64; at 512 / 513 a record and the bands' shares a
    chunk, and ⟨ds_final, S_in⟩'s shares a (batch, head)."""
    chunks = B * H * -(-S // BWD_CHUNK)
    if tuple(shape) == WIDE:
        return chunks * WIDE_BWD_CHUNK_BYTES + B * H * WIDE_BWD_HEAD_BYTES
    return 2 * chunks * BWD_STATE_BYTES


def _tma_ready(t):
    """t itself if the backward kernels can read it (unit last stride,
    other strides multiples of 8 elements, at most one of them 0, a 16-byte
    aligned base), else a copy into a buffer laid out as t whose rows start
    16-byte aligned (:func:`padded_like`).  dy comes back from autograd in
    any layout, often dense: at P 513 a dense row is 1,026 bytes, so no
    ``.contiguous()`` would do."""
    st = t.stride()
    if (st[-1] == 1 and all(s % 8 == 0 for s in st[:3])
            and sum(s == 0 for s in st[:3]) <= 1 and t.data_ptr() % 16 == 0):
        return t
    return padded_like(t).copy_(t)


def wide_bwd_operands(c, b, x, dy):
    """c, b, x and dy as the wide backward reads them (:func:`_tma_ready`)
    and the dx it writes, in x's layout with a row pitch of a multiple of 8
    (:func:`padded_like`): every row of each 16-byte aligned."""
    c, b, x, dy = (_tma_ready(t) for t in (c, b, x, dy))
    return c, b, x, dy, padded_like(x)


def ssd_scan_bwd_cuda(c, b, x, log_a, gate, dy, ds_final=None):
    """The backward of the scan (``ref.ssd_chunked_bwd_ref``'s function) on
    one CUDA device, at (N, P) = (64, 64) or (512, 513): c, b (B, Hc, S, N)
    bf16 with Hc = H, or at 64 / 64 1 for a c and b shared by the heads;
    x and the upstream dy (B, H, S, P) bf16; log_a, gate (B, H, S) fp32;
    each read through its strides (dy in any layout autograd hands back);
    ds_final (B, H, N, P) fp32 or None for zero.  Returns (dc, db, dx,
    dlog_a, dgate): dc and db (B, Hc, S, N) bf16, summed over the heads
    where Hc = 1; dx bf16 in x's layout (a row pitch of a multiple of 8,
    :func:`padded_like`); dlog_a and dgate fp32 in log_a's layout.  Several
    kernels a call, one count: ``ssd_scan_bwd`` at 64 / 64,
    ``ssd_scan_bwd_wide`` at 512 / 513."""
    if c.dim() != 4 or b.shape != c.shape or x.dim() != 4:
        raise ValueError("ssd scan backward takes c, b (B,Hc,S,N) and x "
                         "(B,H,S,P)")
    B, Hc, S, N = c.shape
    H, P = x.shape[1], x.shape[-1]
    check_bwd_shape(N, P)
    if x.shape[::2] != (B, S) or Hc not in (1, H) or dy.shape != x.shape:
        raise ValueError(f"shapes disagree: c {tuple(c.shape)}, x "
                         f"{tuple(x.shape)}, dy {tuple(dy.shape)}")
    if log_a.shape != (B, H, S) or gate.shape != (B, H, S):
        raise ValueError(f"log_a and gate must be ({B}, {H}, {S}), got "
                         f"{tuple(log_a.shape)} and {tuple(gate.shape)}")
    if B == 0 or H == 0 or S == 0:
        raise ValueError("ssd kernel needs B, H and S > 0")
    for name, t in (("c", c), ("b", b), ("x", x), ("dy", dy)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ssd backward takes bf16 c, b, x, dy; {name} "
                            f"is {t.dtype}")
    for name, t in (("log_a", log_a), ("gate", gate)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd backward takes fp32 {name}, got {t.dtype}")
    if ds_final is not None:
        if ds_final.shape != (B, H, N, P):
            raise ValueError(f"ds_final must be ({B}, {H}, {N}, {P}), got "
                             f"{tuple(ds_final.shape)}")
        ds_final = ds_final.float().contiguous()
    if (N, P) == WIDE:
        if Hc != H:
            raise ValueError("the wide backward takes c and b per head "
                             f"(xlstm's q and k), got a head dim of {Hc}")
        return _ssd_scan_bwd_wide(c, b, x, log_a, gate, dy, ds_final)
    c, b, x, dy = (_tma_ready(t) for t in (c, b, x, dy))
    bf = dict(dtype=torch.bfloat16, device=x.device)
    dc, db = (torch.empty((B, Hc, S, N), **bf) for _ in range(2))
    dx = padded_like(x)
    dlog_a, dgate = (torch.empty_like(log_a) for _ in range(2))
    ws = torch.empty(bwd_workspace_bytes(B, H, S), dtype=torch.uint8,
                     device=x.device)
    lib = library()
    if lib.ssd_scan_bwd_workspace(B, H, S) != ws.numel():
        raise RuntimeError("the ssd backward's workspace size disagrees "
                           "with csrc/ssd_scan_bwd.cu")
    status = lib.ssd_scan_bwd(
        c.data_ptr(), b.data_ptr(), x.data_ptr(), dy.data_ptr(),
        log_a.data_ptr(), gate.data_ptr(),
        None if ds_final is None else ds_final.data_ptr(),
        dc.data_ptr(), db.data_ptr(), dx.data_ptr(), dlog_a.data_ptr(),
        dgate.data_ptr(), ws.data_ptr(), B, H, Hc, S, N, P,
        *c.stride()[:3], *b.stride()[:3], *x.stride()[:3],
        *dy.stride()[:3], *dx.stride()[:3], *log_a.stride(),
        *gate.stride(), *dlog_a.stride(), *dgate.stride(),
        stream_ptr(x.device))
    check_status("ssd_scan_bwd", status)
    count_launch("ssd_scan_bwd")
    return dc, db, dx, dlog_a, dgate


def _ssd_scan_bwd_wide(c, b, x, log_a, gate, dy, ds_final):
    """``csrc/ssd_scan_bwd_wide.cu`` on checked inputs: c, b (B, H, S, 512)
    (a head stride of 0 allowed), x, dy (B, H, S, 513)."""
    B, H, S, N = c.shape
    P = x.shape[-1]
    c, b, x, dy, dx = wide_bwd_operands(c, b, x, dy)
    dc, db = (torch.empty((B, H, S, N), dtype=torch.bfloat16,
                          device=x.device) for _ in range(2))
    dlog_a, dgate = (torch.empty_like(log_a) for _ in range(2))
    ws = torch.empty(bwd_workspace_bytes(B, H, S, WIDE), dtype=torch.uint8,
                     device=x.device)
    lib = library()
    if lib.ssd_scan_bwd_wide_workspace(B, H, S) != ws.numel():
        raise RuntimeError("the wide ssd backward's workspace size disagrees "
                           "with csrc/ssd_scan_bwd_wide.cu")
    status = lib.ssd_scan_bwd_wide(
        c.data_ptr(), b.data_ptr(), x.data_ptr(), dy.data_ptr(),
        log_a.data_ptr(), gate.data_ptr(),
        None if ds_final is None else ds_final.data_ptr(),
        dc.data_ptr(), db.data_ptr(), dx.data_ptr(), dlog_a.data_ptr(),
        dgate.data_ptr(), ws.data_ptr(), B, H, S, N, P,
        *c.stride()[:3], *b.stride()[:3], *x.stride()[:3],
        *dy.stride()[:3], *dx.stride()[:3], *log_a.stride(),
        *gate.stride(), *dlog_a.stride(), *dgate.stride(),
        stream_ptr(x.device))
    check_status("ssd_scan_bwd_wide", status)
    count_launch("ssd_scan_bwd_wide")
    return dc, db, dx, dlog_a, dgate
