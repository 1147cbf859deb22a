"""Launch of the CUDA chunked SSD-scan kernels: ``csrc/ssd_scan.cu`` for
zamba2's N = P = 64 and ``csrc/ssd_scan_wide.cu`` for xlstm's N = 512,
P = 513 (q and k as c and b, v with a column of ones as x).

Both replace ``src/repro/kernels/ssd/kernel.py:ssd_scan_pallas``; each
source's header says what bounds it on the H100 and how its design answers
that.  This module checks what the kernels take, picks one by (N, P),
allocates y, s_final and the wide kernel's workspace, launches on PyTorch's
current stream and counts each launch under its kernel's name.  The wide
scan is two kernels: a first pass (``ssd_wide_prep``) writes each chunk's
masked, decayed c·bᵀ and gates into the workspace, then the scan
(``ssd_scan_wide``) reads them.

The JAX wrapper pads S to a multiple of the chunk with zeros; the kernels
mask the ragged last chunk themselves (rows past S act as log_a = 0,
gate = 0), so no padded copy is made.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr

# (N, P) → launch counter: zamba2's state 64 and head dim 64; xlstm's
# d_head 512 and d_head + 1 (the normalizer's column of ones)
KERNELS = {(64, 64): "ssd_scan", (512, 513): "ssd_scan_wide"}
SHAPES = tuple(KERNELS)
WIDE = (512, 513)

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


def ssd_launch_args(c, b, x, log_a, gate, y) -> tuple:
    """Check the inputs and the output y for the kernel and return the C
    call's scalar arguments: (B, H, S, N, P, 18 strides) with the
    (batch, head, seq) strides of c, b, x, y, log_a and gate."""
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
    """c, b: (B, H, S, N) bf16; x: (B, H, S, P) bf16; log_a, gate: (B, H, S)
    fp32; all on one CUDA device, read through their strides (zamba2's b and
    c may have a head stride of 0).  Returns y (B, H, S, P) bf16 in x's
    layout with a row pitch of a multiple of 8 (:func:`padded_like`), and
    s_final (B, H, N, P) fp32."""
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
