"""Launch of the CUDA fused LM-head cross-entropy forward
(``csrc/cross_entropy.cu``).

Replaces ``src/repro/kernels/cross_entropy/kernel.py:ce_forward_pallas`` and
the chunked forward the JAX package takes for a padded head; the source's
header says what bounds the kernel on the H100 and how its design answers
that.  This module checks what the kernel takes, allocates the outputs and
the scratch of per-tile partials (one (m, l, label logit) a token for each
tile of ``cross_entropy_split()`` vocabulary columns), launches (tile pass +
merge pass) on PyTorch's current stream and counts the launch.
"""

from __future__ import annotations

import torch

from ..common import check_status, count_launch, library, stream_ptr


def ce_launch_args(x, w, labels, n_valid: int, split: int) -> tuple:
    """Check the inputs for the kernel and return the C call's scalar
    arguments: (T, D, V, n_valid, n_split)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"cross entropy takes x (T, D) and w (D, V), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    T, D = x.shape
    V = w.shape[1]
    if labels.shape != (T,) or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous ({T},) int32, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"cross-entropy kernel takes bf16, {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if T == 0 or D % 32 or V % 8:
        raise ValueError(f"cross-entropy kernel needs T > 0, D % 32 == 0 and "
                         f"V % 8 == 0; got T={T}, D={D}, V={V}")
    if not 0 < n_valid <= V:
        raise ValueError(f"n_valid must be in [1, {V}], got {n_valid}")
    return (T, D, V, int(n_valid), -(-V // split))


def ce_forward_cuda(x, w, labels, n_valid: int | None = None):
    """x: (T, D), w: (D, V) bf16 contiguous; labels (T,) int32, on one CUDA
    device.  Returns (lse, label_logit), each (T,) fp32, over the columns
    below ``n_valid`` (default V)."""
    lib = library()
    n_valid = w.shape[1] if n_valid is None else n_valid
    args = ce_launch_args(x, w, labels, n_valid, lib.cross_entropy_split())
    T, n_split = args[0], args[4]
    f32 = dict(dtype=torch.float32, device=x.device)
    lse = torch.empty((T,), **f32)
    ll = torch.empty((T,), **f32)
    part = torch.empty((3, n_split, T), **f32)
    status = lib.cross_entropy_fwd(
        x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        ll.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        part[2].data_ptr(), *args, stream_ptr(x.device))
    check_status("cross_entropy", status)
    count_launch("cross_entropy")
    return lse, ll
