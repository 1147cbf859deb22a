"""Plain PyTorch grouped (per-expert) matmul: the counterpart of
``repro.kernels.moe_gmm.ref`` and of the equal-groups einsum in
``repro.kernels.moe_gmm.ops``.

The CPU path of ``moe_gmm`` and the oracle the CUDA kernel is held against
on the card.  It reads the group sizes on the host (one ``.tolist()``), so
it is never on the card's path.
"""

from __future__ import annotations

import torch


def moe_gmm_ref(x, w, group_sizes):
    """x: (T, D) rows sorted by expert; w: (E, D, F); group_sizes: (E,)
    int.  ``out[i] = x[i] @ w[e_i]`` for the expert e_i owning row i, each
    expert's rows one fp32 product, cast once to x's dtype.

    Rows past ``sum(group_sizes)`` come out as zero, as in the TPU kernel
    (its output tile is zeroed at expert 0 and no expert adds to such a
    row).  JAX's ``moe_gmm_ref`` instead gives them the last expert's
    product; no caller passes such sizes (the dispatch's sizes sum to T).
    Each size counts as at least 0 and each bound as at most T, as in the
    CUDA kernel."""
    T, F = x.shape[0], w.shape[-1]
    if group_sizes.numel() != w.shape[0]:
        raise ValueError(f"{group_sizes.numel()} group sizes for "
                         f"{w.shape[0]} experts")
    out = torch.zeros((T, F), dtype=torch.float32, device=x.device)
    lo = 0
    for e, size in enumerate(group_sizes.tolist()):
        hi = min(lo + max(int(size), 0), T)
        if hi > lo:
            out[lo:hi] = x[lo:hi].float() @ w[e].float()
        lo = hi
    return out.to(x.dtype)


def moe_gmm_equal_ref(x, w, capacity: int):
    """Every expert owns exactly ``capacity`` rows (the dispatch's buffer):
    one batched fp32 product (E, C, D) @ (E, D, F), cast once."""
    E, D, F = w.shape
    if x.shape[0] != E * capacity:
        raise ValueError(f"equal groups of {capacity} over {E} experts need "
                         f"{E * capacity} rows, got {x.shape[0]}")
    out = torch.bmm(x.reshape(E, capacity, D).float(), w.float())
    return out.reshape(E * capacity, F).to(x.dtype)
