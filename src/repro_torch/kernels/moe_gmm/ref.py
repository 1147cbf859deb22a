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


def moe_gmm_bwd_ref(x, w, dy, group_sizes):
    """The gradient of :func:`moe_gmm_ref` for the upstream gradient ``dy``
    (T, F): ``dx[i] = dy[i] @ w[e_i]^T`` and ``dw[e] = x_e^T @ dy_e`` over
    expert e's rows, each an fp32 product of the same values, cast once to
    x's and w's dtypes.  Rows past ``sum(group_sizes)`` get dx 0 and give
    nothing to dw (their forward rows are zeros); an expert with no rows
    gets dw 0.  Sizes and bounds are cut as in :func:`moe_gmm_ref`."""
    T, D = x.shape
    E = w.shape[0]
    if group_sizes.numel() != E:
        raise ValueError(f"{group_sizes.numel()} group sizes for {E} "
                         "experts")
    if dy.shape != (T, w.shape[-1]):
        raise ValueError(f"dy must be ({T}, {w.shape[-1]}), got "
                         f"{tuple(dy.shape)}")
    dx = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
    lo = 0
    for e, size in enumerate(group_sizes.tolist()):
        hi = min(lo + max(int(size), 0), T)
        if hi > lo:
            g = dy[lo:hi].float()
            dx[lo:hi] = g @ w[e].float().T
            dw[e] = x[lo:hi].float().T @ g
        lo = hi
    return dx.to(x.dtype), dw.to(w.dtype)


def moe_gmm_bwd_equal_ref(x, w, dy, capacity: int):
    """:func:`moe_gmm_bwd_ref` where every expert owns exactly ``capacity``
    rows: two batched fp32 products, dx = dy_e · w_e^T and dw = x_e^T ·
    dy_e, each cast once.  It reads no group size, so the dry run's fake
    tensors go through it."""
    E, D, F = w.shape
    if x.shape[0] != E * capacity:
        raise ValueError(f"equal groups of {capacity} over {E} experts need "
                         f"{E * capacity} rows, got {x.shape[0]}")
    g = dy.reshape(E, capacity, F).float()
    dx = torch.bmm(g, w.float().transpose(1, 2))
    dw = torch.bmm(x.reshape(E, capacity, D).float().transpose(1, 2), g)
    return dx.reshape(E * capacity, D).to(x.dtype), dw.to(w.dtype)
