"""Histogram gradient-boosted trees — the XGBoost/LightGBM stand-in.

Two implementations of the same algorithm (squared loss, level-wise growth on
quantile-binned features):

* :func:`fit_numpy` / :func:`predict_numpy` — naive per-node/per-feature
  Python loops over ``np.bincount`` histograms (the interpreted-library tier),
* :func:`fit_torch` / :func:`predict_torch` — torch on the input's device
  (the native-backend tier, the reference's ``fit_jax`` / ``predict_jax``):
  a Python loop over boosting rounds (the reference's ``lax.scan``), the
  level-wise split search vectorized over (nodes × features × bins), and
  binning on the device with numpy's quantile and search rules, so the bins
  equal :func:`make_bins` / :func:`bin_data`'s bit for bit.

The torch tier sums gradients per (node, feature, bin) segment exactly and
in no particular order (:func:`segment_sum`): two fits on one device are
equal bit for bit, which the intermediate cache's reuse by signature
assumes.

The model is a dense array pack so it can flow through the DAG/cache as a
plain tensor:  trees[t] = (feature[node], threshold_bin[node], leaf[node...]).
"""

from __future__ import annotations

import numpy as np
import torch

N_BINS = 32  # fixed power-of-two bin count


# ---------------------------------------------------------------------------
# shared: quantile binning
# ---------------------------------------------------------------------------

def make_bins(X: np.ndarray, n_bins: int = N_BINS) -> np.ndarray:
    """(F, n_bins-1) ascending split thresholds per feature."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.nanquantile(X, qs, axis=0).T.copy()  # (F, n_bins-1)


def bin_data(X: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """Digitize each column; NaN → bin 0."""
    out = np.empty(X.shape, dtype=np.int32)
    for j in range(X.shape[1]):
        out[:, j] = np.searchsorted(bins[j], X[:, j], side="right")
    out[np.isnan(X)] = 0
    return np.clip(out, 0, bins.shape[1])


# ---------------------------------------------------------------------------
# numpy ("python"-tier) implementation
# ---------------------------------------------------------------------------

def fit_numpy(X: np.ndarray, y: np.ndarray, *, n_trees: int = 30,
              depth: int = 3, lr: float = 0.1, reg: float = 1.0,
              subsample: float = 1.0, seed: int = 0) -> np.ndarray:
    n, F = X.shape
    bins = make_bins(X)
    B = bin_data(X, bins)                      # (n, F) int32
    rng = np.random.default_rng(seed)
    n_nodes = 2 ** depth - 1                   # internal nodes
    n_leaves = 2 ** depth
    base = float(np.mean(y))
    pred = np.full(n, base)
    # model pack: per tree: feat(n_nodes), thr(n_nodes), leaf(n_leaves)
    feats = np.zeros((n_trees, n_nodes), dtype=np.int32)
    thrs = np.zeros((n_trees, n_nodes), dtype=np.int32)
    leaves = np.zeros((n_trees, n_leaves))

    for t in range(n_trees):
        g = pred - y                           # gradient of 0.5*(pred-y)^2
        if subsample < 1.0:
            use = rng.random(n) < subsample
        else:
            use = np.ones(n, dtype=bool)
        node = np.zeros(n, dtype=np.int32)     # node id per row, level order
        for d in range(depth):
            for k in range(2 ** d):
                nid = 2 ** d - 1 + k
                rows = use & (node == nid)
                if rows.sum() < 8:
                    feats[t, nid] = 0
                    thrs[t, nid] = N_BINS      # everything goes left
                    continue
                gb = g[rows]
                Bn = B[rows]
                best = (0.0, 0, N_BINS)
                g_tot = gb.sum()
                c_tot = gb.shape[0]
                for f in range(F):             # naive per-feature loop
                    hist_g = np.bincount(Bn[:, f], weights=gb,
                                         minlength=N_BINS)
                    hist_c = np.bincount(Bn[:, f], minlength=N_BINS)
                    cg = np.cumsum(hist_g)[:-1]
                    cc = np.cumsum(hist_c)[:-1]
                    gain = (cg ** 2 / (cc + reg)
                            + (g_tot - cg) ** 2 / (c_tot - cc + reg)
                            - g_tot ** 2 / (c_tot + reg))
                    bi = int(np.argmax(gain))
                    if gain[bi] > best[0]:
                        best = (float(gain[bi]), f, bi)
                _, bf, bb = best
                feats[t, nid] = bf
                thrs[t, nid] = bb
            # level-order: children of nid are 2*nid+1 (left), 2*nid+2 (right)
            go_right = B[np.arange(n), feats[t, node]] > thrs[t, node]
            node = node * 2 + 1 + go_right.astype(np.int32)
        # leaves
        leaf_id = node - (2 ** depth - 1)
        for k in range(n_leaves):
            rows = use & (leaf_id == k)
            gs = g[rows]
            leaves[t, k] = -lr * gs.sum() / (gs.shape[0] + reg)
        pred = pred + leaves[t, np.clip(leaf_id, 0, n_leaves - 1)]

    return pack(base, bins, feats, thrs, leaves, depth)


def predict_numpy(model: np.ndarray, X: np.ndarray) -> np.ndarray:
    base, bins, feats, thrs, leaves, depth = unpack(model, X.shape[1])
    B = bin_data(X, bins)
    n = X.shape[0]
    out = np.full(n, base)
    for t in range(feats.shape[0]):
        node = np.zeros(n, dtype=np.int32)
        for _ in range(depth):
            go_right = B[np.arange(n), feats[t, node]] > thrs[t, node]
            node = node * 2 + 1 + go_right.astype(np.int32)
        out += leaves[t, node - (2 ** depth - 1)]
    return out


# ---------------------------------------------------------------------------
# model packing (model = flat float64 array → flows through cache/DAG)
# ---------------------------------------------------------------------------

def pack(base, bins, feats, thrs, leaves, depth) -> np.ndarray:
    T, n_nodes = feats.shape
    F = bins.shape[0]
    header = np.array([base, T, n_nodes, leaves.shape[1], F, depth],
                      dtype=np.float64)
    return np.concatenate([header, bins.ravel(), feats.ravel().astype(np.float64),
                           thrs.ravel().astype(np.float64), leaves.ravel()])


def unpack(model: np.ndarray, F_expected: int):
    base = float(model[0])
    T, n_nodes, n_leaves, F, depth = (int(model[i]) for i in range(1, 6))
    off = 6
    bins = model[off:off + F * (N_BINS - 1)].reshape(F, N_BINS - 1)
    off += F * (N_BINS - 1)
    feats = model[off:off + T * n_nodes].reshape(T, n_nodes).astype(np.int32)
    off += T * n_nodes
    thrs = model[off:off + T * n_nodes].reshape(T, n_nodes).astype(np.int32)
    off += T * n_nodes
    leaves = model[off:off + T * n_leaves].reshape(T, n_leaves)
    return base, bins, feats, thrs, leaves, depth


# ---------------------------------------------------------------------------
# torch ("native"-tier) implementation, on the input's device
# ---------------------------------------------------------------------------

def nanquantile_cols(X: torch.Tensor, qs) -> torch.Tensor:
    """(len(qs), F) quantiles of each column of ``X``, NaNs ignored: numpy's
    ``nanquantile(..., axis=0)`` with its default "linear" method, computed
    in float64 with numpy's own index and interpolation formulas, so the
    result equals numpy's bit for bit.  An all-NaN column gives NaN.

    ``qs`` is a 1-D array or tensor (a tensor traces: a compiled segment
    hoists ``clip_outliers``'s tunable ``q`` to a 0-d tensor argument)."""
    X = X.double()
    S = torch.sort(X, dim=0).values                      # NaNs sort last
    m = (~torch.isnan(X)).sum(dim=0)                     # (F,) valid counts
    if not isinstance(qs, torch.Tensor):
        qs = torch.from_numpy(np.asarray(qs, np.float64))
    q = qs.to(dtype=torch.float64, device=X.device)[:, None]
    v = (m - 1).double()[None, :] * q            # numpy's "linear" index
    prev = torch.floor(v)
    last = (m - 1).clamp(min=0).double()[None, :].expand_as(v)
    above = v >= last
    below = v < 0
    prev = torch.where(above, last, torch.where(below, 0.0, prev))
    nxt = torch.where(above | below, prev, prev + 1.0)
    gamma = v - torch.where(above, -1.0, prev)           # as numpy's, where
    a = torch.gather(S, 0, prev.long())                  # a == b it is moot
    b = torch.gather(S, 0, nxt.long())
    diff = b - a
    out = torch.where(gamma >= 0.5, b - diff * (1.0 - gamma),
                      a + diff * gamma)
    return torch.where(m[None, :] > 0, out,
                       torch.full_like(out, float("nan")))


def make_bins_torch(X: torch.Tensor, n_bins: int = N_BINS) -> torch.Tensor:
    """:func:`make_bins` on ``X``'s device: (F, n_bins-1) float64."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return nanquantile_cols(X, qs).T.contiguous()


def bin_data_torch(X: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """:func:`bin_data` on ``X``'s device: (n, F) int32, NaN → bin 0."""
    Xd = X.double()
    out = torch.searchsorted(bins.double().contiguous(), Xd.T.contiguous(),
                             right=True).T
    out = torch.where(torch.isnan(Xd), 0, out)
    return out.clamp(0, bins.shape[1]).to(torch.int32)


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """float32 sums of ``values`` (broadcast to ``ids``' shape) per segment
    id, exact and independent of the order of the adds: each value is
    scaled by a power of two into an int64 fixed point (the scale leaves
    the largest possible sum 2^62), the integers are summed, and the sums
    are scaled back.  Integer adds commute, so the result is the same on
    every run (a float32 ``index_add_`` on CUDA is not).  The GBT passes
    its per-row gradients as (n, 1) against (n, F) ids, so the scaling
    runs once a row."""
    v = values.double()
    n_adds = ids.numel()
    bound = v.abs().max() * n_adds if n_adds else v.new_zeros(())
    exp = torch.ceil(torch.log2(bound.clamp(min=1e-300)))
    scale = torch.exp2(62.0 - exp.clamp(min=-900.0, max=900.0))
    fixed = torch.round(v * scale).to(torch.int64)
    sums = torch.zeros(n_segments, dtype=torch.int64, device=v.device)
    sums.index_add_(0, ids.reshape(-1).long(),
                    fixed.expand(ids.shape).reshape(-1))
    return (sums.double() / scale).float()


def _fit_torch_binned(B: torch.Tensor, y: torch.Tensor, base: float,
                      lr: float, reg: float, n_trees: int, depth: int,
                      n_bins: int):
    """B: (n, F) int32 binned features; y: (n,) float32 targets; returns
    (feats, thrs, leaves), each (n_trees, ·).

    Histograms via ONE flat segment sum per level over (node, feature, bin)
    ids — O(n·F) adds, no (n, F, bins) one-hot — with integer counts."""
    n, F = B.shape
    dev = B.device
    n_nodes = 2 ** depth - 1
    n_leaves = 2 ** depth
    feat_ids = torch.arange(F, dtype=torch.int64, device=dev)[None, :]
    rows = torch.arange(n, device=dev)
    B64 = B.long()
    pred = torch.full((n,), base, dtype=torch.float32, device=dev)
    all_feats, all_thrs, all_leaves = [], [], []
    for _ in range(n_trees):                    # the reference's lax.scan
        g = pred - y                                              # (n,)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        feats = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
        thrs = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
        for d in range(depth):
            first = 2 ** d - 1
            width = 2 ** d
            level_node = (node - first).clamp(0, width - 1)
            # flat segment id: ((node·F) + f)·bins + bin
            seg = (level_node[:, None] * F + feat_ids) * n_bins + B64
            n_segs = width * F * n_bins                           # (n, F)
            hist_g = segment_sum(g[:, None], seg, n_segs) \
                .reshape(width, F, n_bins)
            hist_c = torch.bincount(seg.reshape(-1), minlength=n_segs) \
                .float().reshape(width, F, n_bins)
            cg = torch.cumsum(hist_g, dim=-1)[..., :-1]
            cc = torch.cumsum(hist_c, dim=-1)[..., :-1]
            g_tot = hist_g.sum(dim=-1, keepdim=True)
            c_tot = hist_c.sum(dim=-1, keepdim=True)
            gain = (cg ** 2 / (cc + reg)
                    + (g_tot - cg) ** 2 / (c_tot - cc + reg)
                    - g_tot ** 2 / (c_tot + reg))        # (width, F, bins-1)
            bi = torch.argmax(gain.reshape(width, -1), dim=1)
            idx = first + torch.arange(width, device=dev)
            feats[idx] = bi // (n_bins - 1)
            thrs[idx] = bi % (n_bins - 1)
            go_right = B64[rows, feats[node]] > thrs[node]
            node = node * 2 + 1 + go_right.long()
        leaf_id = node - (2 ** depth - 1)
        Loh = torch.nn.functional.one_hot(leaf_id, n_leaves).float()
        gs = Loh.T @ g                                            # (leaves,)
        cs = Loh.sum(dim=0)
        leaf_vals = -lr * gs / (cs + reg)
        pred = pred + leaf_vals[leaf_id]
        all_feats.append(feats)
        all_thrs.append(thrs)
        all_leaves.append(leaf_vals)
    return (torch.stack(all_feats).to(torch.int32),
            torch.stack(all_thrs).to(torch.int32), torch.stack(all_leaves))


def pack_torch(base: float, bins, feats, thrs, leaves, depth) -> torch.Tensor:
    """:func:`pack` on the device: the same float64 layout."""
    T, n_nodes = feats.shape
    F = bins.shape[0]
    header = torch.tensor([base, T, n_nodes, leaves.shape[1], F, depth],
                          dtype=torch.float64, device=bins.device)
    return torch.cat([header, bins.double().reshape(-1),
                      feats.double().reshape(-1), thrs.double().reshape(-1),
                      leaves.double().reshape(-1)])


def unpack_torch(model: torch.Tensor):
    """:func:`unpack` of a float64 tensor pack (the header is read to the
    host: it fixes the shapes)."""
    base, T, n_nodes, n_leaves, F, depth = model[:6].tolist()
    T, n_nodes, n_leaves, F, depth = (int(v) for v in
                                      (T, n_nodes, n_leaves, F, depth))
    off = 6
    bins = model[off:off + F * (N_BINS - 1)].reshape(F, N_BINS - 1)
    off += F * (N_BINS - 1)
    feats = model[off:off + T * n_nodes].reshape(T, n_nodes).to(torch.int32)
    off += T * n_nodes
    thrs = model[off:off + T * n_nodes].reshape(T, n_nodes).to(torch.int32)
    off += T * n_nodes
    leaves = model[off:off + T * n_leaves].reshape(T, n_leaves)
    return float(base), bins, feats, thrs, leaves, depth


def fit_torch(X: torch.Tensor, y: torch.Tensor, *, n_trees: int = 30,
              depth: int = 3, lr: float = 0.1, reg: float = 1.0,
              subsample: float = 1.0, seed: int = 0) -> torch.Tensor:
    """:func:`fit_numpy`'s algorithm on ``X``'s device; returns the float64
    model pack as a tensor there."""
    bins = make_bins_torch(X)
    B = bin_data_torch(X, bins)
    yd = y.double().reshape(-1)
    base = float(yd.mean())
    if subsample < 1.0:
        # deterministic row subsample per seed (applied once — cheaper than
        # per-round; documented deviation of the fast tier)
        rng = np.random.default_rng(seed)
        keep = torch.from_numpy(rng.random(X.shape[0]) < subsample) \
            .to(X.device)
        B_fit, y_fit = B[keep], yd[keep]
    else:
        B_fit, y_fit = B, yd
    feats, thrs, leaves = _fit_torch_binned(
        B_fit, y_fit.float(), base, lr, reg, n_trees, depth, N_BINS)
    return pack_torch(base, bins, feats, thrs, leaves, depth)


def predict_torch(model: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """:func:`predict_numpy`'s traversal on ``X``'s device, in float32 as
    the reference's ``predict_jax`` runs it with x64 off."""
    base, bins, feats, thrs, leaves, depth = unpack_torch(model)
    B = bin_data_torch(X, bins).long()
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)
    leaves = leaves.float()
    feats, thrs = feats.long(), thrs.long()
    out = torch.full((n,), base, dtype=torch.float32, device=X.device)
    for t in range(feats.shape[0]):
        node = torch.zeros(n, dtype=torch.int64, device=X.device)
        for _ in range(depth):
            go_right = B[rows, feats[t][node]] > thrs[t][node]
            node = node * 2 + 1 + go_right.long()
        out = out + leaves[t][node - (2 ** depth - 1)]
    return out
