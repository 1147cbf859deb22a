"""Physical implementations of the tabular operator vocabulary.

Two tiers per logical op (paper §4.2 "tiered operator hierarchy"):

* ``python`` — the Pandas/scikit-learn stand-in: eager NumPy in float64 with
  the overheads the paper attributes to these libraries (validation passes à
  la ``check_array``, defensive copies, temporaries, no fusion),
* ``torch``  — the native-backend analogue, the reference's ``jax`` tier:
  float32 torch ops on the session's device (cuBLAS, cuSOLVER and the torch
  kernels play the role of the Rust/Rayon kernels).  The runtime hands each
  impl its inputs on that device (``core.runtime.to_tier``).

Also registered here: metadata (shape/flops) rules and columnwise structural
declarations used by projection pushdown.
"""

from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from ..core.dag import LazyOp, declare_tunable
from ..core.metadata import OpMetadata, TensorInfo, register_meta
from ..core.rewrites import declare_columnwise
from ..core.runtime import linalg_ready, to_host
from ..core.selection import register_impl
from ..data import tabular as datasets
from . import gbt

F64, F32 = "float64", "float32"


def _validate(X):
    """sklearn-style check_array pass: full scan + dtype copy."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    np.isinf(X).any()  # full pass, result intentionally unused (cost model)
    return X.copy()    # defensive copy, as sklearn with copy=True


def _rows(op, i=0):
    return op.inputs[i].op.meta.outputs[op.inputs[i].index].rows


# ===========================================================================
# sources & structural
# ===========================================================================

@register_impl("read", "python")
def read_py(op: LazyOp, ins):
    """Interpreted tier: CSV parse per execution — what agent scripts do
    (pd.read_csv); the paper: 'repeated data loading often dominates'."""
    X = datasets.load_csv(op.spec["dataset"], op.spec["n_rows"],
                          op.spec.get("seed", 0))
    return (X,)


@register_impl("read", "torch")
def read_native(op: LazyOp, ins):
    """Native tier: binary column store (the Polars/Arrow reader analogue).
    It returns host numpy, as the reference's does; the runtime moves it to
    the device for a torch consumer."""
    X = datasets.load_binary(op.spec["dataset"], op.spec["n_rows"],
                             op.spec.get("seed", 0))
    return (np.asarray(X),)


@register_meta("read")
def read_meta(op, ins):
    cols = len(datasets.UK_HOUSING_SCHEMA)
    info = TensorInfo((op.spec["n_rows"], cols), F64)
    return OpMetadata(outputs=[info], flops=5.0 * info.rows * info.cols,
                      peak_bytes=2 * info.nbytes, library="io")


@register_impl("project", "python")
def project_py(op, ins):
    X = _validate(ins[0])
    return (X[:, list(op.spec["cols"])].copy(),)


@register_impl("project", "torch", traceable=True)
def project_torch(op, ins):
    return (ins[0][:, list(op.spec["cols"])],)


@register_meta("project")
def project_meta(op, ins):
    info = TensorInfo((ins[0].rows, len(op.spec["cols"])), ins[0].dtype)
    return OpMetadata(outputs=[info], flops=info.rows * info.cols,
                      peak_bytes=ins[0].nbytes + info.nbytes)


@register_impl("concat", "python")
def concat_py(op, ins):
    arrs = [_validate(x) for x in ins]
    return (np.hstack(arrs),)


@register_impl("concat", "torch", traceable=True)
def concat_torch(op, ins):
    arrs = [x if x.dim() == 2 else x.reshape(len(x), -1) for x in ins]
    return (torch.cat(arrs, dim=1),)


@register_meta("concat")
def concat_meta(op, ins):
    cols = sum(t.cols for t in ins)
    info = TensorInfo((ins[0].rows, cols), ins[0].dtype)
    return OpMetadata(outputs=[info], flops=info.rows * cols,
                      peak_bytes=2 * info.nbytes)


@register_impl("join", "python")
def join_py(op, ins):
    L, R = _validate(ins[0]), _validate(ins[1])
    lk, rk = op.spec["left_key"], op.spec["right_key"]
    order = np.argsort(R[:, rk], kind="stable")
    Rs = R[order]
    idx = np.searchsorted(Rs[:, rk], L[:, lk])
    idx = np.clip(idx, 0, len(Rs) - 1)
    matched = Rs[idx]
    keep = [j for j in range(R.shape[1]) if j != rk]
    return (np.hstack([L, matched[:, keep]]),)


@register_meta("join")
def join_meta(op, ins):
    cols = ins[0].cols + ins[1].cols - 1
    info = TensorInfo((ins[0].rows, cols), F64)
    return OpMetadata(outputs=[info],
                      flops=float(ins[1].rows) * np.log2(max(ins[1].rows, 2))
                      + ins[0].rows,
                      peak_bytes=2 * (ins[0].nbytes + ins[1].nbytes))


# ===========================================================================
# elementwise / columnwise feature transforms (projection pushdown targets)
# ===========================================================================

@register_impl("log1p", "python")
def log1p_py(op, ins):
    X = _validate(ins[0])
    return (np.log1p(np.maximum(X, 0.0)),)


def _f32(x):
    """A float32 tensor (the reference's ``jnp.asarray(x, jnp.float32)``)."""
    return x.float()


@register_impl("log1p", "torch", traceable=True)
def log1p_torch(op, ins):
    X = _f32(ins[0])
    return (torch.log1p(torch.clamp(X, min=0.0)),)


@register_impl("clip_outliers", "python")
def clip_py(op, ins):
    X = _validate(ins[0])
    q = op.spec.get("q", 0.01)
    lo = np.nanquantile(X, q, axis=0)
    hi = np.nanquantile(X, 1 - q, axis=0)
    return (np.clip(X, lo, hi),)


def _tunable(value, dtype, device):
    """A tunable spec value (a python float on the per-op path, a 0-d
    tensor when a compiled segment hoists it to an argument) as a 0-d tensor
    of ``dtype``: both give the same bits for the same value."""
    return torch.as_tensor(value, dtype=dtype, device=device)


@register_impl("clip_outliers", "torch", traceable=True)
def clip_torch(op, ins):
    X = _f32(ins[0])
    q = _tunable(op.spec.get("q", 0.01), torch.float64, X.device)
    lo, hi = gbt.nanquantile_cols(X, torch.stack([q, 1 - q])).float()
    return (torch.minimum(torch.maximum(X, lo), hi),)


declare_columnwise("log1p", "clip_outliers", "cleaner")

for _name in ("log1p", "clip_outliers"):
    @register_meta(_name)
    def _elem_meta(op, ins):
        info = TensorInfo(ins[0].shape, ins[0].dtype)
        return OpMetadata(outputs=[info], flops=4.0 * info.rows * info.cols,
                          peak_bytes=3 * info.nbytes)


# ===========================================================================
# fitted preprocessing (fit/apply pairs)
# ===========================================================================

@register_impl("impute_fit", "python")
def impute_fit_py(op, ins):
    X = _validate(ins[0])
    if op.spec.get("strategy", "mean") == "median":
        stats = np.nanmedian(X, axis=0)
    else:
        stats = np.nanmean(X, axis=0)
    return (np.nan_to_num(stats),)


@register_impl("impute_fit", "torch", traceable=True)
def impute_fit_torch(op, ins):
    X = _f32(ins[0])
    stats = torch.nanmean(X, dim=0)
    return (torch.nan_to_num(stats),)


@register_impl("impute_apply", "python")
def impute_apply_py(op, ins):
    stats, X = np.asarray(ins[0]), _validate(ins[1])
    mask = np.isnan(X)
    X[mask] = np.broadcast_to(stats, X.shape)[mask]
    return (X,)


@register_impl("impute_apply", "torch", traceable=True)
def impute_apply_torch(op, ins):
    stats, X = _f32(ins[0]), _f32(ins[1])
    return (torch.where(torch.isnan(X), stats[None, :], X),)


@register_meta("impute_fit")
def impute_fit_meta(op, ins):
    info = TensorInfo((ins[0].cols,), ins[0].dtype)
    return OpMetadata(outputs=[info], flops=2.0 * ins[0].rows * ins[0].cols,
                      peak_bytes=2 * ins[0].nbytes)


@register_meta("impute_apply")
def impute_apply_meta(op, ins):
    info = TensorInfo(ins[1].shape, ins[1].dtype)
    return OpMetadata(outputs=[info], flops=2.0 * info.rows * info.cols,
                      peak_bytes=3 * info.nbytes)


@register_impl("scaler_fit", "python")
def scaler_fit_py(op, ins):
    X = _validate(ins[0])
    mu = np.nanmean(X, axis=0)
    sd = np.nanstd(X, axis=0)
    sd[sd == 0] = 1.0
    return (np.stack([mu, sd]),)


@register_impl("scaler_fit", "torch", traceable=True)
def scaler_fit_torch(op, ins):
    X = _f32(ins[0])
    mu = torch.nanmean(X, dim=0)
    # jnp.nanstd: the root of the mean squared deviation of the non-NaN
    # entries (ddof 0)
    valid = ~torch.isnan(X)
    dev = torch.where(valid, X - mu, 0.0)
    sd = torch.sqrt((dev * dev).sum(dim=0) / valid.sum(dim=0))
    sd = torch.where(sd == 0, 1.0, sd)
    return (torch.stack([mu, sd]),)


@register_impl("scaler_apply", "python")
def scaler_apply_py(op, ins):
    stats, X = np.asarray(ins[0]), _validate(ins[1])
    centered = X - stats[0]          # temporary
    return (centered / stats[1],)    # second temporary


@register_impl("scaler_apply", "torch", traceable=True)
def scaler_apply_torch(op, ins):
    stats, X = _f32(ins[0]), _f32(ins[1])
    return ((X - stats[0]) / stats[1],)


@register_meta("scaler_fit")
def scaler_fit_meta(op, ins):
    info = TensorInfo((2, ins[0].cols), ins[0].dtype)
    return OpMetadata(outputs=[info], flops=4.0 * ins[0].rows * ins[0].cols,
                      peak_bytes=2 * ins[0].nbytes)


@register_meta("scaler_apply")
def scaler_apply_meta(op, ins):
    info = TensorInfo(ins[1].shape, ins[1].dtype)
    return OpMetadata(outputs=[info], flops=2.0 * info.rows * info.cols,
                      peak_bytes=3 * info.nbytes)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

@register_impl("onehot", "python")
def onehot_py(op, ins):
    X = _validate(ins[0])
    cards = op.spec["cards"]
    pieces = []
    for j, card in enumerate(cards):
        col = np.nan_to_num(X[:, j]).astype(np.int64)
        col = np.clip(col, 0, card - 1)
        out = np.zeros((len(col), card))
        for c in range(card):             # per-category loop (naive tier)
            out[:, c] = (col == c).astype(np.float64)
        pieces.append(out)
    return (np.hstack(pieces),)


@register_impl("onehot", "torch", traceable=True)
def onehot_torch(op, ins):
    X = torch.nan_to_num(ins[0])
    cards = op.spec["cards"]
    pieces = []
    for j, card in enumerate(cards):
        col = X[:, j].to(torch.int32).clamp(0, card - 1)
        pieces.append(torch.nn.functional.one_hot(col.long(), card).float())
    return (torch.cat(pieces, dim=1),)


@register_meta("onehot")
def onehot_meta(op, ins):
    cols = sum(op.spec["cards"])
    info = TensorInfo((ins[0].rows, cols), F32)
    return OpMetadata(outputs=[info], flops=float(info.rows) * cols,
                      peak_bytes=2 * info.nbytes)


def _hash_mix(ids: np.ndarray, dim: int, seed: int) -> np.ndarray:
    """SplitMix-style integer hash → (n, dim) pseudo-random features.
    uint64 wraparound is intended (modular arithmetic)."""
    with np.errstate(over="ignore"):
        z = (ids[:, None].astype(np.uint64)
             + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
             + (np.arange(dim, dtype=np.uint64)[None, :] + np.uint64(1))
             * np.uint64(0xBF58476D1CE4E5B9))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z.astype(np.float64) / 2.0 ** 64) * 2.0 - 1.0


@register_impl("string_encode", "python")
def string_encode_py(op, ins):
    X = _validate(ins[0])
    dim, seed = op.spec["dim"], op.seed or 0
    cols = []
    for j in range(X.shape[1]):
        ids = np.nan_to_num(X[:, j]).astype(np.int64)
        cols.append(_hash_mix(ids, dim, seed + j))
    return (np.hstack(cols),)


@register_impl("string_encode", "torch")
def string_encode_torch(op, ins):
    # hashing is integer-heavy; compute per unique id then gather (the fast
    # tier exploits low unique-count vs rows).  The unique ids (at most the
    # column's cardinality) go to the host (a counted crossing) and are
    # hashed there with the python tier's uint64 arithmetic; the gather over
    # the rows runs on the device.
    X = ins[0]
    dim, seed = op.spec["dim"], op.seed or 0
    cols = []
    for j in range(X.shape[1]):
        ids = torch.nan_to_num(X[:, j]).to(torch.int64)
        uniq, inv = torch.unique(ids, return_inverse=True)
        table = _hash_mix(to_host(uniq), dim, seed + j).astype(np.float32)
        cols.append(torch.from_numpy(table).to(X.device)[inv])
    return (torch.cat(cols, dim=1),)


@register_meta("string_encode")
def string_encode_meta(op, ins):
    info = TensorInfo((ins[0].rows, op.spec["dim"] * ins[0].cols), F64)
    return OpMetadata(outputs=[info],
                      flops=12.0 * info.rows * info.cols,
                      peak_bytes=2 * info.nbytes)


@register_impl("target_encode_fit", "python")
def te_fit_py(op, ins):
    x, y = _validate(ins[0]).ravel(), np.asarray(ins[1]).ravel()
    card, sm = op.spec["card"], op.spec.get("smoothing", 20.0)
    ids = np.clip(np.nan_to_num(x).astype(np.int64), 0, card - 1)
    sums = np.bincount(ids, weights=y, minlength=card)
    counts = np.bincount(ids, minlength=card)
    prior = y.mean()
    return ((sums + sm * prior) / (counts + sm),)


@register_impl("target_encode_fit", "torch", traceable=True)
def te_fit_torch(op, ins):
    x = torch.nan_to_num(ins[0].reshape(-1))
    y = _f32(ins[1]).reshape(-1)
    card = op.spec["card"]
    sm = _tunable(op.spec.get("smoothing", 20.0), y.dtype, y.device)
    ids = x.to(torch.int32).clamp(0, card - 1).long()
    sums = gbt.segment_sum(y, ids, card)          # exact, order-free
    # bincount's output length depends on the data; the ids are clamped
    # below card, so integer adds into card slots count the same, at a
    # shape a compiled segment can trace
    counts = torch.zeros(card, dtype=torch.int64, device=ids.device) \
        .index_add_(0, ids, torch.ones_like(ids)).float()
    prior = y.mean()
    return ((sums + sm * prior) / (counts + sm),)


@register_impl("target_encode_apply", "python")
def te_apply_py(op, ins):
    table, x = np.asarray(ins[0]), _validate(ins[1]).ravel()
    card = op.spec["card"]
    ids = np.clip(np.nan_to_num(x).astype(np.int64), 0, card - 1)
    return (table[ids].reshape(-1, 1),)


@register_impl("target_encode_apply", "torch", traceable=True)
def te_apply_torch(op, ins):
    table = _f32(ins[0])
    x = torch.nan_to_num(ins[1].reshape(-1))
    card = op.spec["card"]
    ids = x.to(torch.int32).clamp(0, card - 1).long()
    return (table[ids].reshape(-1, 1),)


@register_meta("target_encode_fit")
def te_fit_meta(op, ins):
    info = TensorInfo((op.spec["card"],), F64)
    return OpMetadata(outputs=[info], flops=6.0 * ins[0].rows,
                      peak_bytes=2 * ins[0].nbytes)


@register_meta("target_encode_apply")
def te_apply_meta(op, ins):
    info = TensorInfo((ins[1].rows, 1), F64)
    return OpMetadata(outputs=[info], flops=float(ins[1].rows),
                      peak_bytes=2 * info.nbytes + ins[1].nbytes)


@register_impl("datetime_encode", "python")
def dt_py(op, ins):
    days = _validate(ins[0]).ravel()
    year = days / 365.25
    month = (days % 365.25) / 30.44
    dow = days % 7
    return (np.stack([days, year, np.floor(month), dow], axis=1),)


@register_impl("datetime_encode", "torch", traceable=True)
def dt_torch(op, ins):
    days = _f32(ins[0]).reshape(-1)
    year = days / 365.25
    month = torch.remainder(days, 365.25) / 30.44
    dow = torch.remainder(days, 7)
    return (torch.stack([days, year, torch.floor(month), dow], dim=1),)


@register_meta("datetime_encode")
def dt_meta(op, ins):
    info = TensorInfo((ins[0].rows, 4), ins[0].dtype)
    return OpMetadata(outputs=[info], flops=6.0 * ins[0].rows,
                      peak_bytes=2 * info.nbytes)


@register_impl("cleaner", "python")
def cleaner_py(op, ins):
    X = _validate(ins[0])
    X[~np.isfinite(X)] = np.nan
    return (X,)


@register_impl("cleaner", "torch", traceable=True)
def cleaner_torch(op, ins):
    X = _f32(ins[0])
    return (torch.where(torch.isfinite(X), X, float("nan")),)


@register_meta("cleaner")
def cleaner_meta(op, ins):
    info = TensorInfo(ins[0].shape, ins[0].dtype)
    return OpMetadata(outputs=[info], flops=2.0 * info.rows * info.cols,
                      peak_bytes=2 * info.nbytes)


# ---------------------------------------------------------------------------
# SVD reduction (exact + Frequent-Directions approx for stage=explore)
# ---------------------------------------------------------------------------

@register_impl("svd_reduce", "python")
def svd_py(op, ins):
    X = _validate(ins[0])
    k = op.spec["k"]
    U, s, _ = np.linalg.svd(X, full_matrices=False)
    return (U[:, :k] * s[:k],)


def _svd_torch(X, k: int):
    _linalg_ready(X)
    U, s, _ = torch.linalg.svd(X, full_matrices=False)
    return U[:, :k] * s[:k]


@register_impl("svd_reduce", "torch", traceable=True)
def svd_torch(op, ins):
    return (_svd_torch(_f32(ins[0]), op.spec["k"]),)


@register_impl("svd_reduce", "torch", fidelity="approx", traceable=True)
def svd_fd_torch(op, ins):
    """Frequent-Directions sketch (paper cites Huang'19) — approximate,
    selectable under stage=explore."""
    X = _f32(ins[0])
    _linalg_ready(X)
    k = op.spec["k"]
    ell = min(2 * k, X.shape[1])
    sketch = torch.zeros((ell, X.shape[1]), dtype=torch.float32,
                         device=X.device)
    chunk = max(ell, 4096)
    for start in range(0, X.shape[0], chunk):
        blk = torch.cat([sketch, X[start:start + chunk]], dim=0)
        _, s, Vt = torch.linalg.svd(blk, full_matrices=False)
        s2 = torch.clamp(s[:ell] ** 2 - s[ell - 1] ** 2, min=0.0) ** 0.5
        sketch = s2[:, None] * Vt[:ell]
    # project X on sketch's top-k right singular vectors
    _, _, Vt = torch.linalg.svd(sketch, full_matrices=False)
    return (X @ Vt[:k].T,)


@register_meta("svd_reduce")
def svd_meta(op, ins):
    info = TensorInfo((ins[0].rows, op.spec["k"]), F32)
    n, d = ins[0].rows, ins[0].cols
    return OpMetadata(outputs=[info], flops=2.0 * n * d * d,
                      peak_bytes=3 * ins[0].nbytes)


# ===========================================================================
# splits
# ===========================================================================

def _perm(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


@register_impl("train_test_split", "python")
def tts_py(op, ins):
    X, y = np.asarray(ins[0]), np.asarray(ins[1])
    n = X.shape[0]
    n_test = int(round(n * op.spec["test_frac"]))
    p = _perm(n, op.seed or 0)
    te, tr = p[:n_test], p[n_test:]
    return (X[tr].copy(), y[tr].copy(), X[te].copy(), y[te].copy())


@register_impl("kfold_split", "python")
def kfold_py(op, ins):
    X, y = np.asarray(ins[0]), np.asarray(ins[1])
    n = X.shape[0]
    k, fold = op.spec["k"], op.spec["fold"]
    fold_size = n // k                       # equal folds → static shapes
    p = _perm(n, op.seed or 0)
    te = p[fold * fold_size:(fold + 1) * fold_size]
    tr = np.concatenate([p[:fold * fold_size],
                         p[(fold + 1) * fold_size:]])
    return (X[tr].copy(), y[tr].copy(), X[te].copy(), y[te].copy())


@register_meta("train_test_split")
def tts_meta(op, ins):
    n = ins[0].rows
    n_test = int(round(n * op.spec["test_frac"]))
    n_train = n - n_test
    outs = [TensorInfo((n_train, ins[0].cols), ins[0].dtype),
            TensorInfo((n_train,), ins[1].dtype),
            TensorInfo((n_test, ins[0].cols), ins[0].dtype),
            TensorInfo((n_test,), ins[1].dtype)]
    return OpMetadata(outputs=outs, flops=float(n),
                      peak_bytes=2 * (ins[0].nbytes + ins[1].nbytes))


@register_meta("kfold_split")
def kfold_meta(op, ins):
    n = ins[0].rows
    fold_size = n // op.spec["k"]
    n_train = n - fold_size
    outs = [TensorInfo((n_train, ins[0].cols), ins[0].dtype),
            TensorInfo((n_train,), ins[1].dtype),
            TensorInfo((fold_size, ins[0].cols), ins[0].dtype),
            TensorInfo((fold_size,), ins[1].dtype)]
    return OpMetadata(outputs=outs, flops=float(n),
                      peak_bytes=2 * (ins[0].nbytes + ins[1].nbytes))


# ===========================================================================
# estimators
# ===========================================================================

@register_impl("ridge_fit", "python")
def ridge_py(op, ins):
    X, y = _validate(ins[0]), np.asarray(ins[1], dtype=np.float64).ravel()
    alpha = op.spec["alpha"]
    Xb = np.hstack([X, np.ones((X.shape[0], 1))])   # bias column copy
    XtX = Xb.T @ Xb                                  # temporary
    XtX += alpha * np.eye(Xb.shape[1])
    Xty = Xb.T @ y
    w = np.linalg.solve(XtX, Xty)
    return (w,)


def _linalg_ready(X: torch.Tensor) -> None:
    """The CUDA linear-algebra backend loaded for ``X``'s device
    (``core.runtime.linalg_ready``) before an impl's first ``torch.linalg``
    call.  Under a compiled segment's fake trace nothing runs (the
    compiled-segment backend makes the real call before the program's first
    call on a device)."""
    if not is_fake(X):
        linalg_ready(X.device)


def _ridge_normal(X, y):
    """(XbᵀXb, Xbᵀy) of the bias-augmented X, in float64.  The float32 X
    and y are widened first: the quickstart's features hold days and
    days / 365.25, so XbᵀXb has entries near 1e12 and a direction whose
    margin is only α; its float32 rounding breaks the Cholesky factor
    (seen on the CPU at 100,000 rows), which the reference's float32 solve
    survives only by its rounding."""
    Xb = torch.cat([X.double(), torch.ones((X.shape[0], 1),
                                           dtype=torch.float64,
                                           device=X.device)], dim=1)
    return Xb.T @ Xb, Xb.T @ y.double()


def _ridge_solve(XtX, Xty, alphas):
    """Solve (XtX + α·I) w = Xty for each α of ``alphas`` (a 1-D tensor):
    the reference's ``solve(..., assume_a="pos")`` as a Cholesky factor and
    its solve, batched over the alphas.  Returns float32 (len(alphas), d)."""
    _linalg_ready(XtX)
    eye = torch.eye(XtX.shape[0], dtype=XtX.dtype, device=XtX.device)
    A = XtX[None] + alphas.to(XtX.dtype)[:, None, None] * eye
    L = torch.linalg.cholesky(A)
    rhs = Xty[None, :, None].expand(len(alphas), -1, 1)
    return torch.cholesky_solve(rhs, L)[..., 0].float()


@register_impl("ridge_fit", "torch", vmappable=True, traceable=True)
def ridge_torch(op, ins):
    X, y = _f32(ins[0]), _f32(ins[1]).reshape(-1)
    alpha = _tunable(op.spec["alpha"], X.dtype, X.device).reshape(1)
    return (_ridge_solve(*_ridge_normal(X, y), alpha)[0],)


@register_meta("ridge_fit")
def ridge_meta(op, ins):
    n, d = ins[0].rows, ins[0].cols + 1
    info = TensorInfo((d,), F64)
    return OpMetadata(outputs=[info], flops=2.0 * n * d * d + d ** 3 / 3,
                      peak_bytes=2 * ins[0].nbytes + 8 * d * d)


@register_impl("elasticnet_fit", "python")
def enet_py(op, ins):
    """Cyclic coordinate descent, interpreted loop per coordinate."""
    X, y = _validate(ins[0]), np.asarray(ins[1], dtype=np.float64).ravel()
    alpha, l1r = op.spec["alpha"], op.spec["l1_ratio"]
    iters = op.spec.get("iters", 200)
    n, d = X.shape
    mu, sd = X.mean(0), X.std(0)
    sd[sd == 0] = 1
    Xs = (X - mu) / sd
    ym = y.mean()
    yc = y - ym
    w = np.zeros(d)
    r = yc.copy()
    l1 = alpha * l1r * n
    l2 = alpha * (1 - l1r) * n
    col_sq = (Xs ** 2).sum(0)
    for _ in range(iters):
        for j in range(d):                     # interpreted inner loop
            wj = w[j]
            rho = Xs[:, j] @ r + wj * col_sq[j]
            w[j] = np.sign(rho) * max(abs(rho) - l1, 0) / (col_sq[j] + l2)
            if w[j] != wj:
                r -= Xs[:, j] * (w[j] - wj)
    w_out = np.concatenate([w / sd, [ym - (mu / sd) @ w]])
    return (w_out,)


@torch.library.custom_op("repro_torch::enet_fista", mutates_args=())
def _enet_fista(X: torch.Tensor, y: torch.Tensor, alphas: torch.Tensor,
                l1rs: torch.Tensor, iters: int) -> torch.Tensor:
    """FISTA for the elastic net, for each (α, l1_ratio) pair of the 1-D
    tensors ``alphas`` and ``l1rs`` at once (the reference vmaps one pair):
    a loop of ``iters`` steps (the reference's ``lax.scan``).  Returns
    (len(alphas), d + 1): the weights on X's scale and the bias last.

    One operator (``torch.ops.repro_torch.enet_fista``): a compiled
    segment's trace records it as one node and the compiled program calls
    it, where tracing the python loop would unroll ``iters`` steps into the
    graph (torch has no stable loop primitive that the compiler lowers, as
    XLA lowers ``lax.scan``).  Its fake version gives the shape; its vmap
    rule runs a batch of pairs as one call."""
    n, d = X.shape
    mu, sd = X.mean(0), X.std(0, correction=0)
    sd = torch.where(sd == 0, 1.0, sd)
    Xs = (X - mu) / sd
    ym = y.mean()
    yc = y - ym
    l1 = (alphas * l1rs * n)[:, None]                    # (V, 1)
    l2 = (alphas * (1 - l1rs) * n)[:, None]
    G = Xs.T @ Xs
    _linalg_ready(G)
    L = torch.linalg.matrix_norm(G, ord=2) + l2 + 1e-6   # Lipschitz bound
    Xty = Xs.T @ yc
    V = len(alphas)
    w = torch.zeros((V, d), dtype=X.dtype, device=X.device)
    z = torch.zeros_like(w)
    t = torch.ones((V, 1), dtype=X.dtype, device=X.device)
    for _ in range(iters):
        grad = z @ G - Xty + l2 * z                      # G is symmetric
        u = z - grad / L
        w_new = torch.sign(u) * torch.clamp(torch.abs(u) - l1 / L, min=0)
        t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
        z = w_new + ((t - 1) / t_new) * (w_new - w)
        w, t = w_new, t_new
    bias = ym - w @ (mu / sd)
    return torch.cat([w / sd, bias[:, None]], dim=1)


@_enet_fista.register_fake
def _enet_fista_fake(X, y, alphas, l1rs, iters):
    return X.new_empty((alphas.shape[0], X.shape[1] + 1))


def _enet_fista_vmap(info, in_dims, X, y, alphas, l1rs, iters):
    """``torch.func.vmap`` of the operator: a batch of (α, l1_ratio)
    columns over one shared (X, y) is one call over all the pairs; a batch
    whose X or y varies runs one call a member."""
    xd, yd, ad, ld, _ = in_dims
    B = info.batch_size

    def lead(t, dim):
        return t.movedim(dim, 0) if dim is not None \
            else t.expand(B, *t.shape)

    a, l1 = lead(alphas, ad), lead(l1rs, ld)
    if xd is None and yd is None:
        out = _enet_fista(X, y, a.reshape(-1), l1.reshape(-1), iters)
        return out.reshape(B, -1, out.shape[-1]), 0
    Xs, ys = lead(X, xd), lead(y, yd)
    return torch.stack([_enet_fista(Xs[i], ys[i], a[i], l1[i], iters)
                        for i in range(B)]), 0


_enet_fista.register_vmap(_enet_fista_vmap)


def _enet_args(ops, X):
    alphas = torch.stack([_tunable(op.spec["alpha"], X.dtype, X.device)
                          for op in ops])
    l1rs = torch.stack([_tunable(op.spec["l1_ratio"], X.dtype, X.device)
                        for op in ops])
    return alphas, l1rs, ops[0].spec.get("iters", 200)


@register_impl("elasticnet_fit", "torch", vmappable=True, traceable=True)
def enet_torch(op, ins):
    X, y = _f32(ins[0]), _f32(ins[1]).reshape(-1)
    return (_enet_fista(X, y, *_enet_args([op], X))[0],)


@register_meta("elasticnet_fit")
def enet_meta(op, ins):
    n, d = ins[0].rows, ins[0].cols
    iters = op.spec.get("iters", 200)
    info = TensorInfo((d + 1,), F64)
    return OpMetadata(outputs=[info], flops=2.0 * iters * n * d,
                      peak_bytes=3 * ins[0].nbytes)


@register_impl("gbt_fit", "python")
def gbt_py(op, ins):
    X, y = np.asarray(ins[0], dtype=np.float64), \
        np.asarray(ins[1], dtype=np.float64).ravel()
    s = op.spec
    return (gbt.fit_numpy(X, y, n_trees=s["n_trees"], depth=s["depth"],
                          lr=s["learning_rate"], reg=s["reg"],
                          subsample=s["subsample"], seed=op.seed or 0),)


@register_impl("gbt_fit", "torch")
def gbt_torch(op, ins):
    X, y = ins[0], ins[1].reshape(-1)
    s = op.spec
    return (gbt.fit_torch(X, y, n_trees=s["n_trees"], depth=s["depth"],
                          lr=s["learning_rate"], reg=s["reg"],
                          subsample=s["subsample"], seed=op.seed or 0),)


@register_meta("gbt_fit")
def gbt_meta(op, ins):
    n, d = ins[0].rows, ins[0].cols
    s = op.spec
    T, depth = s["n_trees"], s["depth"]
    n_nodes, n_leaves = 2 ** depth - 1, 2 ** depth
    size = 6 + d * (gbt.N_BINS - 1) + T * n_nodes * 2 + T * n_leaves
    info = TensorInfo((size,), F64)
    flops = float(T) * depth * n * (d * 2 + 8)
    return OpMetadata(outputs=[info], flops=flops,
                      peak_bytes=int(2.5 * ins[0].nbytes))


@register_impl("linear_predict", "python")
def linpred_py(op, ins):
    w, X = np.asarray(ins[0]), _validate(ins[1])
    return (X @ w[:-1] + w[-1],)


@register_impl("linear_predict", "torch", traceable=True)
def linpred_torch(op, ins):
    w, X = _f32(ins[0]), _f32(ins[1])
    return (X @ w[:-1] + w[-1],)


@register_meta("linear_predict")
def linpred_meta(op, ins):
    info = TensorInfo((ins[1].rows,), F64)
    return OpMetadata(outputs=[info],
                      flops=2.0 * ins[1].rows * ins[1].cols,
                      peak_bytes=ins[1].nbytes)


@register_impl("gbt_predict", "python")
def gbtpred_py(op, ins):
    return (gbt.predict_numpy(np.asarray(ins[0]), np.asarray(ins[1],
                                                             dtype=np.float64)),)


@register_impl("gbt_predict", "torch")
def gbtpred_torch(op, ins):
    return (gbt.predict_torch(ins[0], ins[1]),)


@register_meta("gbt_predict")
def gbtpred_meta(op, ins):
    info = TensorInfo((ins[1].rows,), F64)
    return OpMetadata(outputs=[info], flops=30.0 * ins[1].rows,
                      peak_bytes=2 * ins[1].nbytes)


# ===========================================================================
# metrics & reductions
# ===========================================================================

@register_impl("metric", "python")
def metric_py(op, ins):
    y, yhat = (np.asarray(v, dtype=np.float64).ravel() for v in ins)
    kind = op.spec.get("kind", "rmse")
    if kind == "rmse":
        return (np.sqrt(np.mean((y - yhat) ** 2)),)
    if kind == "mae":
        return (np.mean(np.abs(y - yhat)),)
    if kind == "r2":
        ss = np.sum((y - yhat) ** 2)
        st = np.sum((y - y.mean()) ** 2)
        return (1.0 - ss / st,)
    raise KeyError(kind)


@register_meta("metric")
def metric_meta(op, ins):
    return OpMetadata(outputs=[TensorInfo((), F64)],
                      flops=4.0 * ins[0].rows,
                      peak_bytes=2 * ins[0].nbytes)


@register_impl("mean_scalars", "python")
def mean_scalars_py(op, ins):
    return (float(np.mean([float(np.asarray(v)) for v in ins])),)


@register_meta("mean_scalars")
def mean_scalars_meta(op, ins):
    return OpMetadata(outputs=[TensorInfo((), F64)], flops=len(ins))


@register_impl("best_of", "python")
def best_of_py(op, ins):
    vals = np.array([float(np.asarray(v)) for v in ins])
    if op.spec.get("mode", "min") == "min":
        i = int(np.argmin(vals))
    else:
        i = int(np.argmax(vals))
    return (vals[i], i)


@register_meta("best_of")
def best_of_meta(op, ins):
    return OpMetadata(outputs=[TensorInfo((), F64), TensorInfo((), "int64")],
                      flops=len(ins))


@register_impl("gbt_prefix", "python")
def gbt_prefix_py(op, ins):
    """Extract the k-tree prefix model from a larger fitted GBT pack
    (boosting prefix property — see core.rewrites.gbt_prefix_sharing)."""
    model = np.asarray(ins[0])
    k = op.spec["n_trees"]
    base, bins, feats, thrs, leaves, depth = gbt.unpack(model, 0)
    return (gbt.pack(base, bins, feats[:k], thrs[:k], leaves[:k], depth),)


@register_meta("gbt_prefix")
def gbt_prefix_meta(op, ins):
    info = TensorInfo(ins[0].shape, ins[0].dtype)  # ≤ input size
    return OpMetadata(outputs=[info], flops=float(info.rows),
                      peak_bytes=2 * ins[0].nbytes)


# ===========================================================================
# variant batching registrations (§Perf H3.4): hyperparameter-grid fits that
# share (X, y) execute as one vmapped solve
# ===========================================================================

from ..core.selection import register_vmap_group  # noqa: E402

# tunable hyperparameters: scalar spec fields safe to trace as runtime
# arguments of a compiled segment (never shapes, static loop bounds or
# branch selectors) — excluded from structural signatures, so structurally
# identical hyperparameter variants share one compiled program
declare_tunable("ridge_fit", "alpha")
declare_tunable("elasticnet_fit", "alpha", "l1_ratio")
declare_tunable("clip_outliers", "q")
declare_tunable("target_encode_fit", "smoothing")


def _inputs_key(op):
    return tuple(r.signature for r in op.inputs)


def _ridge_batch(ops, ins):
    """One batched Cholesky solve for the group's alphas (the reference's
    ``jax.vmap`` of the solve over them)."""
    X, y = _f32(ins[0]), _f32(ins[1]).reshape(-1)
    alphas = torch.stack([_tunable(op.spec["alpha"], X.dtype, X.device)
                          for op in ops])
    ws = _ridge_solve(*_ridge_normal(X, y), alphas)
    return [(ws[i],) for i in range(len(ops))]


register_vmap_group("ridge_fit", _inputs_key, _ridge_batch)


def _enet_key(op):
    return (_inputs_key(op), op.spec.get("iters", 200))


def _enet_batch(ops, ins):
    """One batched FISTA run for the group's (alpha, l1_ratio) pairs (the
    reference's ``jax.vmap`` over them)."""
    X, y = _f32(ins[0]), _f32(ins[1]).reshape(-1)
    ws = _enet_fista(X, y, *_enet_args(ops, X))
    return [(ws[i],) for i in range(len(ops))]


register_vmap_group("elasticnet_fit", _enet_key, _enet_batch)
