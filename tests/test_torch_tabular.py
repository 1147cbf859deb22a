"""The tabular operator library of the port against ``repro.tabular``.

* the synthetic table and its on-disk lake equal the reference's bit for
  bit;
* every ``"python"`` impl equals the reference's bit for bit on the same
  inputs;
* every ``"torch"`` impl matches the reference's ``"jax"`` impl within the
  tolerances of ``tests/test_tabular.py`` (2e-3 / 2e-3; ridge predictions
  0.05; GBT predictions 1e-3 / 1e-2), and the GBT picks the same features
  and thresholds;
* the device binning equals numpy's quantiles and ``searchsorted`` bit for
  bit, the exact segment sum equals a float64 ``bincount`` rounded to
  float32, and two GBT fits are equal bit for bit;
* the variant groups (one batched solve for a wave's ridge or elastic-net
  fits) match the reference's ``jax.vmap``.

Inputs are made from seeds with numpy; the torch tier runs on the CPU.
"""

import numpy as np
import pytest
import torch

import repro.tabular  # noqa: F401  (registers the reference's impls)
import repro_torch.tabular  # noqa: F401  (registers the port's impls)
from repro.core.dag import LazyOp as JLazyOp
from repro.core.selection import impls_for as j_impls_for
from repro.core.selection import vmap_group_for as j_vmap_group_for
from repro.data import tabular as j_data
from repro.tabular import gbt as j_gbt
from repro_torch.core.dag import LazyOp, TRANSFORM
from repro_torch.core.selection import _REGISTRY
from repro_torch.core.selection import impls_for
from repro_torch.core.selection import vmap_group_for
from repro_torch.data import tabular as t_data
from repro_torch.tabular import gbt as t_gbt

TOL = dict(atol=2e-3, rtol=2e-3)          # tests/test_tabular.py's tiers


def _table(n=400, seed=0):
    return np.asarray(j_data.generate_uk_housing(n, seed=seed))


def _impl(impls, backend, fidelity="exact"):
    for i in impls:
        if i.backend == backend and i.fidelity == fidelity:
            return i
    raise KeyError(backend)


def _ops(name, spec, seed, n_inputs=0):
    return (JLazyOp(name, TRANSFORM, spec=spec, seed=seed),
            LazyOp(name, TRANSFORM, spec=spec, seed=seed))


def _tensors(inputs):
    """The torch tier's view of host inputs: tensors, float64 as float32
    (the runtime's move for a traceable impl)."""
    out = []
    for x in inputs:
        a = np.asarray(x)
        out.append(torch.from_numpy(
            a.astype(np.float32) if a.dtype == np.float64 else a.copy()))
    return out


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# the data generator and the lake
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(1, 0), (777, 0), (5000, 3)])
def test_generator_and_lake_equal_reference_bit_for_bit(n, seed, tmp_path,
                                                        monkeypatch):
    a = j_data.generate_uk_housing(n, seed)
    b = t_data.generate_uk_housing(n, seed)
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)
    assert not b.flags.writeable
    assert t_data.schema_dict() == j_data.schema_dict()
    assert t_data.feature_target_indices() == j_data.feature_target_indices()
    monkeypatch.setattr(j_data, "_LAKE", str(tmp_path / "ref"))
    monkeypatch.setattr(t_data, "_LAKE", str(tmp_path / "port"))
    for load in ("load_csv", "load_binary"):
        want = getattr(j_data, load)("uk_housing", n, seed)
        got = getattr(t_data, load)("uk_housing", n, seed)
        assert np.array_equal(np.atleast_2d(want), np.atleast_2d(got),
                              equal_nan=True), load
    for ref, port in zip(j_data.ensure_files("uk_housing", n, seed),
                         t_data.ensure_files("uk_housing", n, seed)):
        assert open(ref, "rb").read() == open(port, "rb").read()


# ---------------------------------------------------------------------------
# the python tier: bit for bit
# ---------------------------------------------------------------------------

def _gbt_model(X, y):
    return j_gbt.fit_numpy(X, y, n_trees=4, depth=3, seed=0)


def _python_cases():
    X = _table(300)
    Xn = np.nan_to_num(X)
    y = X[:, 0]
    feats = Xn[:, 10:14]
    stats = np.stack([feats.mean(0), feats.std(0) + 1e-9])
    w = np.linspace(-1, 1, 5)
    model = _gbt_model(feats, y)
    gbt_spec = {"n_trees": 4, "depth": 3, "learning_rate": 0.1, "reg": 1.0,
                "subsample": 0.8}
    return {
        "read": ({"dataset": "uk_housing", "n_rows": 50, "seed": 1}, []),
        "project": ({"cols": (1, 3, 5)}, [X]),
        "concat": ({}, [X[:, :3], X[:, 5]]),
        "join": ({"left_key": 5, "right_key": 0},
                 [X[:, 2:8], np.stack([np.arange(1100.0),
                                       np.arange(1100.0) * 2], 1)]),
        "log1p": ({}, [X]),
        "clip_outliers": ({"q": 0.05}, [X]),
        "impute_fit": ({"strategy": "median"}, [X[:, 10:14]]),
        "impute_apply": ({}, [np.arange(4.0), X[:, 10:14]]),
        "scaler_fit": ({}, [X[:, 10:14]]),
        "scaler_apply": ({}, [stats, feats]),
        "onehot": ({"cards": (5, 2)}, [X[:, 2:4]]),
        "string_encode": ({"dim": 8}, [X[:, 5:7]]),
        "target_encode_fit": ({"card": 1100, "smoothing": 20.0},
                              [X[:, 5:6], y]),
        "target_encode_apply": ({"card": 4}, [np.arange(4.0),
                                              X[:, 4:5]]),
        "datetime_encode": ({}, [X[:, 1:2]]),
        "cleaner": ({}, [np.where(np.isnan(X), np.inf, X)]),
        "svd_reduce": ({"k": 3}, [feats]),
        "train_test_split": ({"test_frac": 0.25}, [X, y]),
        "kfold_split": ({"k": 3, "fold": 1}, [X, y]),
        "ridge_fit": ({"alpha": 0.5}, [feats, y]),
        "elasticnet_fit": ({"alpha": 0.01, "l1_ratio": 0.5, "iters": 5},
                           [feats, y]),
        "gbt_fit": (gbt_spec, [feats, y]),
        "linear_predict": ({}, [w, feats]),
        "gbt_predict": ({}, [model, feats]),
        "metric": ({"kind": "r2"}, [y, y * 0.9]),
        "mean_scalars": ({}, [1.0, np.float64(2.5), 4.0]),
        "best_of": ({"mode": "max"}, [1.0, 3.0, 2.0]),
        "gbt_prefix": ({"n_trees": 2}, [model]),
    }


PYTHON_CASES = _python_cases()


def test_python_cases_cover_every_python_impl():
    python_ops = {name for name, impls in _REGISTRY.items()
                  if any(i.backend == "python" for i in impls)}
    assert python_ops == set(PYTHON_CASES)


@pytest.mark.parametrize("name", sorted(PYTHON_CASES))
def test_python_impl_equals_reference_bit_for_bit(name, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(j_data, "_LAKE", str(tmp_path))
    monkeypatch.setattr(t_data, "_LAKE", str(tmp_path))
    spec, inputs = PYTHON_CASES[name]
    jop, top = _ops(name, spec, seed=11)
    want = _impl(j_impls_for(name), "python").fn(jop, list(inputs))
    got = _impl(impls_for(name), "python").fn(top, list(inputs))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert type(a) is type(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


# ---------------------------------------------------------------------------
# the torch tier against the reference's jax tier
# ---------------------------------------------------------------------------

def _run_tiers(name, spec, inputs, seed=None, fidelity="exact"):
    jop, top = _ops(name, spec, seed)
    jx = _impl(j_impls_for(name), "jax", fidelity).fn(jop, list(inputs))
    impl = _impl(impls_for(name), "torch", fidelity)
    ins = (_tensors(inputs) if impl.traceable
           else [torch.from_numpy(np.array(x)) for x in inputs])
    tt = impl.fn(top, ins)
    assert len(jx) == len(tt)
    return [np.asarray(a, np.float64) for a in jx], \
        [np.asarray(_np(b), np.float64) for b in tt], tt


@pytest.mark.parametrize("name,spec,make_inputs", [
    ("project", {"cols": (1, 3, 5)}, lambda X: [X]),
    ("concat", {}, lambda X: [X[:, :3], X[:, 5]]),
    ("cleaner", {}, lambda X: [X]),
    ("log1p", {}, lambda X: [np.abs(np.nan_to_num(X))]),
    ("clip_outliers", {"q": 0.05}, lambda X: [X[:, 10:14]]),
    ("impute_fit", {"strategy": "mean"}, lambda X: [X[:, 10:14]]),
    ("impute_apply", {}, lambda X: [np.arange(4.0), X[:, 10:14]]),
    ("scaler_fit", {}, lambda X: [np.nan_to_num(X[:, 10:14])]),
    ("scaler_fit", {}, lambda X: [X[:, 10:14]]),        # NaNs ignored
    ("scaler_apply", {}, lambda X: [
        np.stack([np.nan_to_num(X[:, 10:14]).mean(0),
                  np.nan_to_num(X[:, 10:14]).std(0) + 1e-9]),
        np.nan_to_num(X[:, 10:14])]),
    ("datetime_encode", {}, lambda X: [X[:, 1:2]]),
    ("onehot", {"cards": (5, 2)}, lambda X: [X[:, 2:4]]),
    ("string_encode", {"dim": 8}, lambda X: [X[:, 5:7]]),
    ("target_encode_apply", {"card": 4},
     lambda X: [np.arange(4.0), X[:, 4:5]]),
    ("linear_predict", {}, lambda X: [np.linspace(-1, 1, 5),
                                      np.nan_to_num(X[:, 10:14])]),
    ("read", {"dataset": "uk_housing", "n_rows": 64, "seed": 2},
     lambda X: []),
])
def test_tier_equivalence(name, spec, make_inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(j_data, "_LAKE", str(tmp_path))
    monkeypatch.setattr(t_data, "_LAKE", str(tmp_path))
    want, got, raw = _run_tiers(name, spec, make_inputs(_table()), seed=0)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, equal_nan=True, **TOL)
    if name == "read":                        # host numpy, as the reference
        assert isinstance(raw[0], np.ndarray)
    else:
        assert all(isinstance(v, torch.Tensor) for v in raw)


def test_target_encode_tiers():
    """As tests/test_tabular.py holds the python tier to the jax tier:
    rtol 2e-3, atol 0.2 on the encoded table."""
    X = _table()
    want, got, _ = _run_tiers("target_encode_fit",
                              {"card": 1100, "smoothing": 20.0},
                              [X[:, 5:6], X[:, 0]], seed=0)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-1)


def _align_signs(a, b):
    """SVD columns are defined up to sign: flip b's columns onto a's."""
    s = np.sign(np.sum(a * b, axis=0))
    return b * np.where(s == 0, 1, s)


@pytest.mark.parametrize("fidelity", ["exact", "approx"])
def test_svd_reduce_tiers(fidelity):
    """Projections onto the top singular directions agree within 2e-3 /
    2e-3 of the largest value, once each column's sign is aligned."""
    X = np.nan_to_num(_table(300)[:, 10:14])
    X = (X - X.mean(0)) / X.std(0)
    want, got, _ = _run_tiers("svd_reduce", {"k": 2}, [X], seed=0,
                              fidelity=fidelity)
    np.testing.assert_allclose(_align_signs(want[0], got[0]), want[0],
                               rtol=2e-3, atol=2e-3 * np.abs(want[0]).max())


def test_ridge_tiers_and_quality():
    """tests/test_tabular.py's check: the float32 solves differ in weights,
    the predictions agree within 0.05 / 0.05."""
    X = np.nan_to_num(_table(1000)[:, 1:])
    y = np.log1p(_table(1000)[:, 0])
    want, got, _ = _run_tiers("ridge_fit", {"alpha": 1.0}, [X, y], seed=0)
    pred_jx = X @ want[0][:-1] + want[0][-1]
    pred_t = X @ got[0][:-1] + got[0][-1]
    np.testing.assert_allclose(pred_t, pred_jx, rtol=0.05, atol=0.05)
    ss_res = np.sum((y - pred_t) ** 2)
    assert 1 - ss_res / np.sum((y - y.mean()) ** 2) > 0.3


def test_elasticnet_tiers_agree():
    """The FISTA loop matches the reference's lax.scan within 2e-3 / 2e-3
    (weights) and fits the planted sparse model."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 8))
    w_true = np.array([2.0, -1.0, 0, 0, 0.5, 0, 0, 0])
    y = X @ w_true + 0.01 * rng.normal(size=300)
    want, got, _ = _run_tiers(
        "elasticnet_fit", {"alpha": 0.001, "l1_ratio": 0.5, "iters": 300},
        [X, y], seed=0)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    pred = X @ got[0][:-1] + got[0][-1]
    assert np.mean((pred - y) ** 2) < 0.01


def _gbt_data():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) * 2 + (X[:, 1] > 0) * 3
         + 0.01 * rng.normal(size=500)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("subsample", [1.0, 0.8])
def test_gbt_tiers_pick_the_same_trees(subsample):
    """fit_torch picks the reference's features and thresholds, its leaves
    within 2e-3 / 2e-3, and gbt_predict agrees within 1e-3 / 1e-2 (the
    reference's numpy-vs-jax bound)."""
    X, y = _gbt_data()
    spec = {"n_trees": 10, "depth": 3, "learning_rate": 0.1, "reg": 1.0,
            "subsample": subsample}
    jop, top = _ops("gbt_fit", spec, seed=5)
    m_jx = _impl(j_impls_for("gbt_fit"), "jax").fn(jop, [X, y])[0]
    m_t = _impl(impls_for("gbt_fit"), "torch").fn(
        top, [torch.from_numpy(X), torch.from_numpy(y)])[0]
    assert m_t.dtype == torch.float64 and m_t.shape == m_jx.shape
    a, b = j_gbt.unpack(m_jx, 6), j_gbt.unpack(m_t.numpy(), 6)
    assert np.array_equal(a[1], b[1], equal_nan=True)        # bins
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    np.testing.assert_allclose(b[4], a[4], **TOL)
    pjop, ptop = _ops("gbt_predict", {}, seed=None)
    p_jx = _impl(j_impls_for("gbt_predict"), "jax").fn(pjop, [m_jx, X])[0]
    p_t = _impl(impls_for("gbt_predict"), "torch").fn(
        ptop, [m_t, torch.from_numpy(X)])[0]
    assert p_t.dtype == torch.float32
    np.testing.assert_allclose(p_t.numpy(), p_jx, rtol=1e-3, atol=1e-2)
    assert np.mean((p_t.numpy() - y) ** 2) < np.var(y) * 0.4


def test_gbt_two_fits_equal_bit_for_bit():
    X, y = _gbt_data()
    args = (torch.from_numpy(X), torch.from_numpy(y))
    m1 = t_gbt.fit_torch(*args, n_trees=6, depth=3)
    m2 = t_gbt.fit_torch(*args, n_trees=6, depth=3)
    assert torch.equal(m1, m2)


@pytest.mark.parametrize("n,nan_rate", [(1, 0.0), (2, 0.0), (97, 0.1),
                                        (1000, 0.3)])
def test_binning_equals_numpy_bit_for_bit(n, nan_rate):
    """make_bins_torch / bin_data_torch reproduce numpy's nanquantile
    (linear) and searchsorted exactly: on continuous columns, on integer
    columns (edges on data values), on a constant and an all-NaN column."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 5)) * 1e3
    X[:, 1] = np.round(X[:, 1] / 300)                # categorical-like
    X[:, 2] = (rng.random(n) < 0.3).astype(float)    # binary
    X[:, 3] = 7.0                                    # constant
    X[rng.random(X.shape) < nan_rate] = np.nan
    X[:, 4] = np.nan                                 # all NaN
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = j_gbt.make_bins(X)
    got = t_gbt.make_bins_torch(torch.from_numpy(X))
    assert np.array_equal(got.numpy(), want, equal_nan=True)
    Xs = X[:, :4]
    got_b = t_gbt.bin_data_torch(torch.from_numpy(Xs), torch.from_numpy(
        want[:4]))
    assert np.array_equal(got_b.numpy(), j_gbt.bin_data(Xs, want[:4]))


def test_segment_sum_is_exact_and_order_free():
    """The fixed-point segment sum equals the float64 sum rounded to
    float32 within one float32 ulp, and is unchanged by permuting the
    adds."""
    rng = np.random.default_rng(7)
    v = (rng.normal(size=20000) * 10.0 ** rng.integers(-3, 6, 20000)) \
        .astype(np.float32)
    ids = rng.integers(0, 37, 20000)
    want = np.bincount(ids, weights=v.astype(np.float64), minlength=37)
    got = t_gbt.segment_sum(torch.from_numpy(v), torch.from_numpy(ids), 37)
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                               rtol=2 ** -23, atol=1e-6)
    perm = rng.permutation(20000)
    again = t_gbt.segment_sum(torch.from_numpy(v[perm]),
                              torch.from_numpy(ids[perm]), 37)
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# variant groups: one batched solve against jax.vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,specs", [
    ("ridge_fit", [{"alpha": a} for a in (0.1, 1.0, 10.0)]),
    ("elasticnet_fit", [{"alpha": a, "l1_ratio": r, "iters": 100}
                        for a, r in ((0.001, 0.5), (0.01, 0.2),
                                     (0.1, 0.9))]),
])
def test_variant_group_matches_jax_vmap(name, specs):
    """The port's batch function for a group equals its per-op impl on
    each member exactly, and the reference's ``jax.vmap`` within the tier
    tolerance (ridge: predictions within 0.05 / 0.05)."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 6))
    y = X @ rng.normal(size=6) + 0.1 * rng.normal(size=400)
    jops = [JLazyOp(name, "estimator", spec=s, seed=0) for s in specs]
    tops = [LazyOp(name, "estimator", spec=s, seed=0) for s in specs]
    want = j_vmap_group_for(name)[1](jops, [X, y])
    got = vmap_group_for(name)[1](tops, _tensors([X, y]))
    single = _impl(impls_for(name), "torch")
    for top, w, g in zip(tops, want, got):
        assert torch.equal(g[0], single.fn(top, _tensors([X, y]))[0])
        w64, g64 = np.asarray(w[0], np.float64), g[0].double().numpy()
        if name == "ridge_fit":
            np.testing.assert_allclose(X @ g64[:-1] + g64[-1],
                                       X @ w64[:-1] + w64[-1],
                                       rtol=0.05, atol=0.05)
        else:
            np.testing.assert_allclose(g64, w64, **TOL)
