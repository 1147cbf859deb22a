"""Composite-operator lowerings (paper §4.2 "Operator Lowering").

* ``cv_score``         → per-fold split/fit/predict/metric subgraphs + mean.
  Cross-validation becomes an *explicit* DAG instead of k re-executions of an
  opaque subgraph; folds share the parent data node, so CSE and the cache see
  through them.
* ``grid_search``      → one cv_score subgraph per grid point + best_of.
  All grid points share fold splits (identical (X, y, k, seed)) — the CSE win
  the paper highlights.
* ``table_vectorizer`` → cleaner + per-column-group encoders + concat, the
  paper's running example (skrub TableVectorizer decomposition).
"""

from __future__ import annotations

from typing import Any, Mapping

from ..core.dag import EVAL, LazyOp, LazyRef, TRANSFORM
from ..core.lowering import register_lowering
from . import ops
from ..data.tabular import CATEGORICAL, DATETIME, NUMERIC

_FIT_BUILDERS = {
    "ridge_fit": lambda x, y, p, seed: ops.ridge_fit(
        x, y, alpha=p.get("alpha", 1.0), seed=seed),
    "elasticnet_fit": lambda x, y, p, seed: ops.elasticnet_fit(
        x, y, alpha=p.get("alpha", 1.0), l1_ratio=p.get("l1_ratio", 0.5),
        iters=p.get("iters", 200), seed=seed),
    "gbt_fit": lambda x, y, p, seed: ops.gbt_fit(
        x, y, flavor=p.get("flavor", "lightgbm"),
        n_trees=p.get("n_trees", 30), depth=p.get("depth", 3),
        learning_rate=p.get("learning_rate", 0.1), reg=p.get("reg", 1.0),
        subsample=p.get("subsample", 1.0), seed=seed),
}


def build_fit(name: str, x: LazyRef, y: LazyRef, params: Mapping[str, Any],
              seed: int) -> LazyRef:
    if name not in _FIT_BUILDERS:
        raise KeyError(f"unknown estimator {name!r}")
    return _FIT_BUILDERS[name](x, y, dict(params), seed)


@register_lowering("cv_score")
def lower_cv(op: LazyOp, inputs: tuple):
    x, y = inputs
    k = op.spec["k"]
    est = dict(op.spec["estimator"])
    name = est.pop("name")
    seed = op.seed or 0
    scores = []
    for fold in range(k):
        xtr, ytr, xte, yte = ops.kfold_split(x, y, k, fold, seed=seed)
        model = build_fit(name, xtr, ytr, est, seed)
        yhat = ops.predict(model, xte)
        scores.append(ops.metric(yte, yhat, kind="rmse"))
    return [ops.mean_of(scores)]


@register_lowering("grid_search")
def lower_grid(op: LazyOp, inputs: tuple):
    x, y = inputs
    k = op.spec["k"]
    name = op.spec["estimator_name"]
    seed = op.seed or 0
    scores = []
    for params in op.spec["grid"]:
        scores.append(ops.cv_score(x, y, {"name": name, **dict(params)},
                                   k=k, seed=seed))
    best = LazyOp("best_of", EVAL, spec={"mode": "min"},
                  inputs=tuple(scores), n_outputs=2)
    return [best.out(0), best.out(1)]


@register_lowering("table_vectorizer")
def lower_tv(op: LazyOp, inputs: tuple):
    x = inputs[0]
    fit_on = inputs[1] if len(inputs) > 1 else x
    schema = op.spec["schema"]
    cols = op.spec["cols"]
    kinds = schema["kinds"]
    cards = schema["cards"]

    clean = LazyOp("cleaner", TRANSFORM, inputs=(x,)).out()
    clean_fit = clean if fit_on is x else \
        LazyOp("cleaner", TRANSFORM, inputs=(fit_on,)).out()

    num_idx = [i for i, c in enumerate(cols) if kinds[c] == NUMERIC]
    low_card = [i for i, c in enumerate(cols)
                if kinds[c] == CATEGORICAL and cards[c] <= 16]
    high_card = [i for i, c in enumerate(cols)
                 if kinds[c] == CATEGORICAL and cards[c] > 16]
    dt_idx = [i for i, c in enumerate(cols) if kinds[c] == DATETIME]

    # NOTE: `cols` indexes the *original* table; the TV input is already the
    # projected feature block, so positions are relative to `cols`.
    parts = []
    if num_idx:
        xn = ops.project(clean, num_idx)
        fn = ops.project(clean_fit, num_idx)
        imputed = ops.impute(xn, fit_on=fn)
        imputed_fit = ops.impute(fn, fit_on=fn)
        parts.append(ops.scale(imputed, fit_on=imputed_fit))
    if low_card:
        xc = ops.project(clean, low_card)
        parts.append(ops.onehot(
            xc, [cards[cols[i]] for i in low_card]))
    if high_card:
        xh = ops.project(clean, high_card)
        parts.append(ops.string_encode(xh, dim=16, seed=op.seed or 0))
    if dt_idx:
        for i in dt_idx:
            parts.append(ops.datetime_encode(ops.project(clean, [i])))
    if not parts:
        return [clean]
    return [ops.concat(parts)]
