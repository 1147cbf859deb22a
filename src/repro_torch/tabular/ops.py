"""Lazy operator constructors — the skrub-DataOps-style surface that agents
target.  Each function returns a :class:`LazyRef`; nothing executes until a
:class:`Stratum` session runs the batch.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

from ..core.dag import (COMPOSITE, CONST, ESTIMATOR, EVAL, LazyOp, LazyRef,
                        PROJECT, SOURCE, TRANSFORM)

# ---------------------------------------------------------------------------
# sources & structural ops
# ---------------------------------------------------------------------------


def read(dataset: str, n_rows: int, seed: int = 0) -> LazyRef:
    return LazyOp("read", SOURCE,
                  spec={"dataset": dataset, "n_rows": n_rows, "seed": seed}
                  ).out()


def const(value) -> LazyRef:
    return LazyOp("const", CONST, spec={"value": np.asarray(value)}).out()


def project(x: LazyRef, cols: Sequence[int]) -> LazyRef:
    return LazyOp("project", PROJECT,
                  spec={"cols": tuple(int(c) for c in cols)},
                  inputs=(x,)).out()


def concat(xs: Sequence[LazyRef]) -> LazyRef:
    return LazyOp("concat", TRANSFORM, inputs=tuple(xs)).out()


def join(left: LazyRef, right: LazyRef, left_key: int, right_key: int
         ) -> LazyRef:
    return LazyOp("join", TRANSFORM,
                  spec={"left_key": int(left_key), "right_key": int(right_key)},
                  inputs=(left, right)).out()


# ---------------------------------------------------------------------------
# preprocessing — fit/apply pairs (leak-free under unrolled CV)
# ---------------------------------------------------------------------------


def _fit_apply(fit_name: str, apply_name: str, fit_on: LazyRef,
               apply_to: LazyRef, spec: Mapping[str, Any],
               seed: Optional[int] = None,
               extra_fit_inputs: tuple = ()) -> LazyRef:
    state = LazyOp(fit_name, TRANSFORM, spec=dict(spec),
                   inputs=(fit_on,) + extra_fit_inputs, seed=seed).out()
    return LazyOp(apply_name, TRANSFORM, spec=dict(spec),
                  inputs=(state, apply_to)).out()


def impute(x: LazyRef, fit_on: Optional[LazyRef] = None,
           strategy: str = "mean") -> LazyRef:
    return _fit_apply("impute_fit", "impute_apply", fit_on or x, x,
                      {"strategy": strategy})


def scale(x: LazyRef, fit_on: Optional[LazyRef] = None) -> LazyRef:
    return _fit_apply("scaler_fit", "scaler_apply", fit_on or x, x, {})


def onehot(x: LazyRef, cardinalities: Sequence[int]) -> LazyRef:
    return LazyOp("onehot", TRANSFORM,
                  spec={"cards": tuple(int(c) for c in cardinalities)},
                  inputs=(x,)).out()


def string_encode(x: LazyRef, dim: int = 32, seed: int = 0) -> LazyRef:
    """Hashing-based high-cardinality encoder (skrub StringEncoder analogue)."""
    return LazyOp("string_encode", TRANSFORM,
                  spec={"dim": int(dim)}, inputs=(x,), seed=seed).out()


def target_encode(x: LazyRef, y: LazyRef, cardinality: int,
                  fit_on_x: Optional[LazyRef] = None,
                  fit_on_y: Optional[LazyRef] = None,
                  smoothing: float = 20.0, seed: int = 0) -> LazyRef:
    state = LazyOp("target_encode_fit", TRANSFORM,
                   spec={"card": int(cardinality), "smoothing": smoothing},
                   inputs=(fit_on_x or x, fit_on_y or y), seed=seed).out()
    return LazyOp("target_encode_apply", TRANSFORM,
                  spec={"card": int(cardinality)},
                  inputs=(state, x)).out()


def datetime_encode(x: LazyRef) -> LazyRef:
    return LazyOp("datetime_encode", TRANSFORM, inputs=(x,)).out()


def log1p(x: LazyRef) -> LazyRef:
    return LazyOp("log1p", TRANSFORM, inputs=(x,)).out()


def clip_outliers(x: LazyRef, q: float = 0.01) -> LazyRef:
    """Quantile clipping; ``q`` is a tunable constant (declared in
    impls.py), so refinements sweeping it share one compiled segment."""
    return LazyOp("clip_outliers", TRANSFORM, spec={"q": float(q)},
                  inputs=(x,)).out()


def svd_reduce(x: LazyRef, k: int = 16, seed: int = 0) -> LazyRef:
    """Dimensionality reduction; has an 'approx' Frequent-Directions-style
    physical impl selectable under stage=explore annotations (paper §4.2)."""
    return LazyOp("svd_reduce", TRANSFORM, spec={"k": int(k)},
                  inputs=(x,), seed=seed).out()


def table_vectorizer(x: LazyRef, schema: Mapping[str, Any],
                     feature_cols: Sequence[int],
                     fit_on: Optional[LazyRef] = None) -> LazyRef:
    """Composite (paper §4.2 lowering example): cleaner + per-group encoders."""
    spec = {"schema": {k: tuple(v) for k, v in schema.items()},
            "cols": tuple(int(c) for c in feature_cols)}
    inputs = (x,) if fit_on is None else (x, fit_on)
    return LazyOp("table_vectorizer", COMPOSITE, spec=spec,
                  inputs=inputs).out()


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------


def train_test_split(x: LazyRef, y: LazyRef, test_frac: float = 0.2,
                     seed: int = 0) -> tuple:
    op = LazyOp("train_test_split", TRANSFORM,
                spec={"test_frac": float(test_frac)},
                inputs=(x, y), seed=seed, n_outputs=4)
    return op.out(0), op.out(1), op.out(2), op.out(3)  # Xtr, ytr, Xte, yte


def kfold_split(x: LazyRef, y: LazyRef, k: int, fold: int, seed: int = 0
                ) -> tuple:
    op = LazyOp("kfold_split", TRANSFORM,
                spec={"k": int(k), "fold": int(fold)},
                inputs=(x, y), seed=seed, n_outputs=4)
    return op.out(0), op.out(1), op.out(2), op.out(3)


# ---------------------------------------------------------------------------
# estimators & metrics
# ---------------------------------------------------------------------------


def ridge_fit(x: LazyRef, y: LazyRef, alpha: float = 1.0,
              seed: int = 0) -> LazyRef:
    return LazyOp("ridge_fit", ESTIMATOR, spec={"alpha": float(alpha)},
                  inputs=(x, y), seed=seed).out()


def elasticnet_fit(x: LazyRef, y: LazyRef, alpha: float = 1.0,
                   l1_ratio: float = 0.5, iters: int = 200,
                   seed: int = 0) -> LazyRef:
    return LazyOp("elasticnet_fit", ESTIMATOR,
                  spec={"alpha": float(alpha), "l1_ratio": float(l1_ratio),
                        "iters": int(iters)},
                  inputs=(x, y), seed=seed).out()


def gbt_fit(x: LazyRef, y: LazyRef, flavor: str = "lightgbm",
            n_trees: int = 30, depth: int = 3, learning_rate: float = 0.1,
            reg: float = 1.0, subsample: float = 1.0, seed: int = 0
            ) -> LazyRef:
    # flavor ∈ {xgboost, lightgbm}: same algorithm family, different default
    # subsampling — kept as distinct specs so agents can explore both.
    if flavor == "xgboost" and subsample == 1.0:
        subsample = 0.9
    return LazyOp("gbt_fit", ESTIMATOR,
                  spec={"flavor": flavor, "n_trees": int(n_trees),
                        "depth": int(depth),
                        "learning_rate": float(learning_rate),
                        "reg": float(reg), "subsample": float(subsample)},
                  inputs=(x, y), seed=seed).out()


_PREDICT_FOR = {"ridge_fit": "linear_predict",
                "elasticnet_fit": "linear_predict",
                "gbt_fit": "gbt_predict"}


def predict(model: LazyRef, x: LazyRef) -> LazyRef:
    pred_name = _PREDICT_FOR.get(model.op.op_name, "linear_predict")
    return LazyOp(pred_name, ESTIMATOR, inputs=(model, x)).out()


def metric(y: LazyRef, yhat: LazyRef, kind: str = "rmse") -> LazyRef:
    return LazyOp("metric", EVAL, spec={"kind": kind},
                  inputs=(y, yhat)).out()


def mean_of(scores: Sequence[LazyRef]) -> LazyRef:
    return LazyOp("mean_scalars", EVAL, inputs=tuple(scores)).out()


# ---------------------------------------------------------------------------
# composites lowered by lowerings.py
# ---------------------------------------------------------------------------


def cv_score(x: LazyRef, y: LazyRef, estimator: Mapping[str, Any],
             k: int = 5, seed: int = 0) -> LazyRef:
    """estimator: {"name": "ridge_fit", **hyperparams}"""
    return LazyOp("cv_score", COMPOSITE,
                  spec={"estimator": dict(estimator), "k": int(k)},
                  inputs=(x, y), seed=seed).out()


def grid_search(x: LazyRef, y: LazyRef, estimator_name: str,
                grid: Sequence[Mapping[str, Any]], k: int = 5,
                seed: int = 0) -> tuple:
    op = LazyOp("grid_search", COMPOSITE,
                spec={"estimator_name": estimator_name,
                      "grid": tuple({k2: v for k2, v in g.items()}
                                    for g in grid),
                      "k": int(k)},
                inputs=(x, y), seed=seed, n_outputs=2)
    return op.out(0), op.out(1)  # best_score, best_index
