"""repro_torch.tabular — the ML-pipeline operator library used by agentic
search (the port of ``repro.tabular``).

Pipeline stages as stratum logical operators, each with a "python" tier
(naive NumPy on the host: the Pandas/scikit-learn stand-in, copies + per-op
dispatch) and a "torch" tier (torch on the session's device: the paper's
Rust-kernel analogue, the reference's "jax" tier), plus metadata rules and
composite lowerings (cv_score, table_vectorizer, grid_search).

Importing this package registers all implementations with
repro_torch.core.
"""

from . import impls  # noqa: F401  (registration side effects)
from . import lowerings  # noqa: F401
from .ops import (clip_outliers, concat, cv_score, elasticnet_fit, gbt_fit,
                  grid_search, join, kfold_split, log1p, mean_of, metric,
                  onehot, predict, project, read, ridge_fit, scale,
                  string_encode, table_vectorizer, target_encode,
                  datetime_encode, impute, svd_reduce, train_test_split)

__all__ = [
    "read", "project", "concat", "join", "impute", "scale", "onehot",
    "string_encode", "target_encode", "datetime_encode", "table_vectorizer",
    "svd_reduce", "ridge_fit", "elasticnet_fit", "gbt_fit", "predict",
    "metric", "kfold_split", "train_test_split", "cv_score", "grid_search",
    "mean_of", "log1p", "clip_outliers",
]
