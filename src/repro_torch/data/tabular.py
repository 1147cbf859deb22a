"""Synthetic tabular data lake for the agentic-search workload.

The paper evaluates on the UK housing prices dataset (Kaggle).  The container
has no network/dataset access, so we generate a statistically similar table:
price target with trend + seasonal structure, a mix of low-cardinality
categoricals (property type, tenure), high-cardinality categoricals (town,
district), datetimes, and numerics with missing values.

Tables are plain ``float64`` matrices; the column schema travels with the
read op's spec, mirroring how agent-generated code references columns
explicitly.  NaN encodes missingness.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NUMERIC, CATEGORICAL, DATETIME, TARGET = "numeric", "categorical", "datetime", "target"


@dataclass(frozen=True)
class Column:
    name: str
    kind: str
    cardinality: int = 0  # categoricals only


UK_HOUSING_SCHEMA: tuple[Column, ...] = (
    Column("price", TARGET),
    Column("date", DATETIME),
    Column("property_type", CATEGORICAL, 5),
    Column("old_new", CATEGORICAL, 2),
    Column("duration", CATEGORICAL, 3),
    Column("town", CATEGORICAL, 1100),       # high cardinality
    Column("district", CATEGORICAL, 130),
    Column("county", CATEGORICAL, 68),
    Column("ppd_category", CATEGORICAL, 2),
    Column("record_status", CATEGORICAL, 2),
    Column("floor_area", NUMERIC),
    Column("rooms", NUMERIC),
    Column("lat", NUMERIC),
    Column("lon", NUMERIC),
)


def schema_dict(schema: tuple[Column, ...] = UK_HOUSING_SCHEMA) -> dict:
    """Spec-embeddable (hashable) schema representation."""
    return {
        "names": tuple(c.name for c in schema),
        "kinds": tuple(c.kind for c in schema),
        "cards": tuple(c.cardinality for c in schema),
    }


_MEMO: dict[tuple, np.ndarray] = {}


def generate_uk_housing(n_rows: int, seed: int = 0,
                        missing_rate: float = 0.03) -> np.ndarray:
    """Deterministic synthetic table, (n_rows, len(schema)) float64."""
    key = ("uk_housing", n_rows, seed, missing_rate)
    if key in _MEMO:
        return _MEMO[key]
    rng = np.random.default_rng(seed)
    n = n_rows
    cols: dict[str, np.ndarray] = {}

    cols["date"] = rng.integers(0, 9131, n).astype(np.float64)  # days, ~25y
    cols["property_type"] = rng.choice(5, n, p=[.30, .27, .23, .15, .05]) \
        .astype(np.float64)
    cols["old_new"] = (rng.random(n) < 0.1).astype(np.float64)
    cols["duration"] = rng.choice(3, n, p=[.77, .22, .01]).astype(np.float64)
    # Zipf-ish town distribution (high-cardinality)
    town_p = 1.0 / np.arange(1, 1101) ** 1.1
    town_p /= town_p.sum()
    cols["town"] = rng.choice(1100, n, p=town_p).astype(np.float64)
    cols["district"] = np.floor(cols["town"] / 9.0) + rng.integers(0, 3, n)
    cols["district"] = np.clip(cols["district"], 0, 129)
    cols["county"] = np.clip(np.floor(cols["district"] / 2.0), 0, 67)
    cols["ppd_category"] = (rng.random(n) < 0.12).astype(np.float64)
    cols["record_status"] = (rng.random(n) < 0.02).astype(np.float64)
    cols["floor_area"] = np.maximum(12.0, rng.gamma(6.0, 15.0, n))
    cols["rooms"] = np.clip(np.round(cols["floor_area"] / 25.0
                                     + rng.normal(0, 1, n)), 1, 12)
    cols["lat"] = 50.0 + 9.0 * rng.random(n)
    cols["lon"] = -6.0 + 8.0 * rng.random(n)

    # price: log-normal with structure the models can learn
    town_effect = rng.normal(0, 0.35, 1100)[cols["town"].astype(int)]
    type_effect = np.array([0.0, .18, .35, .62, -.25])[
        cols["property_type"].astype(int)]
    trend = 0.00009 * cols["date"]
    log_price = (11.6 + trend + type_effect + town_effect
                 + 0.004 * cols["floor_area"]
                 + 0.05 * cols["rooms"]
                 - 0.30 * cols["old_new"]
                 + rng.normal(0, 0.25, n))
    cols["price"] = np.exp(log_price)

    X = np.stack([cols[c.name] for c in UK_HOUSING_SCHEMA], axis=1)

    # inject missingness in numerics (not target/date)
    for j, c in enumerate(UK_HOUSING_SCHEMA):
        if c.kind == NUMERIC and missing_rate > 0:
            mask = rng.random(n) < missing_rate
            X[mask, j] = np.nan

    X.setflags(write=False)
    _MEMO[key] = X
    return X


def load(dataset: str, n_rows: int, seed: int = 0) -> np.ndarray:
    if dataset == "uk_housing":
        return generate_uk_housing(n_rows, seed)
    raise KeyError(f"unknown dataset {dataset!r}")


# ---------------------------------------------------------------------------
# on-disk data lake: CSV (what agent scripts pd.read_csv) and a binary
# column store (what a native reader like Polars/Arrow maps) — both real
# files, so the two read tiers measure genuine I/O+parse cost, not a mock.
# ---------------------------------------------------------------------------

import os
import tempfile

_LAKE = os.environ.get("REPRO_DATA_LAKE",
                       os.path.join(tempfile.gettempdir(), "repro_lake"))


def ensure_files(dataset: str, n_rows: int, seed: int = 0) -> tuple:
    """Materialize (csv_path, npy_path) for the dataset once."""
    os.makedirs(_LAKE, exist_ok=True)
    stem = os.path.join(_LAKE, f"{dataset}_{n_rows}_{seed}")
    csv_path, npy_path = stem + ".csv", stem + ".npy"
    if not (os.path.exists(csv_path) and os.path.exists(npy_path)):
        X = np.asarray(load(dataset, n_rows, seed))
        header = ",".join(c.name for c in UK_HOUSING_SCHEMA)
        np.savetxt(csv_path + ".tmp", X, delimiter=",", header=header,
                   comments="")
        os.replace(csv_path + ".tmp", csv_path)
        np.save(npy_path + ".tmp.npy", X)
        os.replace(npy_path + ".tmp.npy", npy_path)
    return csv_path, npy_path


def load_csv(dataset: str, n_rows: int, seed: int = 0) -> np.ndarray:
    """Interpreted-tier read: parse the CSV (pandas-equivalent cost)."""
    csv_path, _ = ensure_files(dataset, n_rows, seed)
    return np.genfromtxt(csv_path, delimiter=",", skip_header=1)


def load_binary(dataset: str, n_rows: int, seed: int = 0) -> np.ndarray:
    """Native-tier read: memory-mapped binary column store (Arrow-like)."""
    _, npy_path = ensure_files(dataset, n_rows, seed)
    return np.load(npy_path)


def column_index(name: str, schema=UK_HOUSING_SCHEMA) -> int:
    for i, c in enumerate(schema):
        if c.name == name:
            return i
    raise KeyError(name)


def feature_target_indices(schema=UK_HOUSING_SCHEMA) -> tuple[tuple, int]:
    feats = tuple(i for i, c in enumerate(schema) if c.kind != TARGET)
    tgt = next(i for i, c in enumerate(schema) if c.kind == TARGET)
    return feats, tgt
