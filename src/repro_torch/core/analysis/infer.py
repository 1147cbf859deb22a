"""Abstract shape/dtype inference — execute the DAG on avals, not arrays.

Reuses the optimizer's per-op metadata rules (``core.metadata._RULES``) as
abstract transfer functions, layered with *consistency checks* registered
per op name that flag input combinations guaranteed to fail at runtime
(out-of-range projections, row-count mismatches feeding a solver, ...).
Ops with no metadata rule but a traceable torch implementation fall back to
running the impl itself on fake tensors (``FakeTensorMode``, the counterpart
of the reference's ``jax.eval_shape``); anything still unknown mirrors the
conservative ``metadata._fallback`` so inference always terminates.

Severity contract: a failed *check* or a raising *rule* is an ``error``
(execution would raise); a failed fake run of a traceable impl is a
``warning`` only — the runtime's probed fallback keeps mis-declared impls
correct by re-routing them to the per-op path, so they are slow, not wrong.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..dag import LazyOp
from ..metadata import _RULES, _fallback, TensorInfo
from ..selection import impls_for
from .report import Finding, SEV_ERROR, SEV_WARNING

# consistency check: (op, input TensorInfos) -> list[str] problem messages
_CHECKS: dict[str, Callable[[LazyOp, Sequence[TensorInfo]], list]] = {}


def register_check(op_name: str):
    """Register a static input-consistency check for a logical op."""
    def deco(fn):
        _CHECKS[op_name] = fn
        return fn
    return deco


def has_check(op_name: str) -> bool:
    return op_name in _CHECKS


def _numel(t: TensorInfo) -> int:
    return int(np.prod(t.shape, dtype=np.int64)) if t.shape else 1


# ---------------------------------------------------------------------------
# checks for the tabular op vocabulary (each mirrors its impl's hard
# requirements — anything flagged here raises when the impl runs)
# ---------------------------------------------------------------------------

@register_check("project")
def _check_project(op, ins):
    cols = ins[0].cols
    bad = [c for c in op.spec.get("cols", ()) if not 0 <= int(c) < cols]
    if bad:
        return [f"column indices {bad} out of range for input with "
                f"{cols} columns"]
    return []


@register_check("concat")
def _check_concat(op, ins):
    rows = {t.rows for t in ins}
    if len(rows) > 1:
        return [f"inputs disagree on row count: {sorted(rows)}"]
    return []


@register_check("join")
def _check_join(op, ins):
    problems = []
    lk = int(op.spec.get("left_key", 0))
    rk = int(op.spec.get("right_key", 0))
    if not 0 <= lk < ins[0].cols:
        problems.append(f"left_key {lk} out of range for {ins[0].cols} "
                        "left columns")
    if not 0 <= rk < ins[1].cols:
        problems.append(f"right_key {rk} out of range for {ins[1].cols} "
                        "right columns")
    return problems


@register_check("onehot")
def _check_onehot(op, ins):
    cards = op.spec.get("cards", ())
    if len(cards) > ins[0].cols:
        return [f"{len(cards)} cardinalities for an input with only "
                f"{ins[0].cols} columns"]
    return []


def _rows_agree(op, ins):
    """X/y pairs: every impl ravels y and pairs it 1:1 with X's rows."""
    if len(ins) < 2:
        return []
    n, y = ins[0].rows, _numel(ins[1])
    if y != n:
        return [f"X has {n} rows but y has {y} elements"]
    return []


for _name in ("ridge_fit", "elasticnet_fit", "gbt_fit", "train_test_split",
              "kfold_split", "target_encode_fit"):
    _CHECKS[_name] = _rows_agree


@register_check("linear_predict")
def _check_linear_predict(op, ins):
    # coef layout: (d weights, 1 intercept) against X of d columns
    coef, d = _numel(ins[0]), ins[1].cols
    if coef != d + 1:
        return [f"coefficient vector has {coef} entries but X has {d} "
                f"columns (expected {d + 1})"]
    return []


@register_check("metric")
def _check_metric(op, ins):
    a, b = _numel(ins[0]), _numel(ins[1])
    if a != b and 1 not in (a, b):
        return [f"y has {a} elements but yhat has {b}"]
    return []


@register_check("scaler_apply")
def _check_scaler_apply(op, ins):
    state_cols, x_cols = ins[0].cols, ins[1].cols
    if len(ins[0].shape) == 2 and state_cols != x_cols and 1 not in (
            state_cols, x_cols):
        return [f"scaler state fitted on {state_cols} columns applied to "
                f"{x_cols}"]
    return []


@register_check("impute_apply")
def _check_impute_apply(op, ins):
    stats, x_cols = _numel(ins[0]), ins[1].cols
    if stats != x_cols and 1 not in (stats, x_cols):
        return [f"impute state fitted on {stats} columns applied to "
                f"{x_cols}"]
    return []


# ---------------------------------------------------------------------------
# inference driver
# ---------------------------------------------------------------------------

def _traceable_impl(op_name: str):
    for impl in impls_for(op_name):
        if impl.backend == "torch" and impl.traceable:
            return impl
    return None


def _eval_shape_outputs(op, ins) -> Optional[list]:
    """Abstractly evaluate a traceable impl on fake tensors, each input in
    the dtype the runtime hands the impl (``runtime.tier_dtype``): shapes
    and dtypes come out, no data is touched."""
    impl = _traceable_impl(op.op_name)
    if impl is None:
        return None
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..runtime import tier_dtype
    with FakeTensorMode():
        fakes = [torch.empty(t.shape, dtype=tier_dtype(t.dtype))
                 for t in ins]
        outs = impl.fn(op, fakes)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return [TensorInfo(tuple(o.shape),
                           str(o.dtype).replace("torch.", ""))
                for o in outs]


def infer_shapes(order: Sequence[LazyOp], *, skip_uids: frozenset =
                 frozenset(), use_eval_shape: bool = True):
    """Walk ``order`` inferring per-op output avals.

    Returns ``(infos, findings)`` where ``infos`` maps op signature ->
    list[TensorInfo].  Ops in ``skip_uids`` (already flagged by wiring
    validation) and their downstream dependents are skipped silently —
    one root cause, one finding.
    """
    findings: list = []
    infos: dict[str, list] = {}
    poisoned: set = set(skip_uids)

    for op in order:
        ins: list = []
        dead = op.uid in poisoned
        for ref in op.inputs:
            if ref.op.uid in poisoned:
                dead = True
                break
            outs = infos.get(ref.op.signature)
            if outs is None or ref.index >= len(outs):
                dead = True
                break
            ins.append(outs[ref.index])
        if dead:
            poisoned.add(op.uid)
            continue

        check = _CHECKS.get(op.op_name)
        if check is not None:
            try:
                problems = check(op, ins)
            except Exception:       # a confused check must never reject
                problems = []
            if problems:
                for msg in problems:
                    findings.append(Finding(
                        "shape-mismatch", SEV_ERROR, msg,
                        op_name=op.op_name, op_uid=op.uid))
                poisoned.add(op.uid)
                continue

        rule = _RULES.get(op.op_name)
        if rule is not None:
            try:
                meta = rule(op, ins)
                if len(meta.outputs) != op.n_outputs:
                    raise ValueError(
                        f"rule produced {len(meta.outputs)} outputs, op "
                        f"declares {op.n_outputs}")
                infos[op.signature] = meta.outputs
            except Exception as e:
                findings.append(Finding(
                    "infer-error", SEV_ERROR,
                    f"shape rule raised {type(e).__name__}: {e}",
                    op_name=op.op_name, op_uid=op.uid))
                poisoned.add(op.uid)
            continue

        if use_eval_shape:
            try:
                outs = _eval_shape_outputs(op, ins)
            except Exception as e:
                # probed fallback keeps mis-declared impls correct at
                # runtime; statically this is a perf smell, not an error
                findings.append(Finding(
                    "untraceable-impl", SEV_WARNING,
                    f"impl declared traceable but its fake run failed "
                    f"({type(e).__name__}: {e}); runtime will demote it "
                    "to the per-op path",
                    op_name=op.op_name, op_uid=op.uid))
                outs = None
            if outs is not None:
                if len(outs) == op.n_outputs:
                    infos[op.signature] = outs
                    continue
                findings.append(Finding(
                    "infer-error", SEV_ERROR,
                    f"traceable impl produced {len(outs)} outputs, op "
                    f"declares {op.n_outputs}",
                    op_name=op.op_name, op_uid=op.uid))
                poisoned.add(op.uid)
                continue

        infos[op.signature] = _fallback(op, ins).outputs

    return infos, findings
