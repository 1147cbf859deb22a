"""Metadata collection pass (paper §4.2).

Skrub treats operators as black boxes; stratum's first optimizer pass walks the
DAG and materializes per-operator metadata *inside the operator objects*:

* structural class (source / projection / estimator / ...) — already on the op,
* data characteristics: output shapes, dtypes, row/col counts,
* cost hints: estimated FLOPs, output bytes, and peak working-set bytes,
* backend availability (which physical implementations exist).

Shape/cost inference rules are registered per logical op name; GENERIC ops
without a rule get conservative estimates (propagate input sizes), which is
exactly the paper's "black-box UDF" caveat (§5 challenge 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .dag import CONST, GENERIC, LazyOp, LazyRef, host_array, toposort


@dataclass
class TensorInfo:
    shape: tuple
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize

    @property
    def rows(self) -> int:
        return int(self.shape[0]) if self.shape else 1

    @property
    def cols(self) -> int:
        return int(self.shape[1]) if len(self.shape) > 1 else 1


@dataclass
class OpMetadata:
    outputs: list            # list[TensorInfo], one per op output
    flops: float = 0.0       # estimated compute
    peak_bytes: int = 0      # working-set estimate (inputs + outputs + temps)
    backends: tuple = ()     # physical implementations available (selection.py)
    library: str = "repro"   # provenance hint ("pandas-like", "sklearn-like", ...)
    notes: dict = field(default_factory=dict)

    @property
    def out_bytes(self) -> int:
        return sum(t.nbytes for t in self.outputs)


# rule: (op, input TensorInfos) -> OpMetadata
_RULES: dict[str, Callable[[LazyOp, Sequence[TensorInfo]], OpMetadata]] = {}


def register_meta(op_name: str):
    def deco(fn):
        _RULES[op_name] = fn
        return fn
    return deco


def _fallback(op: LazyOp, ins: Sequence[TensorInfo]) -> OpMetadata:
    if op.op_class == CONST:
        value = op.spec.get("value")
        arr = host_array(value)
        info = TensorInfo(tuple(arr.shape), str(arr.dtype))
        return OpMetadata(outputs=[info], flops=0.0, peak_bytes=info.nbytes)
    if ins:
        # conservative: mirror the largest input per output
        biggest = max(ins, key=lambda t: t.nbytes)
        outs = [TensorInfo(biggest.shape, biggest.dtype)
                for _ in range(op.n_outputs)]
        flops = float(sum(np.prod(t.shape, dtype=np.int64) for t in ins))
        peak = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        return OpMetadata(outputs=outs, flops=flops, peak_bytes=peak)
    outs = [TensorInfo((), "float64") for _ in range(op.n_outputs)]
    return OpMetadata(outputs=outs)


def collect_metadata(sinks: Sequence[LazyRef]) -> list[LazyOp]:
    """Run the metadata pass over the DAG; returns the topo order visited.

    Metadata is materialized on ``op.meta`` (paper: "materializes it within
    the operator objects").  Idempotent: ops with meta already set and
    unchanged inputs are skipped.
    """
    order = toposort(sinks)
    infos: dict[str, list[TensorInfo]] = {}
    for op in order:
        ins: list[TensorInfo] = []
        for ref in op.inputs:
            ins.append(infos[ref.op.signature][ref.index])
        rule = _RULES.get(op.op_name, _fallback)
        meta = rule(op, ins)
        if len(meta.outputs) != op.n_outputs:
            raise ValueError(
                f"meta rule for {op.op_name} returned {len(meta.outputs)} "
                f"outputs, op declares {op.n_outputs}")
        op.meta = meta
        infos[op.signature] = meta.outputs
    return order


def output_info(ref: LazyRef) -> TensorInfo:
    if ref.op.meta is None:
        raise RuntimeError("metadata pass has not run for this DAG")
    return ref.op.meta.outputs[ref.index]


def has_rule(op_name: str) -> bool:
    return op_name in _RULES
