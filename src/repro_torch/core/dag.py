"""Lazy operator DAG — stratum's declarative abstraction (paper §4.1).

Every computation in a pipeline is a :class:`LazyOp` node; edges are data
dependencies.  The DAG is control-flow free and lazily evaluated, mirroring
skrub's DataOps.  Nodes carry

* ``op_name``    — logical operator identity ("read", "standard_scaler", ...)
* ``op_class``   — broad category used by the optimizer (SOURCE/TRANSFORM/...)
* ``spec``       — hashable operator specification (hyperparameters)
* ``inputs``     — upstream :class:`LazyRef` handles
* ``seed``       — explicit randomness; ops without a seed that declare
                   themselves non-deterministic are excluded from caching
* ``signature``  — content hash H(input signatures, op_name, spec, seed),
                   cached on the node for O(1) equality (paper §4.3 Reuse).

The signature doubles as the cache key and the CSE equivalence class.

A second, coarser identity — the **structural signature** — hashes the DAG
*shape* modulo payload constants: op names, wiring, output arity and the
non-tunable parts of each spec, but not tunable hyperparameter values,
seeds, or constant payloads (only their shape/dtype).  Two AIDE refinements
that differ only in ``alpha`` share one structural signature, which is the
key the compiled-plan cache (``core/plan_cache.py``) uses to reuse a
whole-segment jitted program across thousands of near-identical agent
plans.  Which spec fields count as *tunable* is declared per op name via
:func:`declare_tunable` (impl modules register theirs next to the physical
implementations); a tunable field's value is hoisted to a runtime argument
of the compiled segment, so excluding it from the hash is sound.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch


def host_array(value: Any) -> np.ndarray:
    """``value`` as a host numpy array; a tensor (a CUDA one too) is
    copied to the host first."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)

# ---------------------------------------------------------------------------
# operator categories (paper §4.2 "operator type" metadata)
# ---------------------------------------------------------------------------

SOURCE = "source"          # data ingestion (read sharing applies)
TRANSFORM = "transform"    # stateless or fitted row/col transforms
PROJECT = "project"        # column selection (pushdown applies)
FILTER = "filter"          # row predicate (pushdown applies)
ESTIMATOR = "estimator"    # fit/predict model ops
EVAL = "eval"              # metrics / scoring
COMPOSITE = "composite"    # lowered by lowering.py (cv, table_vectorizer, ...)
CONST = "const"            # literal payloads (constant folding applies)
GENERIC = "generic"        # black-box UDF — optimizer must preserve as-is

OP_CLASSES = (SOURCE, TRANSFORM, PROJECT, FILTER, ESTIMATOR, EVAL, COMPOSITE,
              CONST, GENERIC)

_uid = itertools.count()

# ---------------------------------------------------------------------------
# tunable spec fields: hyperparameters excluded from the structural signature
# because the compiled-segment backend hoists them to runtime arguments
# ---------------------------------------------------------------------------

_TUNABLE_FIELDS: dict[str, frozenset] = {}


def declare_tunable(op_name: str, *fields: str) -> None:
    """Declare spec ``fields`` of ``op_name`` as tunable scalars: traced as
    arguments by compiled segments and ignored by structural signatures.
    Only declare fields whose value never changes trace *structure* (no
    shapes, no static loop bounds, no branch selectors)."""
    _TUNABLE_FIELDS[op_name] = (_TUNABLE_FIELDS.get(op_name, frozenset())
                                | frozenset(fields))


def tunable_fields(op_name: str) -> frozenset:
    return _TUNABLE_FIELDS.get(op_name, frozenset())


def _hash_payload(value: Any) -> str:
    """Stable content hash for spec payloads and constant data."""
    h = hashlib.blake2b(digest_size=16)

    def feed(v: Any) -> None:
        if isinstance(v, np.ndarray):
            h.update(b"nd")
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, (list, tuple)):
            h.update(b"seq")
            for item in v:
                feed(item)
        elif isinstance(v, Mapping):
            h.update(b"map")
            for k in sorted(v):
                h.update(str(k).encode())
                feed(v[k])
        elif isinstance(v, (str, bytes)):
            h.update(b"s")
            h.update(v.encode() if isinstance(v, str) else v)
        elif isinstance(v, (int, float, bool, complex)) or v is None:
            h.update(repr(v).encode())
        elif isinstance(v, torch.Tensor) or hasattr(v, "tobytes"):
            # numpy arrays, and tensors (hashed by their host bytes, so a
            # tensor and an equal numpy array share a signature)
            h.update(b"arr")
            h.update(host_array(v).tobytes())
        else:
            # Fall back to repr; GENERIC ops should pass identifying specs.
            h.update(repr(v).encode())

    feed(value)
    return h.hexdigest()


def _hash_structural_payload(value: Any) -> str:
    """Like :func:`_hash_payload` but constants collapse to their *type
    skeleton*: arrays hash dtype+shape only, scalars hash their type — the
    payload bits that decide what a compiled program looks like, not what
    it computes on."""
    h = hashlib.blake2b(digest_size=16)

    def feed(v: Any) -> None:
        if isinstance(v, np.ndarray):
            h.update(b"nd")
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
        elif isinstance(v, (list, tuple)):
            h.update(b"seq")
            for item in v:
                feed(item)
        elif isinstance(v, Mapping):
            h.update(b"map")
            for k in sorted(v):
                h.update(str(k).encode())
                feed(v[k])
        elif isinstance(v, (int, float, bool, complex)) or v is None:
            h.update(type(v).__name__.encode())
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            h.update(b"arr")
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
        else:
            h.update(repr(v).encode())

    feed(value)
    return h.hexdigest()


@dataclass(frozen=True)
class LazyRef:
    """A handle to output ``index`` of ``op`` — the DAG's edge type."""

    op: "LazyOp"
    index: int = 0

    @property
    def signature(self) -> str:
        return f"{self.op.signature}:{self.index}"


@dataclass(eq=False)
class LazyOp:
    op_name: str
    op_class: str
    spec: Mapping[str, Any] = field(default_factory=dict)
    inputs: tuple = ()  # tuple[LazyRef, ...]
    seed: Optional[int] = None
    n_outputs: int = 1
    deterministic: bool = True
    annotations: Mapping[str, Any] = field(default_factory=dict)  # §3 co-design
    uid: int = field(default_factory=lambda: next(_uid))
    # filled by the metadata pass (metadata.py)
    meta: Optional[Any] = None
    _signature: Optional[str] = field(default=None, repr=False)
    _structural_signature: Optional[str] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        if self.op_class not in OP_CLASSES:
            raise ValueError(f"unknown op_class {self.op_class!r}")
        for ref in self.inputs:
            if not isinstance(ref, LazyRef):
                raise TypeError(f"inputs must be LazyRef, got {type(ref)!r}")

    # -- content hashing (paper §4.3: hash from input hashes + spec + seed) --
    @property
    def signature(self) -> str:
        if self._signature is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(self.op_name.encode())
            h.update(self.op_class.encode())
            h.update(_hash_payload(self.spec).encode())
            h.update(repr(self.seed).encode())
            if not self.deterministic and self.seed is None:
                # unseeded non-determinism: unique signature → never CSE'd/cached
                h.update(str(self.uid).encode())
            for ref in self.inputs:
                h.update(ref.signature.encode())
            object.__setattr__(self, "_signature", h.hexdigest())
        return self._signature

    @property
    def structural_signature(self) -> str:
        """Hash of the op's *shape*: name, class, arity, wiring and the
        non-tunable spec entries — but not tunable hyperparameter values,
        the seed value, or constant payloads (shape/dtype only).  Two ops
        share a structural signature iff a compiled program traced for one
        (with tunables hoisted to arguments and constants fed as inputs)
        is reusable verbatim for the other."""
        if self._structural_signature is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(self.op_name.encode())
            h.update(self.op_class.encode())
            h.update(str(self.n_outputs).encode())
            tun = tunable_fields(self.op_name)
            if self.op_class == CONST:
                # const payloads reach compiled segments as runtime inputs,
                # never baked constants — only their type skeleton matters
                h.update(_hash_structural_payload(self.spec).encode())
            else:
                pruned = {k: v for k, v in self.spec.items() if k not in tun}
                h.update(_hash_payload(pruned).encode())
                # which tunables are present still shapes the hoisted
                # argument list, so their *names* (not values) are hashed
                h.update(",".join(sorted(tun & set(self.spec))).encode())
            h.update(b"s1" if self.seed is not None else b"s0")
            h.update(b"d1" if self.deterministic else b"d0")
            for ref in self.inputs:
                h.update(ref.op.structural_signature.encode())
                h.update(str(ref.index).encode())
            object.__setattr__(self, "_structural_signature", h.hexdigest())
        return self._structural_signature

    @property
    def cacheable(self) -> bool:
        return self.deterministic or self.seed is not None

    def out(self, index: int = 0) -> LazyRef:
        if not (0 <= index < self.n_outputs):
            raise IndexError(f"{self.op_name} has {self.n_outputs} outputs")
        return LazyRef(self, index)

    def with_inputs(self, inputs: Sequence[LazyRef]) -> "LazyOp":
        """Copy this op with new inputs (used by rewrites)."""
        return LazyOp(
            op_name=self.op_name, op_class=self.op_class, spec=dict(self.spec),
            inputs=tuple(inputs), seed=self.seed, n_outputs=self.n_outputs,
            deterministic=self.deterministic, annotations=dict(self.annotations),
        )

    def __repr__(self) -> str:  # compact for DAG dumps
        ins = ",".join(str(r.op.uid) for r in self.inputs)
        return f"<{self.op_name}#{self.uid}({ins})>"


# ---------------------------------------------------------------------------
# graph utilities
# ---------------------------------------------------------------------------

def toposort(sinks: Iterable[LazyRef]) -> list[LazyOp]:
    """Deterministic topological order of all ops reachable from ``sinks``."""
    order: list[LazyOp] = []
    state: dict[int, int] = {}  # uid -> 0 visiting / 1 done
    stack: list[tuple[LazyOp, bool]] = [(r.op, False) for r in sinks]
    while stack:
        op, processed = stack.pop()
        if processed:
            state[op.uid] = 1
            order.append(op)
            continue
        if op.uid in state:
            if state[op.uid] == 0:
                raise ValueError("cycle detected in pipeline DAG")
            continue
        state[op.uid] = 0
        stack.append((op, True))
        for ref in reversed(op.inputs):
            if ref.op.uid not in state:
                stack.append((ref.op, False))
            elif state[ref.op.uid] == 0:
                raise ValueError("cycle detected in pipeline DAG")
    return order


def consumers(ops: Sequence[LazyOp]) -> dict[int, list[LazyOp]]:
    out: dict[int, list[LazyOp]] = {op.uid: [] for op in ops}
    for op in ops:
        for ref in op.inputs:
            out.setdefault(ref.op.uid, []).append(op)
    return out


def rebuild(sinks: Sequence[LazyRef],
            replace: Callable[[LazyOp, tuple], Optional[LazyOp]]) -> list[LazyRef]:
    """Bottom-up DAG reconstruction.

    ``replace(op, new_inputs)`` returns a replacement op (or None to keep a
    copy with ``new_inputs``).  Node identity is memoized per uid so shared
    subgraphs stay shared.  Returns sinks pointing into the new DAG.
    """
    memo: dict[int, LazyOp] = {}

    for op in toposort(sinks):
        new_inputs = tuple(LazyRef(memo[r.op.uid], r.index) for r in op.inputs)
        new_op = replace(op, new_inputs)
        if new_op is None:
            if (all(a.op is b.op and a.index == b.index
                    for a, b in zip(new_inputs, op.inputs))
                    and len(new_inputs) == len(op.inputs)):
                new_op = op  # untouched — keep identity (and signature cache)
            else:
                new_op = op.with_inputs(new_inputs)
        memo[op.uid] = new_op
    return [LazyRef(memo[r.op.uid], r.index) for r in sinks]


def count_ops(sinks: Sequence[LazyRef]) -> int:
    return len(toposort(sinks))


def structural_signature(sinks: Sequence[LazyRef]) -> str:
    """Structural signature of a whole plan: per-sink structural signatures
    in sink order (each already encodes its subgraph recursively).  Plans
    differing only in payload constants / tunable hyperparameters collide;
    plans differing in topology, op vocabulary or output wiring do not."""
    h = hashlib.blake2b(digest_size=16)
    for ref in sinks:
        h.update(ref.op.structural_signature.encode())
        h.update(str(ref.index).encode())
    return h.hexdigest()


def graphviz(sinks: Sequence[LazyRef]) -> str:
    """Debug dump (dot format)."""
    lines = ["digraph stratum {"]
    for op in toposort(sinks):
        label = f"{op.op_name}\\n{op.op_class}"
        lines.append(f'  n{op.uid} [label="{label}"];')
        for ref in op.inputs:
            lines.append(f"  n{ref.op.uid} -> n{op.uid};")
    lines.append("}")
    return "\n".join(lines)
