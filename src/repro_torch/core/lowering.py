"""Operator lowering (paper §4.2): decompose COMPOSITE operators into
fine-grained operator subgraphs to expand the optimization space.

Examples from the paper that are implemented here via registered rules
(the rules themselves live next to the operator definitions in
``repro_torch.tabular``):

* ``cv_score``          → unrolled per-fold split/fit/predict/metric DAG
                          (instead of re-executing one subgraph k times),
* ``table_vectorizer``  → cleaner + per-column-group encoders + concat,
* ``grid_search``       → one fit/score branch per grid point + argmax.

Lowering runs to a fixpoint (lowered subgraphs may contain composites) and is
followed by a CSE pass — unrolling is what *creates* most sharing (folds share
preprocessing; grid points share everything but the hyperparameter).

Multi-output composites lower through a transient ``tuple`` passthrough op
which is eliminated in the same pass (refs are rewired to the tuple's inputs),
so the final DAG never contains passthrough nodes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from .dag import COMPOSITE, GENERIC, LazyOp, LazyRef, rebuild

# rule: (op, new_inputs) -> list[LazyRef] replacement outputs (len n_outputs)
_LOWERINGS: dict[str, Callable[[LazyOp, tuple], Sequence[LazyRef]]] = {}

_TUPLE = "__tuple__"


def register_lowering(op_name: str):
    def deco(fn):
        _LOWERINGS[op_name] = fn
        return fn
    return deco


def _untuple(ref: LazyRef) -> LazyRef:
    while ref.op.op_name == _TUPLE:
        ref = ref.op.inputs[ref.index]
    return ref


def lower(sinks: Sequence[LazyRef], max_rounds: int = 8) -> list[LazyRef]:
    out = list(sinks)
    for _ in range(max_rounds):
        changed = False

        def replace(op: LazyOp, new_inputs: tuple) -> Optional[LazyOp]:
            nonlocal changed
            wired = tuple(_untuple(r) for r in new_inputs)
            if op.op_class == COMPOSITE and op.op_name in _LOWERINGS:
                outs = [
                    _untuple(r) for r in _LOWERINGS[op.op_name](op, wired)
                ]
                if len(outs) != op.n_outputs:
                    raise ValueError(
                        f"lowering for {op.op_name} produced {len(outs)} "
                        f"outputs, expected {op.n_outputs}")
                changed = True
                if op.n_outputs == 1 and outs[0].index == 0:
                    return outs[0].op
                return LazyOp(_TUPLE, GENERIC, inputs=tuple(outs),
                              n_outputs=len(outs))
            if (wired != new_inputs
                    or len(wired) != len(op.inputs)
                    or any(a.op is not b.op or a.index != b.index
                           for a, b in zip(wired, op.inputs))):
                return op.with_inputs(wired)
            return None

        out = [_untuple(r) for r in rebuild(out, replace)]
        if not changed:
            break
    return out


def is_lowerable(op_name: str) -> bool:
    return op_name in _LOWERINGS
