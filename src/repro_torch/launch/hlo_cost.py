"""The counting pass of the dry run (the counterpart of
``repro.launch.hlo_cost``, the reference's loop-aware pass over optimized
HLO).

The port has no HLO: :func:`analyze` runs one call under a
``TorchDispatchMode`` and counts the aten ops it dispatches, usually on
fake tensors (``FakeTensorMode``), where nothing is computed.  The
reference multiplies each scanned body by its trip count; the port's layer
stacks, microbatch loops, attention blocks and recurrences are Python
loops, so every iteration dispatches its own ops and is counted as it
runs.  It emits:

* ``flops`` — 2·M·N·K for each matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; an einsum or a matmul reaches the mode as one of these,
  and ``mv`` and ``dot`` as their vector cases), forward and backward: the
  reference's rule, dots only;
* ``bytes`` — each aten op's tensor inputs plus outputs, views,
  allocations and meta tensors excluded.  The port runs op by op with no
  fusion, so this is the eager upper bound, the counterpart of the
  reference's ``bytes_hlo_dot_model`` bracket;
* ``collective_by_kind`` / ``collective_count_by_kind`` — what
  ``distributed.collectives`` sent during the call (its counters);
* ``peak_live_bytes`` — the most bytes held at once by storages the call
  allocated (each freed when its last holder, a tensor or autograd's saved
  state, lets go).
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..distributed import collectives

aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default

# allocation and aliasing ops: no element is read or written
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.detach.default,
               aten.alias.default, aten.lift_fresh.default,
               aten._local_scalar_dense.default}


def _dot_flops(func, args) -> float:
    """2·M·N·K of a matrix product, 0 for any other op."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if packet is aten.mm else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = (args[0], args[1]) if packet is aten.bmm else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet is aten.mv:
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    if packet is aten.dot:
        return 2.0 * args[0].shape[0]
    return 0.0


def _tensors(x, out: list) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments or
    results), meta tensors left out: shapes only, such as ``param_specs``
    (no memory, no traffic).  A fake tensor's device is read from its
    attribute: ``.device`` is an op of its own (prim.device) under the
    modes."""
    if isinstance(x, torch.Tensor):
        dev = getattr(x, "fake_device", None) or x.device
        if dev.type != "meta":
            out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_by_kind: dict = field(default_factory=dict)
    collective_count_by_kind: dict = field(default_factory=dict)
    peak_live_bytes: int = 0
    n_ops: int = 0
    wall_s: float = 0.0
    out: Any = None                  # what the call returned

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collective_by_kind.values()))


class _Count(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.live = 0
        self.refs: dict[int, weakref.ref] = {}
        self.moves: dict = {}          # op -> whether it reads or writes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE:                # a fake tensor's ``.device``
            dev = getattr(args[0], "fake_device", None)
            if dev is not None:
                return dev
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        cost = self.cost
        cost.n_ops += 1
        cost.flops += _dot_flops(func, args)
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        moves = self.moves.get(func)
        if moves is None:
            moves = self.moves[func] = not (func.is_view or
                                            func in _NO_TRAFFIC)
        if moves:
            cost.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        held = None
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self.refs:
                continue
            if held is None:
                held = {id(i.untyped_storage()) for i in ins}
            if key not in held:     # not a view or an in-place result
                self._track(st, key)
        return out

    def _track(self, st, key: int) -> None:
        n = st.nbytes()
        self.refs[key] = weakref.ref(st, lambda _, k=key, n=n:
                                     self._drop(k, n))
        self.live += n
        if self.live > self.cost.peak_live_bytes:
            self.cost.peak_live_bytes = self.live

    def _drop(self, key: int, n: int) -> None:
        self.live -= n
        self.refs.pop(key, None)


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once under the counting mode; its return
    value is ``.out``.  Give it fake tensors (``FakeTensorMode``) to count
    a step of any size without computing it; every kernel wrapper then
    takes its plain version (the fake tensors' device is the CPU)."""
    cost = OpCost()
    sent = dict(collectives.COLLECTIVE_BYTES)
    calls = dict(collectives.COLLECTIVE_COUNTS)
    t0 = time.perf_counter()
    with _Count(cost):
        cost.out = fn(*args, **kwargs)
    cost.wall_s = time.perf_counter() - t0
    for kind, n in collectives.COLLECTIVE_COUNTS.items():
        if n > calls[kind]:
            cost.collective_count_by_kind[kind] = n - calls[kind]
            cost.collective_by_kind[kind] = \
                collectives.COLLECTIVE_BYTES[kind] - sent[kind]
    return cost


def tree_bytes(tree, shared_with=None) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``; with
    ``shared_with``, of those it shares with that tree only."""
    held = None if shared_with is None else \
        {id(t.untyped_storage()) for t in _tensors(shared_with, [])}
    seen = {}
    for t in _tensors(tree, []):
        st = t.untyped_storage()
        if held is None or id(st) in held:
            seen[id(st)] = st.nbytes()
    return int(sum(seen.values()))


__all__ = ["OpCost", "analyze", "tree_bytes"]
