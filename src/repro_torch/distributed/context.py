"""Activation-sharding context (the counterpart of
``repro.distributed.context``).

Model code is written once; with a :class:`ShardingContext` active (set by
the launcher, the train step or a test), the layers read it to run their
per-rank regions: the tensor-parallel attention and MLP, the
sequence-sharded decode, vocab-parallel embedding and loss, and the MoE
layer's expert- and data-parallel branches.  With no context everything
runs on one device.

``shard(x, name)`` is the JAX package's layout hint
(``with_sharding_constraint``), which never changes a value; here it is a
no-op kept for the same call sites.  ``param_specs`` is the port's
addition: the spec tree of the parameters the model reads, so that a layer
can gather, just before it uses one, a parameter dim the policy shards but
the layer does not compute sharded.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

_state = threading.local()


@dataclass
class ShardingContext:
    mesh: object                   # collectives.Mesh (or any .shape holder)
    rules: dict                    # logical name -> PartitionSpec
    ep_axis: Optional[str] = None  # expert-parallel mesh axis (MoE)
    sp_axis: Optional[str] = None  # sequence-parallel axis (decode KV shards)
    dp_axes: tuple = ()            # batch axes (MoE local dispatch when EP
                                   # is off; the axes gradients sum over)
    param_specs: Optional[dict] = None   # spec tree of the model parameters

    def spec(self, name: str):
        return self.rules.get(name)


def set_context(ctx: Optional[ShardingContext]) -> None:
    _state.ctx = ctx


def current_context() -> Optional[ShardingContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_context(ctx: Optional[ShardingContext]):
    prev = current_context()
    set_context(ctx)
    try:
        yield ctx
    finally:
        set_context(prev)


def shard(x, name: str):
    """Annotate activation ``x`` with the logical sharding ``name``: a
    layout hint, which changes no value (a no-op here)."""
    return x
