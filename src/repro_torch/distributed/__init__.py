"""repro_torch.distributed — mesh policy, sharding rules, collectives (the
counterpart of ``repro.distributed``; its ``compat.py``, a jax-version
shim, has none)."""

from .collectives import (Mesh, gather_full, local_shard, spawn,
                          to_placements)
from .context import (ShardingContext, current_context, set_context, shard,
                      use_context)

__all__ = ["ShardingContext", "current_context", "set_context", "shard",
           "use_context", "Mesh", "local_shard", "gather_full", "spawn",
           "to_placements"]
