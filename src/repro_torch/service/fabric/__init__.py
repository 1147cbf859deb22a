"""repro_torch.service.fabric — sharded execution fabric (the port of
``repro.service.fabric``: the same ring, envelopes, wire format, router,
failover, rebalancing and telemetry, and the out-of-process shards of
``proc/``; every shard on the fabric's one torch device).

Scales the multi-tenant execution service past a single server: N
:class:`~repro_torch.service.server.StratumService` shards behind a
:class:`ShardRouter` that consistent-hashes the pipeline-signature space,
with a serializable :class:`JobEnvelope`/:class:`ResultEnvelope` submission
boundary (explicit wire codec + :class:`Transport` abstraction), ring-based
rebalancing, crash failover that requeues in-flight envelopes onto ring
successors, and fabric-level telemetry aggregation.  See
``docs/ARCHITECTURE.md`` (fabric section) and ``docs/API.md``.

    from repro_torch.service.fabric import ShardedStratum

    with ShardedStratum(n_shards=4, memory_budget_bytes=2 << 30,
                        device="cpu") as fabric:
        results, report = fabric.session("agent-0").submit(batch).result()
"""

from .envelope import (CancelEnvelope, CodecError, FabricJobReport,
                       JobEnvelope, ResultEnvelope, decode_cancel,
                       decode_job, decode_result, encode_cancel, encode_job,
                       encode_result, routing_key_for)
from .fabric import ShardedStratum, StratumFabric
from .proc import ProcConfig, ProcStratumFabric
from .ring import ConsistentHashRing
from .router import NoShardsError, ShardRouter
from .telemetry import FabricTelemetry
from .transport import LocalTransport, Transport, TransportError

__all__ = [
    "CancelEnvelope", "CodecError", "ConsistentHashRing", "FabricJobReport",
    "FabricTelemetry", "JobEnvelope", "LocalTransport", "NoShardsError",
    "ProcConfig", "ProcStratumFabric", "ResultEnvelope", "ShardRouter",
    "ShardedStratum", "StratumFabric", "Transport", "TransportError",
    "decode_cancel", "decode_job", "decode_result", "encode_cancel",
    "encode_job", "encode_result", "routing_key_for",
]
