"""The fabric's serializable submission boundary (the port of
``repro.service.fabric.envelope``: the same envelopes, routing keys and
wire format — magic ``STRF``, version 1, the same kind bytes — so the two
packages' frame headers and control frames are one format).

Everything that crosses from a
:class:`~repro_torch.service.session.Session` into the fabric — and back —
is a *message*, not a shared object graph:

* :class:`JobEnvelope` — one submitted :class:`PipelineBatch` plus its
  routing metadata (tenant, priority, routing key, envelope id) and
  submission options (remaining ``deadline_s``, opaque ``tags``);
* :class:`ResultEnvelope` — the terminal reply: either ``results`` (host
  numpy arrays keyed by the batch's sink names) plus a plain-field
  :class:`FabricJobReport`, or a transported error.

The wire codec (``encode_job``/``decode_job``/``encode_result``/
``decode_result``) frames a pickled payload with a magic, a version byte
and a blake2b checksum, and performs two normalizations that make the
boundary a real process-isolation seam rather than an in-process formality:

* **DAG re-identification** — a decoded batch's ops are rebuilt with fresh
  ``uid``s.  Uids are process-local; two envelopes decoded on the same
  shard could otherwise carry colliding uids from different origin
  processes, corrupting uid-keyed passes (consumer maps, schedulers) when
  the shard coalesces them into one super-batch.  Content signatures are
  unaffected (they hash op name/spec/seed/inputs, never uids), so CSE and
  cache keys survive the trip bit-exactly.
* **result hosting** — result values are converted to host ``numpy``
  arrays (a CUDA tensor is copied to the host first), so no device buffer
  ever crosses the boundary and results reach the caller as host numpy
  arrays on every device.

Routing keys: :func:`routing_key_for` digests the batch's signature space.
Policy ``"sources"`` (default) keys on the SOURCE-op signatures — all work
over one dataset lands on one shard, keeping cross-agent CSE and the
shard's intermediate cache effective; ``"batch"`` keys on the full sink
signature set — only identical batches co-locate, spreading load wider.
"""

from __future__ import annotations

import hashlib
import itertools
import pickle
from dataclasses import dataclass, field
from typing import Any, Optional

from ...core.dag import SOURCE, host_array, rebuild, toposort
from ...core.fusion import PipelineBatch

_MAGIC = b"STRF"
_VERSION = 1
_JOB_KIND = 0x01
_RESULT_KIND = 0x02
_CANCEL_KIND = 0x03

ROUTING_POLICIES = ("sources", "batch")


class CodecError(ValueError):
    """Malformed, corrupted or version-incompatible wire frame."""


# ---------------------------------------------------------------------------
# envelopes
# ---------------------------------------------------------------------------

_envelope_counter = itertools.count()


def next_envelope_id(client: str = "local") -> str:
    return f"{client}-{next(_envelope_counter)}"


@dataclass
class JobEnvelope:
    """One batch submission crossing the Session → fabric boundary."""
    envelope_id: str
    tenant: str
    priority: int                 # int value of service.priority.Priority
    routing_key: str
    batch: PipelineBatch
    attempt: int = 0              # bumped by failover requeues
    # deadline SLO: ``deadline_s`` is the REMAINING budget at encode time
    # (absolute clocks don't cross process boundaries); ``deadline_t`` is
    # the client-local absolute instant — it never crosses the wire, the
    # router uses it to re-derive a shrunken deadline_s when a failover
    # re-encodes the envelope
    deadline_s: Optional[float] = None
    deadline_t: Optional[float] = None
    tags: tuple = ()
    # compact lifecycle hop log (observability/trace.py tuples) carried
    # over the wire when tracing is on, so a trace survives failover and
    # the owning shard can seed its JobTrace with the client-side history;
    # () when tracing is off — costs nothing on the hot path
    hops: tuple = ()


@dataclass
class CancelEnvelope:
    """Client-side request to remove a still-queued job from its shard.

    Crossing the wire (rather than only abandoning the local future) is
    what makes cancellation *shard-aware*: the owning shard's fair queue
    drops the job, freeing its admission slot and dispatch capacity.  A
    job already dispatched is not preempted — the shard simply ignores
    the cancel and the ordinary ResultEnvelope resolves the future."""
    envelope_id: str
    tenant: str
    attempt: int = 0              # must match the in-flight attempt


@dataclass
class FabricJobReport:
    """Plain-field, wire-safe per-job report (the sharded analogue of
    :class:`~repro_torch.service.server.JobReport`)."""
    tenant: str
    envelope_id: str
    shard_id: str
    queue_wait_s: float = 0.0
    coalesced_with: int = 0
    ops_shared_cross_agent: int = 0
    cache_hits: int = 0
    ops_salvaged: int = 0
    preemptions: int = 0
    attempt: int = 0
    deadline_s: Optional[float] = None
    deadline_met: Optional[bool] = None
    tags: tuple = ()
    per_backend: dict = field(default_factory=dict)
    # full reassembled lifecycle trace (client hops + shard hops) when the
    # submission was traced; () otherwise
    hops: tuple = ()


@dataclass
class ResultEnvelope:
    """Terminal reply for one :class:`JobEnvelope`."""
    envelope_id: str
    tenant: str
    shard_id: str
    ok: bool
    results: Optional[dict[str, Any]] = None
    report: Optional[FabricJobReport] = None
    error: Optional[BaseException] = None
    attempt: int = 0       # echoes the JobEnvelope attempt this answers


# ---------------------------------------------------------------------------
# routing keys
# ---------------------------------------------------------------------------

def routing_key_for(batch: PipelineBatch, policy: str = "sources") -> str:
    """Digest of the batch's signature space, per routing policy."""
    if policy not in ROUTING_POLICIES:
        raise ValueError(f"unknown routing policy {policy!r}; "
                         f"expected one of {ROUTING_POLICIES}")
    if policy == "sources":
        sigs = sorted({op.signature for op in toposort(batch.sinks)
                       if op.op_class == SOURCE})
        if not sigs:      # sourceless batch (constants/UDFs): key on sinks
            sigs = sorted(r.signature for r in batch.sinks)
    else:
        sigs = sorted(r.signature for r in batch.sinks)
    h = hashlib.blake2b(digest_size=16)
    for s in sigs:
        h.update(s.encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

def _frame(kind: int, payload: bytes) -> bytes:
    digest = hashlib.blake2b(payload, digest_size=16).digest()
    return (_MAGIC + bytes((_VERSION, kind)) + digest + payload)


def _unframe(data: bytes, kind: int) -> bytes:
    if len(data) < 22 or data[:4] != _MAGIC:
        raise CodecError("not a fabric wire frame")
    if data[4] != _VERSION:
        raise CodecError(f"wire version {data[4]} != {_VERSION}")
    if data[5] != kind:
        raise CodecError(f"frame kind {data[5]:#x}, expected {kind:#x}")
    digest, payload = data[6:22], data[22:]
    if hashlib.blake2b(payload, digest_size=16).digest() != digest:
        raise CodecError("checksum mismatch: frame corrupted in transit")
    return payload


def frame_kind(data: bytes) -> int:
    """The kind byte of a wire frame, after validating magic + version.

    Multiplexed byte channels (the out-of-process transport carries jobs,
    results, cancels and control frames on one stream) peek this to
    dispatch a frame without committing to a decoder; the per-kind
    ``decode_*`` function still re-validates everything including the
    checksum."""
    if len(data) < 22 or data[:4] != _MAGIC:
        raise CodecError("not a fabric wire frame")
    if data[4] != _VERSION:
        raise CodecError(f"wire version {data[4]} != {_VERSION}")
    return data[5]


def _host(value: Any) -> Any:
    """Device-independent representation: arrays and tensors (CUDA ones
    too) to host numpy, recursively."""
    if isinstance(value, (tuple, list)):
        return type(value)(_host(v) for v in value)
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        return host_array(value)
    return value


def encode_job(env: JobEnvelope) -> bytes:
    payload = pickle.dumps(
        {"envelope_id": env.envelope_id, "tenant": env.tenant,
         "priority": int(env.priority), "routing_key": env.routing_key,
         "attempt": env.attempt,
         "deadline_s": env.deadline_s, "tags": list(env.tags),
         "hops": [tuple(h) for h in env.hops],
         "sinks": list(env.batch.sinks), "names": list(env.batch.names)},
        protocol=pickle.HIGHEST_PROTOCOL)
    return _frame(_JOB_KIND, payload)


def decode_job(data: bytes) -> JobEnvelope:
    payload = _unframe(data, _JOB_KIND)
    try:
        d = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 — surface as a codec failure
        raise CodecError(f"job payload does not deserialize: {e!r}") from e
    # fresh uids for every op: uid collisions across origin processes would
    # corrupt uid-keyed passes once the shard coalesces decoded batches
    sinks = rebuild(d["sinks"], lambda op, ins: op.with_inputs(ins))
    return JobEnvelope(envelope_id=d["envelope_id"], tenant=d["tenant"],
                       priority=d["priority"], routing_key=d["routing_key"],
                       batch=PipelineBatch(sinks, d["names"]),
                       attempt=d["attempt"],
                       deadline_s=d.get("deadline_s"),
                       tags=tuple(d.get("tags", ())),
                       hops=tuple(tuple(h) for h in d.get("hops", ())))


def encode_cancel(env: CancelEnvelope) -> bytes:
    payload = pickle.dumps(
        {"envelope_id": env.envelope_id, "tenant": env.tenant,
         "attempt": env.attempt},
        protocol=pickle.HIGHEST_PROTOCOL)
    return _frame(_CANCEL_KIND, payload)


def decode_cancel(data: bytes) -> CancelEnvelope:
    payload = _unframe(data, _CANCEL_KIND)
    try:
        d = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001
        raise CodecError(f"cancel payload does not deserialize: {e!r}") from e
    return CancelEnvelope(envelope_id=d["envelope_id"], tenant=d["tenant"],
                          attempt=d.get("attempt", 0))


def _encode_error(error: BaseException) -> bytes:
    """Pickle a wire-crossing error, degrading as little as possible.

    An :class:`~repro_torch.core.runtime.ExecutionError` whose *cause* (or an
    op spec payload) doesn't pickle is re-raised with the cause stringified —
    keeping ``.op``/``.cause`` attributes intact for the tenant — before
    falling all the way back to an opaque ``RuntimeError``."""
    try:
        return pickle.dumps(error, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception:  # noqa: BLE001 — unpicklable cause/op payloads
        pass
    from ...core.runtime import ExecutionError
    if isinstance(error, ExecutionError):
        try:
            return pickle.dumps(
                ExecutionError(error.op, RuntimeError(repr(error.cause))),
                protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:  # noqa: BLE001 — the op itself doesn't pickle
            pass
    return pickle.dumps(
        RuntimeError(f"{type(error).__name__}: {error}"),
        protocol=pickle.HIGHEST_PROTOCOL)


def encode_result(env: ResultEnvelope) -> bytes:
    error: Optional[bytes] = None
    if env.error is not None:
        error = _encode_error(env.error)
    payload = pickle.dumps(
        {"envelope_id": env.envelope_id, "tenant": env.tenant,
         "shard_id": env.shard_id, "ok": env.ok,
         "results": _host(env.results) if env.results is not None else None,
         "report": env.report, "error": error, "attempt": env.attempt},
        protocol=pickle.HIGHEST_PROTOCOL)
    return _frame(_RESULT_KIND, payload)


def decode_result(data: bytes) -> ResultEnvelope:
    payload = _unframe(data, _RESULT_KIND)
    try:
        d = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001
        raise CodecError(f"result payload does not deserialize: {e!r}") from e
    error = None
    if d["error"] is not None:
        try:
            error = pickle.loads(d["error"])
        except Exception as e:  # noqa: BLE001 — keep the failure visible
            error = RuntimeError(f"shard error (opaque on the wire): {e!r}")
    return ResultEnvelope(envelope_id=d["envelope_id"], tenant=d["tenant"],
                          shard_id=d["shard_id"], ok=d["ok"],
                          results=d["results"], report=d["report"],
                          error=error, attempt=d.get("attempt", 0))
