"""Structured JSONL event log + the per-process trace sink.

``TraceLog`` appends one JSON object per hop to
``<trace_dir>/events-<component>-<pid>.jsonl`` and flushes per line, so a
SIGKILLed worker's already-stamped hops (e.g. the ``dispatched`` hop of
the job it died holding) survive on disk and are recoverable by
:mod:`repro_torch.service.observability.replay`.

``TraceSink`` owns live :class:`JobTrace` objects for one component
(client, service shard, proc worker), moves finished traces into a
bounded ring, and fans every stamped hop out to the JSONL log.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Optional

from .trace import JobTrace

#: completed traces kept in memory per sink
COMPLETED_RING = 256


def hop_record(key: str, tenant: str, hop) -> dict:
    """JSON-safe record for one hop (the JSONL line schema)."""
    event, t, shard, slack, detail = hop
    return {"job": key, "tenant": tenant, "event": event, "t": t,
            "shard": shard, "slack": slack, "detail": dict(detail)}


def record_hop(rec: dict) -> tuple:
    """Inverse of :func:`hop_record` — rebuild the hop tuple."""
    return (rec["event"], rec["t"], rec.get("shard", ""),
            rec.get("slack"), dict(rec.get("detail", ())))


class TraceLog:
    """Append-only JSONL writer, one file per process per component."""

    def __init__(self, trace_dir: str, component: str):
        os.makedirs(trace_dir, exist_ok=True)
        self.path = os.path.join(
            trace_dir, f"events-{component}-{os.getpid()}.jsonl")
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()  # survive kill -9 mid-job

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class TraceSink:
    """Registry of live/finished traces for one component.

    Disabled sinks (``enabled=False`` and no ``trace_dir``) hand back
    ``None`` from :meth:`begin` so call sites stay zero-overhead via a
    plain ``if trace is not None`` guard.
    """

    def __init__(self, trace_dir: Optional[str] = None,
                 component: str = "service", enabled: bool = False):
        self.enabled = bool(enabled or trace_dir)
        self.component = component
        self.log = TraceLog(trace_dir, component) if trace_dir else None
        self._lock = threading.Lock()
        self._live: dict = {}
        self._done: OrderedDict = OrderedDict()

    # -- lifecycle --------------------------------------------------------
    def begin(self, key: str, tenant: str, hops=()) -> Optional[JobTrace]:
        """Open a trace.  ``hops`` seeds it with upstream history (e.g. the
        client-side hops an envelope carried over the wire); seed hops are
        NOT re-emitted to the JSONL log — they were logged at origin."""
        if not self.enabled:
            return None
        trace = JobTrace(key, tenant, hops=hops, sink=self)
        with self._lock:
            self._live[key] = trace
        return trace

    def finish(self, trace: Optional[JobTrace]) -> None:
        if trace is None:
            return
        with self._lock:
            self._live.pop(trace.key, None)
            self._done[trace.key] = trace
            while len(self._done) > COMPLETED_RING:
                self._done.popitem(last=False)

    def store(self, key: str, tenant: str, hops) -> Optional[JobTrace]:
        """Adopt an already-complete reassembled trace (client side, after
        a ``FabricJobReport`` arrives) without re-emitting its hops."""
        if not self.enabled:
            return None
        trace = JobTrace(key, tenant, hops=hops, sink=None)
        with self._lock:
            self._live.pop(key, None)
            self._done[key] = trace
            while len(self._done) > COMPLETED_RING:
                self._done.popitem(last=False)
        return trace

    # -- reads ------------------------------------------------------------
    def get(self, key: str) -> Optional[JobTrace]:
        with self._lock:
            return self._live.get(key) or self._done.get(key)

    def recent(self, n: int = 20) -> list:
        with self._lock:
            return list(self._done.values())[-n:]

    # -- raw emission (router-side hops with no JobTrace object) ----------
    def emit_hop(self, key: str, tenant: str, hop) -> None:
        if self.log is not None:
            self.log.append(hop_record(key, tenant, hop))

    def close(self) -> None:
        if self.log is not None:
            self.log.close()
