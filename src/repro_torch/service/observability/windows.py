"""Windowed throughput/attainment collector.

A ring buffer of fixed-width time windows (cf. the dashboard
``collector/throughput.rs`` idiom from ROADMAP): each window accumulates
submit/complete/preempt/shed counters, deadline outcomes, max queue depth
and raw dispatch latencies; ``snapshot()`` aggregates the ring into a
JSON-safe dict with throughput, attainment and nearest-rank p50/p99.

Snapshots from many shards merge with :func:`merge_window_snapshots`
(used by ``FabricTelemetry`` and ``merge_tenant_snapshots``): counters
sum, depth maxes, and percentiles are recomputed from the concatenated
(capped) latency samples.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Optional

#: cap on latency samples kept per window / shipped per snapshot, so
#: heartbeat frames and merges stay bounded under floods
MAX_SAMPLES = 512

_COUNTERS = ("submitted", "completed", "preempted", "shed",
             "deadline_jobs", "deadline_met")


def _sum_by_band(rows) -> dict:
    """Sum per-band deadline outcomes across windows/snapshots.

    Accepts both the in-window ``{band: [jobs, met]}`` form and the
    snapshot ``{band: {"deadline_jobs": .., "deadline_met": ..}}`` form;
    band keys are normalized to int (heartbeat/JSON round-trips turn
    them into strings)."""
    out: dict = {}
    for row in rows:
        if not row:
            continue
        for k, v in row.items():
            if isinstance(v, dict):
                jobs = v.get("deadline_jobs", 0)
                met = v.get("deadline_met", 0)
            else:
                jobs, met = v[0], v[1]
            agg = out.setdefault(int(k), [0, 0])
            agg[0] += jobs
            agg[1] += met
    return {b: {"deadline_jobs": j, "deadline_met": m,
                "attainment": (m / j) if j else 1.0}
            for b, (j, m) in out.items()}


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a sequence."""
    s = sorted(samples)
    if not s:
        return 0.0
    rank = math.ceil(q / 100.0 * len(s)) - 1
    return float(s[max(0, min(len(s) - 1, rank))])


def _new_window() -> dict:
    w = {k: 0 for k in _COUNTERS}
    w["queue_depth_max"] = 0
    w["latency"] = []
    # per-band deadline outcomes: band int -> [jobs, met] — feeds the WFQ
    # weight rebalancer (control/), which needs attainment per band, not
    # just the global rate
    w["by_band"] = {}
    return w


class ThroughputCollector:
    """Ring buffer of fixed-width windows over service activity.

    Thread-safe; every ``record_*`` hook first rolls the ring forward to
    the current window (clamped so an idle gap never spins more than
    ``n_windows`` catch-up steps).
    """

    def __init__(self, window_s: float = 1.0, n_windows: int = 32,
                 clock=time.monotonic):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        if n_windows < 1:
            raise ValueError("n_windows must be >= 1")
        self.window_s = float(window_s)
        self.n_windows = int(n_windows)
        self._clock = clock
        self._lock = threading.Lock()
        self._epoch = clock()
        self._index = 0                       # index of the open window
        self._closed = deque(maxlen=self.n_windows)
        self._current = _new_window()

    # -- ring mechanics ---------------------------------------------------
    def _roll(self) -> None:
        idx = int((self._clock() - self._epoch) / self.window_s)
        if idx <= self._index:
            return
        steps = idx - self._index
        if steps > self.n_windows:
            # long idle gap: the old current window and any intermediate
            # empties would all fall off the ring anyway — just blank it
            for _ in range(self.n_windows):
                self._closed.append(_new_window())
        else:
            self._closed.append(self._current)
            for _ in range(steps - 1):
                self._closed.append(_new_window())
        self._current = _new_window()
        self._index = idx

    # -- record hooks -----------------------------------------------------
    def record_submit(self) -> None:
        with self._lock:
            self._roll()
            self._current["submitted"] += 1

    def record_dispatch(self, latency_s: float, queue_depth: int = 0) -> None:
        with self._lock:
            self._roll()
            w = self._current
            if len(w["latency"]) < MAX_SAMPLES:
                w["latency"].append(float(latency_s))
            if queue_depth > w["queue_depth_max"]:
                w["queue_depth_max"] = int(queue_depth)

    def record_completion(self, n: int = 1) -> None:
        with self._lock:
            self._roll()
            self._current["completed"] += int(n)

    def record_preemption(self, n: int = 1) -> None:
        with self._lock:
            self._roll()
            self._current["preempted"] += int(n)

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self._roll()
            self._current["shed"] += int(n)

    def record_deadline_outcome(self, met: bool,
                                band: Optional[int] = None) -> None:
        with self._lock:
            self._roll()
            self._current["deadline_jobs"] += 1
            if met:
                self._current["deadline_met"] += 1
            if band is not None:
                row = self._current["by_band"].setdefault(int(band), [0, 0])
                row[0] += 1
                if met:
                    row[1] += 1

    # -- read side --------------------------------------------------------
    def snapshot(self) -> dict:
        """Aggregate the ring (closed windows + the open one)."""
        with self._lock:
            self._roll()
            windows = list(self._closed) + [self._current]
            return self._aggregate(windows)

    def _aggregate(self, windows) -> dict:
        out = {k: sum(w[k] for w in windows) for k in _COUNTERS}
        out["queue_depth_max"] = max(
            (w["queue_depth_max"] for w in windows), default=0)
        samples: list = []
        for w in windows:
            samples.extend(w["latency"])
        samples = samples[-MAX_SAMPLES:]
        span_s = len(windows) * self.window_s
        out["window_s"] = self.window_s
        out["n_windows"] = len(windows)
        out["span_s"] = span_s
        out["throughput_per_s"] = out["completed"] / span_s if span_s else 0.0
        out["attainment"] = (out["deadline_met"] / out["deadline_jobs"]
                             if out["deadline_jobs"] else 1.0)
        out["dispatch_p50_s"] = percentile(samples, 50)
        out["dispatch_p99_s"] = percentile(samples, 99)
        out["latency_samples"] = samples
        by_band = _sum_by_band(w.get("by_band") for w in windows)
        if by_band:
            out["by_band"] = by_band
        out["per_window"] = [
            {k: w[k] for k in _COUNTERS} | {
                "queue_depth_max": w["queue_depth_max"],
                "dispatch_p50_s": percentile(w["latency"], 50),
                "dispatch_p99_s": percentile(w["latency"], 99),
            }
            for w in windows]
        return out


def merge_window_snapshots(snaps) -> Optional[dict]:
    """Merge per-shard ``ThroughputCollector.snapshot()`` dicts.

    Counters and throughput sum, queue depth maxes, attainment is
    recomputed from the summed deadline outcomes, and p50/p99 come from
    the concatenated (capped) latency samples.  Returns ``None`` when no
    snapshot in ``snaps`` is present.
    """
    snaps = [s for s in snaps if s]
    if not snaps:
        return None
    out = {k: sum(s.get(k, 0) for s in snaps) for k in _COUNTERS}
    out["queue_depth_max"] = max(s.get("queue_depth_max", 0) for s in snaps)
    samples: list = []
    for s in snaps:
        samples.extend(s.get("latency_samples", ()))
    samples = samples[-MAX_SAMPLES:]
    out["window_s"] = snaps[0].get("window_s", 1.0)
    out["n_windows"] = max(s.get("n_windows", 0) for s in snaps)
    out["span_s"] = max(s.get("span_s", 0.0) for s in snaps)
    out["throughput_per_s"] = sum(s.get("throughput_per_s", 0.0)
                                  for s in snaps)
    out["attainment"] = (out["deadline_met"] / out["deadline_jobs"]
                         if out["deadline_jobs"] else 1.0)
    out["dispatch_p50_s"] = percentile(samples, 50)
    out["dispatch_p99_s"] = percentile(samples, 99)
    out["latency_samples"] = samples
    by_band = _sum_by_band(s.get("by_band") for s in snaps)
    if by_band:
        out["by_band"] = by_band
    return out
