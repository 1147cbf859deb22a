"""Elastic shard-count control loop for the out-of-process fabric.

The :class:`Autoscaler` watches two pressure signals the fabric already
produces — the router's pending-table depth (jobs submitted, reply not
yet arrived) and fabric-wide deadline attainment — and actuates the two
membership verbs the fabric already has:

* **scale up** — sustained backlog per shard above
  ``scale_up_backlog_per_shard`` (or *windowed* deadline attainment
  sagging under ``attainment_floor`` for ``attainment_trend_len``
  consecutive ticks while deadline jobs are in play) spawns a fresh
  worker process via ``fabric.add_shard``.  Consistent hashing keeps the
  disruption bounded: only ~K/N keys remap to the newcomer.

  The attainment signal reads the merged windowed collector
  (``global_snapshot()["windows"]``, which includes retired shards'
  frozen windows), NOT the cumulative deadline block: the cumulative
  rate whipsaws when a burst of deadline jobs completes between
  heartbeats and, being all-time, can never recover once it has sagged.
  The trend requirement debounces single-window noise.
* **scale down** — a fabric idle for ``scale_down_idle_s`` straight
  (zero backlog, zero queued, zero in-flight) drains its newest shard
  via ``fabric.scale_down``, which ships the departing worker's hottest
  cache entries to its ring successor before the process exits — so the
  next burst doesn't start cold.

A cooldown after each scale-up stops flapping: a burst that the new
worker is still warming up for must not trigger a second spawn.  The
loop never drops below ``min_shards`` or above ``max_shards``, and
worker spawn failures are counted, logged in ``stats`` and retried on
the next tick rather than crashing the loop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass


@dataclass
class AutoscalePolicy:
    min_shards: int = 1
    max_shards: int = 4
    interval_s: float = 0.25
    # spawn when router backlog per live shard exceeds this
    scale_up_backlog_per_shard: float = 4.0
    # ... or when WINDOWED deadline attainment sags below this with SLO
    # jobs live for attainment_trend_len consecutive ticks
    attainment_floor: float = 0.9
    attainment_trend_len: int = 3
    scale_up_cooldown_s: float = 1.0
    # drain the newest shard after this long of fabric-wide idleness
    scale_down_idle_s: float = 2.0

    def __post_init__(self):
        if self.min_shards < 1:
            raise ValueError("min_shards must be >= 1")
        if self.max_shards < self.min_shards:
            raise ValueError("max_shards must be >= min_shards")
        if self.attainment_trend_len < 1:
            raise ValueError("attainment_trend_len must be >= 1")


class Autoscaler:
    def __init__(self, fabric, policy: AutoscalePolicy):
        self.fabric = fabric
        self.policy = policy
        self.scale_ups = 0
        self.scale_downs = 0
        self.spawn_failures = 0
        self._counter = 0
        self._last_scale_up = 0.0
        self._idle_since: float = 0.0       # 0 → not currently idle
        # recent windowed-attainment observations; pressure requires the
        # full deque to sag below the floor (trend, not a single sample)
        self._att_trend: deque = deque(maxlen=policy.attainment_trend_len)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="proc-autoscaler", daemon=True)

    def start(self) -> "Autoscaler":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def stats(self) -> dict:
        return {"scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "spawn_failures": self.spawn_failures}

    # -- control loop --------------------------------------------------------
    def _loop(self) -> None:
        p = self.policy
        while not self._stop.wait(p.interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the loop must survive a
                pass           # mid-failover race; next tick re-reads state

    def _tick(self) -> None:
        p = self.policy
        fabric = self.fabric
        shard_ids = fabric.shard_ids()
        n = len(shard_ids)
        if n == 0:
            return                          # fabric stopping or all failed
        backlog = fabric.router.pending_count()
        now = time.monotonic()

        # -- scale up --------------------------------------------------------
        if n < p.max_shards \
                and now - self._last_scale_up >= p.scale_up_cooldown_s:
            pressure = backlog / n > p.scale_up_backlog_per_shard
            if not pressure and backlog:
                # windowed attainment trend (NOT the cumulative deadline
                # block, which whipsaws on bursts and never recovers):
                # the merged windows include retired shards' frozen rows
                win = (fabric.telemetry.global_snapshot()
                       .get("windows") or {})
                if win.get("deadline_jobs", 0) > 0:
                    self._att_trend.append(win.get("attainment", 1.0))
                else:
                    self._att_trend.clear()   # no SLO evidence in window
                pressure = (len(self._att_trend)
                            == p.attainment_trend_len
                            and all(a < p.attainment_floor
                                    for a in self._att_trend))
            if pressure:
                self._counter += 1
                self._idle_since = 0.0
                self._att_trend.clear()   # restart the trend post-spawn
                try:
                    fabric.add_shard(f"auto-{self._counter}")
                except Exception:  # noqa: BLE001 — spawn failed; retry
                    self.spawn_failures += 1
                    return
                self.scale_ups += 1
                self._last_scale_up = now
                return

        # -- scale down ------------------------------------------------------
        if n <= p.min_shards:
            self._idle_since = 0.0
            return
        if backlog or any(s.queue_depth() or s.inflight()
                          for s in fabric.shards().values()):
            self._idle_since = 0.0
            return
        if not self._idle_since:
            self._idle_since = now
            return
        if now - self._idle_since < p.scale_down_idle_s:
            return
        victim = fabric.newest_shard()
        if victim is None:
            return
        self._idle_since = 0.0
        fabric.scale_down(victim)
        self.scale_downs += 1
