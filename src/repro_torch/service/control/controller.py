"""The feedback controller: windowed observations → knob actuations.

One :class:`ServiceController` per shard service.  It owns no thread —
the server's dispatch loop (and, fabric-side, the proc worker's
heartbeat loop) calls :meth:`maybe_tick`, which rate-limits itself to
``policy.tick_interval_s``.  Each tick reads ONE windowed collector
snapshot and runs two actuators against the live :class:`FairQueue`:

* the **admission gate** (AIMD on windowed dispatch p99) via
  ``queue.set_limits`` — shrink ``max_queued_total`` + cap the bulk
  bands on a breach, regrow additively on recovery; the INTERACTIVE
  reserve is installed at attach time and never revoked, so
  latency-critical probes are admitted even mid-flood;
* the **WFQ weight rebalancer** (windowed per-band attainment) via
  ``queue.set_weights`` — boost a sagging band's weight, decay it back
  once the band recovers.

Every actuation is observable three ways: a ``retuned`` hop in the JSONL
event log (under the synthetic job key ``"control"``, replayable like
any other timeline), an entry in the bounded ``last_actions`` ring of
:meth:`snapshot` (surfaced as the telemetry ``"control"`` block), and
the counters that :mod:`repro_torch.service.observability.top` renders.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..observability import RETUNED, make_hop
from ..priority import Priority
from .policy import ControlPolicy

#: recent actuations kept in the snapshot ring
ACTION_RING = 16

#: synthetic job key under which retuned hops land in the event log
CONTROL_TRACE_KEY = "control"


class ServiceController:
    """Closed-loop retuner for one shard's queue knobs.

    Thread-safe: ticks run on the dispatch (or worker-heartbeat) thread
    while ``snapshot()`` is read from telemetry threads.
    """

    def __init__(self, policy: ControlPolicy, queue, windows,
                 trace_sink=None, shard_id: str = "",
                 clock=time.monotonic):
        self.policy = policy
        self.queue = queue
        self.windows = windows
        self.trace_sink = trace_sink
        self.shard_id = shard_id
        self._clock = clock
        self._lock = threading.Lock()
        # baselines captured from the queue as configured
        self._base_total = int(queue.max_queued_total)
        self._base_weights = dict(queue.weights)
        self._cur_total = self._base_total
        self._factors = {int(p): 1.0 for p in self._base_weights}
        # actuation counters
        self.retunes = 0
        self.admission_shrinks = 0
        self.admission_regrows = 0
        self.weight_boosts = 0
        self.weight_decays = 0
        self._last_tick = float("-inf")
        self._last_shrink = float("-inf")
        self._last_boost = {int(p): float("-inf") for p in self._base_weights}
        self._actions: list = []
        # the floor clamp is standing policy, not an actuation: INTERACTIVE
        # keeps `interactive_reserve` admission slots above the total gate
        # from the moment control attaches, so a flood that fills the queue
        # before the first p99 breach is detected still can't starve probes
        queue.set_limits(reserve_interactive=policy.interactive_reserve)

    # -- tick entry point --------------------------------------------------
    def maybe_tick(self) -> bool:
        """Run one control tick if ``tick_interval_s`` elapsed.

        Returns True when a tick ran (not necessarily actuated)."""
        now = self._clock()
        with self._lock:
            if now - self._last_tick < self.policy.tick_interval_s:
                return False
            self._last_tick = now
        snap = self.windows.snapshot()
        with self._lock:
            self._admission_tick(now, snap)
            self._weights_tick(now, snap)
        return True

    # -- knob family 1: adaptive admission gate ----------------------------
    def _admission_tick(self, now: float, snap: dict) -> None:
        p = self.policy
        samples = len(snap.get("latency_samples") or ())
        p99 = snap.get("dispatch_p99_s", 0.0)
        if samples >= p.min_window_jobs and p99 > p.dispatch_p99_target_s:
            # breach: multiplicative decrease, floor-clamped, cooled down
            if (now - self._last_shrink >= p.cooldown_s
                    and self._cur_total > p.min_queued_total):
                self._cur_total = max(p.min_queued_total,
                                      int(self._cur_total
                                          * p.admission_decrease))
                self._last_shrink = now
                self.admission_shrinks += 1
                self._apply_admission()
                self._record(now, "admission", direction="shrink",
                             max_queued_total=self._cur_total,
                             dispatch_p99_s=round(p99, 6))
            return
        # calm (recovered p99, or a window too thin to be evidence):
        # additive regrow toward the configured default, every tick
        calm = (samples < p.min_window_jobs
                or p99 < p.dispatch_p99_target_s * p.recovery_fraction)
        if calm and self._cur_total < self._base_total:
            self._cur_total = min(self._base_total,
                                  self._cur_total + p.admission_increase)
            self.admission_regrows += 1
            self._apply_admission()
            self._record(now, "admission", direction="regrow",
                         max_queued_total=self._cur_total,
                         dispatch_p99_s=round(p99, 6))

    def _apply_admission(self) -> None:
        p = self.policy
        gated = self._cur_total < self._base_total
        limits: dict = {}
        if gated:
            # the bulk bands share the gated budget; INTERACTIVE is never
            # band-limited and keeps its reserve above the total gate
            bulk = max(1, self._cur_total - p.interactive_reserve)
            limits = {int(Priority.BATCH): bulk,
                      int(Priority.SCAVENGER): bulk}
        self.queue.set_limits(max_queued_total=self._cur_total,
                              band_limits=limits,
                              reserve_interactive=p.interactive_reserve)

    # -- knob family 2: WFQ weight rebalancer ------------------------------
    def _weights_tick(self, now: float, snap: dict) -> None:
        p = self.policy
        by_band = snap.get("by_band") or {}
        changed = False
        for band, factor in list(self._factors.items()):
            row = by_band.get(band) or by_band.get(str(band)) or {}
            jobs = row.get("deadline_jobs", 0)
            att = (row.get("deadline_met", 0) / jobs) if jobs else None
            sagging = (jobs >= p.min_deadline_jobs
                       and att is not None and att < p.attainment_floor)
            if sagging:
                if (now - self._last_boost[band] >= p.cooldown_s
                        and factor < p.max_weight_factor):
                    self._factors[band] = min(p.max_weight_factor,
                                              factor * p.weight_gain)
                    self._last_boost[band] = now
                    self.weight_boosts += 1
                    changed = True
                    self._record(now, "weights", direction="boost",
                                 band=band,
                                 factor=round(self._factors[band], 3),
                                 attainment=round(att, 4))
            elif factor > 1.0:
                # recovered (or no SLO evidence): geometric decay of the
                # excess toward the configured default, every tick
                nxt = 1.0 + (factor - 1.0) * p.weight_decay
                if nxt < 1.0 + 1e-3:
                    nxt = 1.0
                self._factors[band] = nxt
                self.weight_decays += 1
                changed = True
                self._record(now, "weights", direction="decay", band=band,
                             factor=round(nxt, 3))
        if changed:
            self.queue.set_weights({
                prio: w * self._factors.get(int(prio), 1.0)
                for prio, w in self._base_weights.items()})

    # -- actuation record --------------------------------------------------
    def _record(self, now: float, knob: str, **detail) -> None:
        self.retunes += 1
        action = {"t": now, "knob": knob, **detail}
        self._actions.append(action)
        del self._actions[:-ACTION_RING]
        if self.trace_sink is not None:
            hop = make_hop(RETUNED, shard=self.shard_id, knob=knob,
                           **detail)
            self.trace_sink.emit_hop(CONTROL_TRACE_KEY, "", hop)

    # -- read side ---------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe state of the loop (the telemetry ``control`` block).

        Crosses proc heartbeat frames, so it must stay small and plain."""
        with self._lock:
            gated = self._cur_total < self._base_total
            boosted = {b: round(f, 3) for b, f in self._factors.items()
                       if f > 1.0}
            return {
                "retunes": self.retunes,
                "admission": {
                    "configured_max_queued_total": self._base_total,
                    "max_queued_total": self._cur_total,
                    "interactive_reserve": self.policy.interactive_reserve,
                    "gated": gated,
                    "shrinks": self.admission_shrinks,
                    "regrows": self.admission_regrows,
                },
                "weights": {
                    "factors": boosted,
                    "boosts": self.weight_boosts,
                    "decays": self.weight_decays,
                },
                "last_actions": [dict(a) for a in self._actions],
            }


def merge_control_snapshots(rows) -> Optional[dict]:
    """Merge per-shard ``control`` blocks into one fabric-wide view.

    Counters sum; ``gated_shards`` counts shards currently below their
    configured admission gate.  Returns ``None`` when no row is present.
    """
    rows = [r for r in rows if r]
    if not rows:
        return None
    out = {
        "retunes": sum(r.get("retunes", 0) for r in rows),
        "shards_reporting": len(rows),
        "gated_shards": sum(
            1 for r in rows if (r.get("admission") or {}).get("gated")),
        "admission": {
            "shrinks": sum((r.get("admission") or {}).get("shrinks", 0)
                           for r in rows),
            "regrows": sum((r.get("admission") or {}).get("regrows", 0)
                           for r in rows),
        },
        "weights": {
            "boosts": sum((r.get("weights") or {}).get("boosts", 0)
                          for r in rows),
            "decays": sum((r.get("weights") or {}).get("decays", 0)
                          for r in rows),
        },
    }
    return out
