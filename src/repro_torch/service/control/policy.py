"""The closed-loop control policy: targets, floors, gains, cooldowns.

:class:`ControlPolicy` is deliberately a plain frozen dataclass of
scalars — it crosses the proc-fabric CONFIG frame pickled inside
``ServiceConfig``, so every field must survive a pickle round-trip into
a fresh worker interpreter.  The semantics of each knob family live in
``docs/SCHEDULING.md`` §5; the actuation mechanics in
:class:`~repro_torch.service.control.controller.ServiceController`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ControlPolicy:
    """Targets, floors, gains and cooldowns for the feedback controller.

    Three knob families (all read the windowed collector, never
    instantaneous counters):

    * **adaptive admission gate** — when windowed dispatch p99 exceeds
      ``dispatch_p99_target_s``, ``max_queued_total`` shrinks
      multiplicatively (``admission_decrease``, floored at
      ``min_queued_total``) and the bulk bands (BATCH/SCAVENGER) get
      per-band admission caps; it regrows additively
      (``admission_increase``) once p99 recovers below
      ``dispatch_p99_target_s * recovery_fraction`` — classic AIMD.
      ``interactive_reserve`` INTERACTIVE slots bypass the total gate at
      all times, so latency probes are admitted even while a flood holds
      the queue at its limit (the "never starved" floor clamp);
    * **WFQ weight rebalancer** — a band whose windowed deadline
      attainment sags below ``attainment_floor`` has its weight
      multiplied by ``weight_gain`` (capped at ``max_weight_factor``
      over the configured default) and decays back geometrically
      (``weight_decay``) once it recovers;
    * **autoscale signal** — the proc-fabric autoscaler consumes the
      merged windowed attainment trend (see
      :class:`~repro_torch.service.fabric.proc.autoscale.AutoscalePolicy`);
      this policy only governs the per-shard knobs above.

    Guards: a window carrying fewer than ``min_window_jobs`` dispatch
    samples (or fewer than ``min_deadline_jobs`` SLO outcomes, for the
    rebalancer) is treated as "no evidence" — it can trigger recovery
    but never a shrink/boost, so idle gaps cause no spurious retunes.
    ``cooldown_s`` rate-limits the aggressive direction of each knob
    (shrinks and boosts); the recovery direction acts every tick so the
    system decays smoothly back to its configured defaults.
    """

    tick_interval_s: float = 0.25

    # -- adaptive admission gate (AIMD on windowed dispatch p99) -----------
    dispatch_p99_target_s: float = 1.0
    recovery_fraction: float = 0.5
    admission_decrease: float = 0.5      # multiplicative shrink per breach
    admission_increase: int = 32         # additive regrow per calm tick
    min_queued_total: int = 8            # shrink floor
    interactive_reserve: int = 8         # INTERACTIVE slots above the gate

    # -- WFQ weight rebalancer (windowed per-band attainment) --------------
    attainment_floor: float = 0.9
    weight_gain: float = 2.0             # multiply a sagging band's weight
    max_weight_factor: float = 8.0       # cap over the configured default
    weight_decay: float = 0.5            # factor-excess decay per calm tick

    # -- shared guards -----------------------------------------------------
    cooldown_s: float = 1.0
    min_window_jobs: int = 4
    min_deadline_jobs: int = 1

    def __post_init__(self) -> None:
        if self.tick_interval_s <= 0:
            raise ValueError("tick_interval_s must be > 0")
        if not 0 < self.admission_decrease < 1:
            raise ValueError("admission_decrease must be in (0, 1)")
        if self.admission_increase < 1:
            raise ValueError("admission_increase must be >= 1")
        if self.min_queued_total < 1:
            raise ValueError("min_queued_total must be >= 1")
        if self.interactive_reserve < 0:
            raise ValueError("interactive_reserve must be >= 0")
        if not 0 < self.recovery_fraction <= 1:
            raise ValueError("recovery_fraction must be in (0, 1]")
        if not 0 < self.attainment_floor <= 1:
            raise ValueError("attainment_floor must be in (0, 1]")
        if self.weight_gain <= 1:
            raise ValueError("weight_gain must be > 1")
        if self.max_weight_factor < self.weight_gain:
            raise ValueError("max_weight_factor must be >= weight_gain")
        if not 0 < self.weight_decay < 1:
            raise ValueError("weight_decay must be in (0, 1)")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
