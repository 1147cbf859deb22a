"""Fabric-level telemetry: per-shard state plus cross-shard aggregation.

A sharded fabric multiplies the observability problem: each shard keeps its
own :class:`~repro_torch.service.telemetry.ServiceTelemetry` ledger, and the
router keeps the placement-side counters (envelopes per shard, locality,
failovers).  :class:`FabricTelemetry` joins both without copying state —
snapshots are taken live from the shards — and exposes the same
``snapshot()`` / ``global_snapshot()`` / ``report()`` surface as a single
service, so :class:`~repro_torch.service.session.Session.telemetry` and
existing dashboards work unchanged against the fabric.

The interesting fabric-only number is the **signature-locality hit rate**:
of all routed envelopes whose routing key had been seen before, the
fraction that landed on the same shard as last time.  With a stable ring
this is 1.0; it degrades exactly by the keys remapped during membership
changes, so it doubles as a live measure of how much cache/CSE locality a
rebalance or failover cost.
"""

from __future__ import annotations

from ..control import merge_control_snapshots
from ..observability import merge_window_snapshots
from ..telemetry import merge_tenant_snapshots


class FabricTelemetry:
    """Aggregated view over the router and every live shard service.

    ``shards`` is a zero-argument callable returning a *copied* dict of
    live shards (taken under the fabric's lock) — the live dict mutates
    during failover/rebalance, and iterating it directly from a
    monitoring thread would race those membership changes."""

    def __init__(self, router, shards, extra=None) -> None:
        self._router = router
        self._shards = shards     # () -> dict shard_id -> StratumService
        # optional zero-argument callable merged into global_snapshot():
        # lets a fabric variant (the out-of-process fabric adds worker
        # pids, autoscale and warm-hand-off counters under a "proc" key)
        # extend the snapshot without subclassing the aggregation
        self._extra = extra
        # final ledgers of failed/drained shards: fabric-wide counters must
        # stay monotone — a shard's history doesn't vanish with the shard
        self._retired: dict = {}  # shard_id -> (tenant_snap, per_shard row)

    def retire(self, shard_id: str, svc) -> None:
        """Freeze a departing shard's ledger before the fabric drops it."""
        g = svc.telemetry.global_snapshot()
        row = {
            "retired": True,
            "queue_depth": 0,
            "inflight": 0,
            "envelopes_routed":
                self._router.envelopes_routed.get(shard_id, 0),
            "pending_replies": 0,
            "super_batches": g["super_batches"],
            "jobs_coalesced": g["jobs_coalesced"],
            "ops_deduped_cross_agent": g["ops_deduped_cross_agent"],
            "preemptions": g["preemptions"],
        }
        if "plan_cache" in g:
            row["plan_cache"] = g["plan_cache"]
        if "windows" in g:
            # last windowed snapshot the shard produced, frozen as-is
            row["windows"] = g["windows"]
        if "control" in g:
            # actuation counters stay monotone across scale-down/failover
            row["control"] = g["control"]
        self._retired[shard_id] = (svc.telemetry.snapshot(), row)

    # -- per-tenant view (Session.telemetry compatibility) -----------------
    def snapshot(self) -> dict:
        snaps = [snap for snap, _ in self._retired.values()]
        snaps += [svc.telemetry.snapshot()
                  for svc in self._shards().values()]
        return merge_tenant_snapshots(snaps)

    # -- fabric-wide view --------------------------------------------------
    def per_shard(self) -> dict:
        r = self._router
        out: dict[str, dict] = {sid: dict(row)
                                for sid, (_, row) in self._retired.items()}
        for shard_id, svc in self._shards().items():
            g = svc.telemetry.global_snapshot()
            out[shard_id] = {
                "queue_depth": svc.queue_depth(),
                "inflight": svc.inflight(),
                "envelopes_routed": r.envelopes_routed.get(shard_id, 0),
                "pending_replies": r.pending_count(shard_id),
                "super_batches": g["super_batches"],
                "jobs_coalesced": g["jobs_coalesced"],
                "ops_deduped_cross_agent": g["ops_deduped_cross_agent"],
                "preemptions": g["preemptions"],
            }
            if "cache_cross_tenant_hits" in g:
                out[shard_id]["cache_cross_tenant_hits"] = \
                    g["cache_cross_tenant_hits"]
            if "plan_cache" in g:
                out[shard_id]["plan_cache"] = g["plan_cache"]
            if "windows" in g:
                out[shard_id]["windows"] = g["windows"]
            if "control" in g:
                out[shard_id]["control"] = g["control"]
        return out

    def global_snapshot(self) -> dict:
        per_shard = self.per_shard()
        r = self._router
        totals = {
            "n_shards": sum(1 for s in per_shard.values()
                            if not s.get("retired")),
            "envelopes_routed": sum(s["envelopes_routed"]
                                    for s in per_shard.values()),
            "signature_locality_hit_rate": r.locality_hit_rate(),
            "failover_requeues": r.failover_requeues,
            "shards_failed": r.shards_failed,
            "shards_added": r.shards_added,
            "shards_drained": r.shards_drained,
            "reply_codec_errors": r.reply_codec_errors,
            "cancels_sent": r.cancels_sent,
            "cancels_confirmed": r.cancels_confirmed,
            "super_batches": sum(s["super_batches"]
                                 for s in per_shard.values()),
            "jobs_coalesced": sum(s["jobs_coalesced"]
                                  for s in per_shard.values()),
            "ops_deduped_cross_agent": sum(s["ops_deduped_cross_agent"]
                                           for s in per_shard.values()),
            "preemptions": sum(s["preemptions"]
                               for s in per_shard.values()),
        }
        # compiled-plan reuse fabric-wide: signature-locality routing means
        # repeat structures land on the shard already holding the compile,
        # so this rate is the fabric's compiled-plan locality measure
        # deadline attainment fabric-wide: derived from the merged tenant
        # ledgers (which include retired shards' frozen snapshots), so the
        # rate stays monotone across failover/rebalance
        tenants = self.snapshot()
        d_jobs = sum(s.get("deadline_jobs", 0) for s in tenants.values())
        d_met = sum(s.get("deadline_met", 0) for s in tenants.values())
        d_shed = sum(s.get("deadline_shed", 0) for s in tenants.values())
        totals["deadline"] = {
            "jobs": d_jobs,
            "met": d_met,
            "shed": d_shed,
            "attainment": (d_met / d_jobs) if d_jobs else 1.0,
        }
        pc_rows = [s["plan_cache"] for s in per_shard.values()
                   if "plan_cache" in s]
        if pc_rows:
            hits = sum(r["hits"] for r in pc_rows)
            misses = sum(r["misses"] for r in pc_rows)
            totals["plan_cache_hits"] = hits
            totals["plan_cache_misses"] = misses
            totals["plan_cache_entries"] = sum(r["entries"] for r in pc_rows)
            totals["plan_cache_hit_rate"] = (
                hits / (hits + misses) if hits + misses else 0.0)
            # async-compile lane fabric-wide (``.get``: retired shards'
            # frozen rows may predate these fields)
            totals["plan_cache_async_compiles"] = sum(
                r.get("async_compiles", 0) for r in pc_rows)
            totals["plan_cache_inflight"] = sum(
                r.get("inflight", 0) for r in pc_rows)
            totals["plan_cache_speculative_hits"] = sum(
                r.get("speculative_hits", 0) for r in pc_rows)
            totals["plan_cache_compile_time_s"] = sum(
                r.get("compile_time_s", 0.0) for r in pc_rows)
        # windowed throughput/attainment fabric-wide: counters sum, depth
        # maxes, percentiles recombine from each shard's capped samples
        win_rows = [s["windows"] for s in per_shard.values()
                    if s.get("windows")]
        if win_rows:
            totals["windows"] = merge_window_snapshots(win_rows)
        # closed-loop controller state fabric-wide: actuation counters sum
        # (retired shards' frozen blocks included, so they stay monotone)
        ctl_rows = [s["control"] for s in per_shard.values()
                    if s.get("control")]
        if ctl_rows:
            totals["control"] = merge_control_snapshots(ctl_rows)
        if self._extra is not None:
            try:
                totals.update(self._extra() or {})
            except Exception:  # noqa: BLE001 — extras must never break obs
                pass
        totals["per_shard"] = per_shard
        return totals

    def report(self) -> str:
        g = self.global_snapshot()
        lines = [
            f"fabric: {g['n_shards']} shard(s), "
            f"{g['envelopes_routed']} envelopes routed, "
            f"locality={g['signature_locality_hit_rate']:.2f}, "
            f"failover_requeues={g['failover_requeues']}",
        ]
        for shard_id in sorted(g["per_shard"]):
            s = g["per_shard"][shard_id]
            lines.append(
                f"  {shard_id}: routed={s['envelopes_routed']} "
                f"queue={s['queue_depth']} inflight={s['inflight']} "
                f"super_batches={s['super_batches']} "
                f"deduped={s['ops_deduped_cross_agent']}")
        for tenant, s in sorted(self.snapshot().items()):
            lines.append(
                f"  {tenant}: jobs={s['jobs_completed']}/"
                f"{s['jobs_submitted']} wait={s['queue_wait_s']:.3f}s "
                f"cache_hits={s['cache_hits']}")
        return "\n".join(lines)
