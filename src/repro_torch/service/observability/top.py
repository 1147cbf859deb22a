"""Live text view over fabric/service telemetry snapshots.

``render(snapshot)`` turns one ``telemetry.global_snapshot()`` dict
(which, since the observability PR, embeds per-shard windowed stats from
worker heartbeats) into a small fixed-width dashboard: per-shard queue
depth, plan-cache hit rate, windowed throughput/attainment/p99, and any
autoscale/proc events.  It is pure string formatting — the same renderer
backs ``examples/agentic_search.py --live`` and the CLI:

    python -m repro_torch.service.observability.top --snapshot snap.json
    python -m repro_torch.service.observability.top --demo
"""

from __future__ import annotations

import argparse
import json


def _bar(frac: float, width: int = 10) -> str:
    frac = max(0.0, min(1.0, frac))
    fill = int(round(frac * width))
    return "#" * fill + "." * (width - fill)


def _fmt_windows(win: dict) -> str:
    return (f"thr {win.get('throughput_per_s', 0.0):7.1f}/s  "
            f"att {win.get('attainment', 1.0):.2f} "
            f"[{_bar(win.get('attainment', 1.0))}]  "
            f"p50 {win.get('dispatch_p50_s', 0.0) * 1e3:7.1f}ms  "
            f"p99 {win.get('dispatch_p99_s', 0.0) * 1e3:7.1f}ms  "
            f"depth≤{win.get('queue_depth_max', 0)}")


def _cache_rate(row: dict) -> str:
    pc = row.get("plan_cache") or {}
    hits, misses = pc.get("hits", 0), pc.get("misses", 0)
    total = hits + misses
    return f"{hits / total:.2f}" if total else "  --"


def render(snapshot: dict) -> str:
    """Format one global telemetry snapshot as a live-view frame."""
    # Fabric/service snapshots keep lifecycle counters in the windowed
    # block rather than at the top level; fall back there so the header
    # reflects live traffic, not zeros.
    win = snapshot.get("windows") or {}
    lines = ["stratum top — "
             f"{snapshot.get('jobs_submitted', win.get('submitted', 0))}"
             " submitted / "
             f"{snapshot.get('jobs_completed', win.get('completed', 0))}"
             " done / "
             f"""{snapshot.get('jobs_preempted',
                               snapshot.get('preemptions',
                                            win.get('preempted', 0)))}"""
             " preempted / "
             f"{snapshot.get('jobs_cancelled', 0)} cancelled"]
    dl = snapshot.get("deadline") or {}
    if dl.get("jobs"):
        lines.append(f"deadline SLO: {dl.get('met', 0)}/{dl['jobs']} met "
                     f"(attainment {dl.get('attainment', 0.0):.2f}, "
                     f"shed {dl.get('shed', 0)})")
    if win:
        lines.append("windowed: " + _fmt_windows(win))

    # compile-side telemetry: a service snapshot nests the PlanCache
    # snapshot under "plan_cache"; the fabric merge flattens summed
    # counters to "plan_cache_*" keys
    pc = snapshot.get("plan_cache") or {}
    flat = {k[len("plan_cache_"):]: v for k, v in snapshot.items()
            if k.startswith("plan_cache_")}
    cc = pc or flat
    if cc:
        hits = cc.get("hits", 0)
        misses = cc.get("misses", 0)
        total = hits + misses
        rate = cc.get("hit_rate", hits / total if total else 0.0)
        lines.append(
            f"compile: plan$ {rate:.2f} "
            f"({cc.get('entries', 0)} entries)  "
            f"async {cc.get('async_compiles', 0)} "
            f"(inflight {cc.get('inflight', 0)})  "
            f"spec hits {cc.get('speculative_hits', 0)}  "
            f"compile {cc.get('compile_time_s', 0.0):.2f}s")

    shards = snapshot.get("per_shard") or {}
    if shards:
        lines.append(f"{'shard':<10} {'state':<8} {'depth':>5} "
                     f"{'inflight':>8} {'plan$':>6}  windowed")
        for sid in sorted(shards):
            row = shards[sid]
            swin = row.get("windows")
            lines.append(
                f"{sid:<10} {row.get('state', 'live'):<8} "
                f"{row.get('queue_depth', 0):>5} "
                f"{row.get('inflight', 0):>8} "
                f"{_cache_rate(row):>6}  "
                f"{_fmt_windows(swin) if swin else '--'}")

    ctl = snapshot.get("control") or {}
    if ctl:
        adm = ctl.get("admission") or {}
        wts = ctl.get("weights") or {}
        if "max_queued_total" in adm:
            gate = (f"gate {adm.get('max_queued_total', '?')}"
                    f"/{adm.get('configured_max_queued_total', '?')}"
                    + (" GATED" if adm.get("gated") else ""))
        else:       # fabric-merged block carries counts, not one gate
            gate = (f"{ctl.get('gated_shards', 0)}"
                    f"/{ctl.get('shards_reporting', 0)} shards gated")
        lines.append(
            f"control: {ctl.get('retunes', 0)} retunes "
            f"(admission -{adm.get('shrinks', 0)}/+{adm.get('regrows', 0)}, "
            f"weights +{wts.get('boosts', 0)}/-{wts.get('decays', 0)}) "
            f"{gate}")

    proc = snapshot.get("proc") or {}
    if proc:
        lines.append(f"proc: {proc.get('workers', 0)} workers, "
                     f"{proc.get('spawns', 0)} spawns, "
                     f"{proc.get('worker_failures', 0)} failures, "
                     f"handoff {proc.get('handoff_entries_shipped', 0)}")
        scale = proc.get("autoscale")
        if scale:
            lines.append(f"autoscale: {scale}")
    return "\n".join(lines)


def demo_snapshot() -> dict:
    """Synthetic snapshot for --demo and renderer smoke tests."""
    win = {"throughput_per_s": 42.5, "attainment": 0.93,
           "dispatch_p50_s": 0.012, "dispatch_p99_s": 0.087,
           "queue_depth_max": 7}
    return {
        "jobs_submitted": 120, "jobs_completed": 113, "jobs_preempted": 4,
        "jobs_cancelled": 1,
        "deadline": {"jobs": 60, "met": 56, "attainment": 0.93, "shed": 2},
        "windows": win,
        "plan_cache_hits": 49, "plan_cache_misses": 14,
        "plan_cache_entries": 9, "plan_cache_hit_rate": 0.78,
        "plan_cache_async_compiles": 7, "plan_cache_inflight": 1,
        "plan_cache_speculative_hits": 3,
        "plan_cache_compile_time_s": 1.37,
        "per_shard": {
            "shard0": {"state": "live", "queue_depth": 3, "inflight": 1,
                       "plan_cache": {"hits": 37, "misses": 5},
                       "windows": dict(win)},
            "shard1": {"state": "retired", "queue_depth": 0, "inflight": 0,
                       "plan_cache": {"hits": 12, "misses": 9},
                       "windows": dict(win)},
        },
        "proc": {"workers": 2, "spawns": 3, "worker_failures": 1,
                 "handoff_entries_shipped": 18,
                 "autoscale": {"target": 2, "reason": "backlog"}},
        "control": {"retunes": 5,
                    "admission": {"configured_max_queued_total": 1024,
                                  "max_queued_total": 256, "gated": True,
                                  "shrinks": 2, "regrows": 1},
                    "weights": {"factors": {0: 2.0}, "boosts": 1,
                                "decays": 1}},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service.observability.top",
        description="render a telemetry snapshot as a live text view")
    ap.add_argument("--snapshot", help="path to a JSON global_snapshot dump")
    ap.add_argument("--demo", action="store_true",
                    help="render a synthetic snapshot")
    args = ap.parse_args(argv)
    if args.snapshot:
        with open(args.snapshot, encoding="utf-8") as fh:
            snap = json.load(fh)
    elif args.demo:
        snap = demo_snapshot()
    else:
        ap.error("one of --snapshot or --demo is required")
        return 2
    print(render(snap))
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # e.g. `... | head`
        raise SystemExit(0)
