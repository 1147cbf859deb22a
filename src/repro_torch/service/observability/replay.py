"""Postmortem replay of a JSONL trace directory.

Every process that participated in a run (client, in-process shards,
proc-fabric workers) wrote its own ``events-<component>-<pid>.jsonl``
under the shared ``trace_dir``.  Replay merges them all, reassembles one
per-job timeline (hops sorted by stamp time, de-duplicated on the full
hop tuple — the same hop logged by two components counts once), and
derives per-shard gantt summaries of dispatch→completion occupancy.

    python -m repro_torch.service.observability.replay /tmp/traces [--job KEY]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

from .trace import DISPATCHED, FAILOVER, PREEMPTED, TERMINAL


def load_events(trace_dir: str) -> list:
    """All hop records from every JSONL file under ``trace_dir``.

    A torn final line (process killed mid-write) is skipped, never fatal.
    """
    records = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "*.jsonl"))):
        component = os.path.basename(path)
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a killed writer
                rec["source"] = component
                records.append(rec)
    return records


def reassemble(records) -> dict:
    """Per-job timelines: ``{job_key: [hop_record, ...]}`` sorted by time.

    Identical hops logged by more than one component collapse to one.
    """
    jobs = defaultdict(list)
    seen = set()
    for rec in records:
        ident = (rec["job"], rec["event"], rec["t"], rec.get("shard", ""),
                 rec.get("slack"))
        if ident in seen:
            continue
        seen.add(ident)
        jobs[rec["job"]].append(rec)
    for hops in jobs.values():
        hops.sort(key=lambda r: r["t"])
    return dict(jobs)


def job_timeline(timelines: dict, key: str) -> list:
    return timelines.get(key, [])


def shard_gantt(timelines: dict) -> dict:
    """Per-shard dispatch spans: ``{shard: [(job, t0, t1, outcome), ...]}``.

    A span opens at each ``dispatched`` hop and closes at the next
    preempted/terminal hop of the same job; a span left open (worker
    killed mid-job) closes at the job's last known stamp with outcome
    ``"lost"``.
    """
    gantt = defaultdict(list)
    for key, hops in timelines.items():
        open_span = None  # (shard, t0)
        for rec in hops:
            ev = rec["event"]
            if ev == DISPATCHED:
                if open_span is not None:
                    shard, t0 = open_span
                    gantt[shard].append((key, t0, rec["t"], "lost"))
                open_span = (rec.get("shard", ""), rec["t"])
            elif open_span is not None and (ev == PREEMPTED
                                            or ev in TERMINAL):
                shard, t0 = open_span
                gantt[shard].append((key, t0, rec["t"], ev))
                open_span = None
        if open_span is not None:
            shard, t0 = open_span
            gantt[shard].append((key, t0, hops[-1]["t"], "lost"))
    for spans in gantt.values():
        spans.sort(key=lambda s: s[1])
    return dict(gantt)


def summarize(timelines: dict) -> dict:
    """Run-level rollup for the CLI header."""
    outcomes = defaultdict(int)
    n_failover = 0
    for hops in timelines.values():
        events = [r["event"] for r in hops]
        n_failover += events.count(FAILOVER)
        terminal = next((e for e in reversed(events) if e in TERMINAL),
                        "open")
        outcomes[terminal] += 1
    return {"jobs": len(timelines), "outcomes": dict(outcomes),
            "failovers": n_failover}


def format_timeline(key: str, hops) -> str:
    lines = [f"job {key}"]
    t0 = hops[0]["t"] if hops else 0.0
    for rec in hops:
        slack = rec.get("slack")
        slack_s = f" slack={slack:+.3f}s" if slack is not None else ""
        shard = f" @{rec['shard']}" if rec.get("shard") else ""
        detail = rec.get("detail") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(detail.items()))
        lines.append(f"  +{rec['t'] - t0:8.3f}s {rec['event']:<10}"
                     f"{shard}{slack_s}{'  ' + extra if extra else ''}")
    return "\n".join(lines)


def format_gantt(gantt: dict) -> str:
    lines = []
    for shard in sorted(gantt):
        spans = gantt[shard]
        busy = sum(t1 - t0 for _, t0, t1, _ in spans)
        lines.append(f"shard {shard or '?'}: {len(spans)} spans, "
                     f"{busy:.3f}s busy")
        for job, t0, t1, outcome in spans:
            lines.append(f"  {job}  {t1 - t0:8.3f}s  → {outcome}")
    return "\n".join(lines) or "(no dispatch spans)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service.observability.replay",
        description="reconstruct per-job timelines and per-shard gantt "
                    "summaries from a trace_dir")
    ap.add_argument("trace_dir")
    ap.add_argument("--job", help="print the full timeline of one job key")
    ap.add_argument("--gantt", action="store_true",
                    help="print per-shard dispatch spans")
    args = ap.parse_args(argv)

    timelines = reassemble(load_events(args.trace_dir))
    summary = summarize(timelines)
    print(f"{summary['jobs']} jobs, outcomes {summary['outcomes']}, "
          f"{summary['failovers']} failovers")
    if args.job:
        print(format_timeline(args.job, job_timeline(timelines, args.job)))
    elif args.gantt:
        print(format_gantt(shard_gantt(timelines)))
    else:
        for key in sorted(timelines):
            hops = timelines[key]
            path = "→".join(r["event"] for r in hops)
            print(f"  {key}: {path}")
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # e.g. `... | head`
        raise SystemExit(0)
