"""The port's observability layer (``repro_torch.service.observability``)
against ``repro.service.observability``: the counterpart of
``tests/test_observability.py``, its fabric cases included.

* Hop tuples, ``JobTrace`` stamps, the JSONL ``TraceLog`` / ``TraceSink``
  and the windowed ``ThroughputCollector`` (on a scripted clock) give the
  same values on both packages for the same calls.
* ``replay`` gives the same timelines, gantt, summary and CLI text for the
  same event log, and ``top.render`` the same text for the same snapshot.
* The port's service stamps the reference's hop sequences: a lifecycle,
  a coalesced pair, a cancel, a shed, a failure and a preemption chain;
  its JSONL log replays to the reported trace.
* A killed worker's open span closes as ``lost`` in the gantt view.  On
  the fabric, the hop log crosses the wire codec, the client and shard
  hops reassemble into the reference's sequence, an untraced report has
  none, a failover keeps the trace continuous, and a drained shard's
  windows stay in the fabric's snapshot.

Services run on the CPU with compiled segments off; every wait has a
timeout and the preemption waits on an event.
"""

import json
import threading
import time
from collections import Counter

import pytest

import repro.service as JS
import repro.service.observability as JO
import repro.tabular as JT
import repro_torch.service as S
import repro_torch.service.observability as O
import repro_torch.tabular as T
from repro.core import LazyOp as JLazyOp
from repro.core import PipelineBatch as JBatch
from repro.service.observability import replay as j_replay
from repro.service.observability import top as j_top
from repro_torch.core import GENERIC, LazyOp, PipelineBatch
from repro_torch.service.observability import replay, top
from repro_torch.service.observability.events import COMPLETED_RING, TraceLog

TIMEOUT = 120
PKG = {"ref": JO, "port": O}


def _events(hops):
    return [h[0] for h in hops]


def _assert_monotone(hops):
    ts = [h[1] for h in hops]
    assert ts == sorted(ts), ts


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# hops and traces
# ---------------------------------------------------------------------------

def test_event_constants_equal_the_references():
    assert O.EVENTS == JO.EVENTS and O.TERMINAL == JO.TERMINAL
    assert len(set(O.EVENTS)) == len(O.EVENTS)
    assert O.MAX_SAMPLES == JO.MAX_SAMPLES


@pytest.mark.parametrize("args,kw", [
    (("dispatched",), dict(shard="shard-1", slack=1.5, t=100.0,
                           wait_s=0.25, resume=False)),
    (("queued",), dict(t=3.0)),
    (("completed",), dict(shard="s", slack=-0.5, t=7.0,
                          backends={"torch-seg": 4}, deadline_met=True)),
])
def test_hops_and_records_equal_the_references(args, kw):
    hop = O.make_hop(*args, **kw)
    assert hop == JO.make_hop(*args, **kw)
    rec = O.hop_record("e-1", "agent-0", hop)
    assert rec == JO.hop_record("e-1", "agent-0", hop)
    assert O.record_hop(json.loads(json.dumps(rec))) == hop


def test_jobtrace_stamps_monotone_and_terminal():
    future_t = time.time() + 120.0
    for pkg in (O, JO):
        tr = pkg.JobTrace("k", "t", hops=[pkg.make_hop(pkg.SUBMITTED,
                                                       t=future_t)])
        hop = tr.stamp(pkg.QUEUED, slack=3.0)
        assert hop[1] == future_t and hop[0] == pkg.QUEUED
        assert tr.terminal is None and len(tr) == 2
        tr.stamp(pkg.COMPLETED, shard="s0")
        assert tr.terminal == pkg.COMPLETED
        assert tr.as_hops() == tuple(tr.hops)
        _assert_monotone(tr.hops)


def test_percentile_equals_the_references():
    for xs, q in (([], 99), (list(range(1, 101)), 50), ([7.0], 99),
                  ([3.0, 1.0, 2.0], 50), (list(range(1, 101)), 100)):
        assert O.percentile(xs, q) == JO.percentile(xs, q)


# ---------------------------------------------------------------------------
# the windowed collector on a scripted clock
# ---------------------------------------------------------------------------

def _feed_counts(c, clk):
    for _ in range(6):
        c.record_submit()
    c.record_completion(4)
    for met in (True, True, False):
        c.record_deadline_outcome(met)


def _feed_rollover(c, clk):
    c.record_completion(2)
    clk.t = 1.1
    c.record_completion(3)
    clk.t = 2.2


def _feed_ring(c, clk):
    for i in range(20):
        clk.t = float(i)
        c.record_completion()


def _feed_idle_gap(c, clk):
    c.record_completion(5)
    clk.t = 1e9
    c.snapshot()
    c.record_completion()


def _feed_latencies(c, clk):
    for ms in range(1, 101):
        c.record_dispatch(ms / 1000.0, queue_depth=ms % 9)
    for _ in range(O.MAX_SAMPLES + 50):
        c.record_dispatch(0.001)


def _feed_bands(c, clk):
    c.record_deadline_outcome(True, band=0)
    c.record_deadline_outcome(False, band=1)
    c.record_deadline_outcome(False, band=1)
    c.record_shed()
    c.record_preemption(2)


FEEDS = {f.__name__[len("_feed_"):]: f for f in (
    _feed_counts, _feed_rollover, _feed_ring, _feed_idle_gap,
    _feed_latencies, _feed_bands)}


def _collector_snapshot(pkg, feed, window_s=1.0, n_windows=4):
    clk = _Clock()
    c = PKG[pkg].ThroughputCollector(window_s=window_s, n_windows=n_windows,
                                     clock=clk)
    feed(c, clk)
    return c.snapshot()


@pytest.mark.parametrize("name", sorted(FEEDS))
def test_collector_snapshots_equal_the_references(name):
    port = _collector_snapshot("port", FEEDS[name])
    assert port == _collector_snapshot("ref", FEEDS[name])
    if name == "counts":
        assert (port["submitted"], port["completed"], port["deadline_jobs"],
                port["deadline_met"]) == (6, 4, 3, 2)


def test_window_and_tenant_merges_equal_the_references():
    snaps = {pkg: [_collector_snapshot(pkg, f) for f in
                   (_feed_counts, _feed_latencies, _feed_bands)]
             for pkg in PKG}
    merged = O.merge_window_snapshots(snaps["port"] + [None, {}])
    assert merged == JO.merge_window_snapshots(snaps["ref"] + [None, {}])
    assert O.merge_window_snapshots([None, {}]) is None
    shards = [{"t": {"jobs": 2, "wait_max_s": 0.5,
                     "per_backend": {"torch": 2}, "windows": snaps["port"][0]}},
              {"t": {"jobs": 3, "wait_max_s": 0.9,
                     "per_backend": {"torch": 1}, "windows": snaps["port"][1]}},
              {"u": {"jobs": 1, "wait_max_s": 0.1, "per_backend": {}}}]
    got = S.merge_tenant_snapshots(shards)
    assert got == JS.merge_tenant_snapshots(shards)
    assert got["t"]["jobs"] == 5 and got["t"]["per_backend"] == {"torch": 3}


# ---------------------------------------------------------------------------
# the JSONL log, the sink, replay and top
# ---------------------------------------------------------------------------

def test_tracelog_and_sink_lifecycle(tmp_path):
    log = TraceLog(str(tmp_path), "service")
    rec = O.hop_record("j1", "t", O.make_hop(O.SUBMITTED, t=1.0))
    log.append(rec)
    lines = open(log.path, encoding="utf-8").read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["event"] == O.SUBMITTED
    log.close()
    log.append(rec)                      # after close: dropped, no raise
    log.close()
    off = O.TraceSink()
    assert off.enabled is False and off.begin("k", "t") is None
    sink = O.TraceSink(enabled=True)
    for i in range(COMPLETED_RING + 5):
        tr = sink.begin(f"k{i}", "t")
        tr.stamp(O.COMPLETED)
        sink.finish(tr)
    assert sink.get("k0") is None and len(sink.recent(5)) == 5
    assert sink.recent(1)[0].key == f"k{COMPLETED_RING + 4}"


def _write_log(pkg, directory):
    """The same hops through each package's sink: a completed job, a
    failed one, a preempted and resumed one, one left open."""
    m = PKG[pkg]
    sink = m.TraceSink(trace_dir=directory, component=f"service-{pkg}")
    hops = {
        "ja": [m.make_hop(m.SUBMITTED, t=1.0, slack=5.0),
               m.make_hop(m.DISPATCHED, shard="s0", t=2.0, slack=4.0,
                          wait_s=1.0),
               m.make_hop(m.COMPLETED, shard="s0", t=3.0, slack=3.0,
                          backends={"torch": 2})],
        "jb": [m.make_hop(m.SUBMITTED, t=1.5),
               m.make_hop(m.FAILED, shard="s0", t=2.5, reason="boom")],
        "jc": [m.make_hop(m.DISPATCHED, shard="s1", t=1.0),
               m.make_hop(m.PREEMPTED, shard="s1", t=2.0, salvaged=3),
               m.make_hop(m.DISPATCHED, shard="s1", t=4.0),
               m.make_hop(m.COMPLETED, shard="s1", t=5.0)],
        "jd": [m.make_hop(m.DISPATCHED, shard="s2", t=1.0)],
    }
    for key, hs in hops.items():
        for hop in hs:
            sink.emit_hop(key, "t", hop)
    sink.close()
    return hops


def test_replay_equals_the_references_on_one_log(tmp_path, capsys):
    """Both packages write the same hops (a torn tail appended); both
    replays read the one directory and agree on every view."""
    d = str(tmp_path)
    hops = _write_log("port", d)
    _write_log("ref", str(tmp_path / "ref"))
    port_file = next(tmp_path.glob("events-service-port-*.jsonl"))
    ref_file = next((tmp_path / "ref").glob("events-service-ref-*.jsonl"))
    assert port_file.read_text() == ref_file.read_text()
    with open(port_file, "a", encoding="utf-8") as fh:
        fh.write('\n{"job": "ja", "event": "disp')          # torn tail
    views = {}
    for name, mod in (("port", replay), ("ref", j_replay)):
        recs = mod.load_events(d)
        tl = mod.reassemble(recs)
        views[name] = (recs, tl, mod.shard_gantt(tl), mod.summarize(tl),
                       mod.job_timeline(tl, "nope"))
        text = []
        for argv in ([d], [d, "--job", "jc"], [d, "--gantt"]):
            assert mod.main(argv) == 0
            text.append(capsys.readouterr().out)
        views[name] += (text,)
    assert views["port"] == views["ref"]
    recs, tl, gantt, summary, _, text = views["port"]
    assert [O.record_hop(r) for r in tl["ja"]] == hops["ja"]
    assert summary == {"jobs": 4, "outcomes": {O.COMPLETED: 2, O.FAILED: 1,
                                               "open": 1}, "failovers": 0}
    assert gantt["s1"] == [("jc", 1.0, 2.0, O.PREEMPTED),
                           ("jc", 4.0, 5.0, O.COMPLETED)]
    assert gantt["s2"] == [("jd", 1.0, 1.0, "lost")]
    assert "submitted→dispatched→completed" in text[0]


def _control_snapshot():
    clk = _Clock()
    pol = S.ControlPolicy(tick_interval_s=1.0, cooldown_s=0.0,
                          dispatch_p99_target_s=0.1)
    w = S.ThroughputCollector(window_s=1.0, n_windows=8, clock=clk)
    ctl = S.ServiceController(pol, S.FairQueue(max_queued_total=128), w,
                              clock=clk)
    for _ in range(pol.min_window_jobs):
        w.record_dispatch(0.5, queue_depth=50)
    ctl.maybe_tick()
    return ctl.snapshot()


def _service_snapshot():
    svc = S.StratumService(memory_budget_bytes=1 << 30, device="cpu",
                           compiled_segments=False, n_executors=1,
                           coalesce_window_s=0.0)
    try:
        svc.session("t").submit(_batch(), deadline_s=300.0).result(
            timeout=TIMEOUT)
        return svc.telemetry.global_snapshot()
    finally:
        svc.stop()


@pytest.mark.parametrize("which", ["demo", "empty", "control", "service"])
def test_top_renders_the_references_text(which):
    snap = {"demo": top.demo_snapshot, "empty": dict,
            "control": lambda: {"jobs_submitted": 1,
                                "control": _control_snapshot()},
            "service": _service_snapshot}[which]()
    if which == "demo":
        assert snap == j_top.demo_snapshot()
    frame = top.render(snap)
    assert frame == j_top.render(snap) != ""
    if which == "control":
        assert "control:" in frame and "GATED" in frame


# ---------------------------------------------------------------------------
# the port's service stamps the reference's hops
# ---------------------------------------------------------------------------

def _pipeline(tab, n_rows=1000, cols=(10, 11, 12)):
    x = tab.read("uk_housing", n_rows, seed=0)
    xs = tab.scale(tab.impute(tab.project(x, list(cols))))
    return tab.metric(tab.project(xs, [0]), tab.project(x, [0]), kind="mae")


def _batch(name="p", **kw):
    return PipelineBatch([_pipeline(T, **kw)], [name])


def _svc(pkg, **kw):
    kw.setdefault("memory_budget_bytes", 1 << 30)
    kw.setdefault("n_executors", 1)
    kw.setdefault("coalesce_window_s", 0.0)
    kw.setdefault("compiled_segments", False)
    if pkg == "port":
        return S.StratumService(device="cpu", **kw)
    return JS.StratumService(**kw)


def _scenario(pkg, name):
    """Hop events of one deterministic scenario on one package."""
    tab, Batch, Lazy = ((T, PipelineBatch, LazyOp) if pkg == "port"
                        else (JT, JBatch, JLazyOp))

    def batch(bname="p", **kw):
        return Batch([_pipeline(tab, **kw)], [bname])

    svc = _svc(pkg, trace=True, autostart=False)
    try:
        if name == "lifecycle":
            fut = svc.session("t").submit(batch(), deadline_s=300.0)
            svc.start()
            _, rep = fut.result(timeout=TIMEOUT)
            assert rep.trace[-1][4]["deadline_met"] is True
            assert all(h[3] is not None and 0 < h[3] <= 300.0
                       for h in rep.trace)
            return [_events(rep.trace)]
        if name == "coalesced":
            futs = [svc.session("a").submit(batch()),
                    svc.session("b").submit(batch("q", cols=(10, 11, 13)))]
            svc.start()
            reps = [f.result(timeout=TIMEOUT)[1] for f in futs]
            return [(_events(r.trace), r.coalesced_with,
                     next(h[4]["n_jobs"] for h in r.trace
                          if h[0] == "coalesced")) for r in reps]
        if name == "cancelled":
            fut = svc.session("t").submit(batch())
            assert fut.cancel()
            return [_events(svc.traces.get(f"j{fut.job_id}").hops)]
        if name == "shed":
            svc.start()
            fut = svc.session("t").submit(batch(), deadline_s=1e-9)
            with pytest.raises(Exception) as ei:
                fut.result(timeout=TIMEOUT)
            tr = svc.traces.get(f"j{fut.job_id}")
            w = svc.telemetry.global_snapshot()["windows"]
            return [type(ei.value).__name__, _events(tr.hops),
                    w["shed"] >= 1]
        if name == "failed":
            def _boom(*_a, **_k):
                raise ValueError("poisoned op")
            bad = Lazy("boom_obs", GENERIC, spec={"fn": _boom},
                       inputs=(tab.read("uk_housing", 1000, seed=0),)).out()
            svc.start()
            fut = svc.session("t").submit(Batch([bad], ["bad"]))
            with pytest.raises(Exception):
                fut.result(timeout=TIMEOUT)
            tr = svc.traces.get(f"j{fut.job_id}")
            return [_events(tr.hops), tr.hops[-1][4]["error"]]
    finally:
        svc.stop()
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["lifecycle", "coalesced", "cancelled",
                                  "shed", "failed"])
def test_service_hops_equal_the_references(name):
    port = _scenario("port", name)
    assert port == _scenario("ref", name)
    assert port[0] != []


def test_trace_dir_jsonl_replays_to_the_reported_trace(tmp_path):
    svc = _svc("port", trace=True, trace_dir=str(tmp_path))
    try:
        fut = svc.session("t").submit(_batch())
        _, rep = fut.result(timeout=TIMEOUT)
    finally:
        svc.stop()
    timelines = replay.reassemble(replay.load_events(str(tmp_path)))
    assert tuple(O.record_hop(r) for r in timelines[f"j{fut.job_id}"]) == \
        rep.trace
    assert rep.trace[-1][0] == O.COMPLETED


_STARTED = threading.Event()


def _slow_identity(x, delay=0.05, mark=False):
    if mark:
        _STARTED.set()
    time.sleep(delay)
    return x


def test_preempted_job_trace_has_one_preempt_requeue_chain():
    _STARTED.clear()
    svc = _svc("port", trace=True, aging_s=None, autostart=False)
    try:
        tag = f"obs{time.monotonic_ns()}"
        ref = T.project(T.read("uk_housing", 1000, seed=0), [0])
        for d in range(8):
            ref = LazyOp(f"slow_{tag}_{d}", GENERIC,
                         spec={"fn": _slow_identity,
                               "kwargs": {"delay": 0.05, "mark": d == 2}},
                         inputs=(ref,)).out()
        chain = svc.session("bulk").submit(PipelineBatch([ref], ["chain"]),
                                           priority=S.Priority.SCAVENGER)
        svc.start()
        assert _STARTED.wait(TIMEOUT)        # the third wave is running
        svc.session("probe").submit(
            _batch(), priority=S.Priority.INTERACTIVE).result(timeout=TIMEOUT)
        _, rep = chain.result(timeout=TIMEOUT)
        ev = _events(rep.trace)
        assert rep.preemptions == 1
        assert ev == [O.SUBMITTED, O.ADMITTED, O.QUEUED, O.DISPATCHED,
                      O.PREEMPTED, O.REQUEUED, O.DISPATCHED, O.COMPLETED], ev
        _assert_monotone(rep.trace)
        assert Counter(ev)[O.DISPATCHED] == 2
        first, second = [h for h in rep.trace if h[0] == O.DISPATCHED]
        assert (first[4]["resume"], second[4]["resume"]) == (False, True)
        assert second[4]["wait_s"] == first[4]["wait_s"]
        assert next(h for h in rep.trace
                    if h[0] == O.PREEMPTED)[4]["salvaged"] > 0
        assert rep.trace[-1][4]["salvaged"] == rep.ops_salvaged > 0
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# the fabric: hops across the wire, failover, retired shards
# ---------------------------------------------------------------------------

def _fabric(pkg, n_shards=2, **kw):
    from repro.service.fabric import ShardedStratum as JShardedStratum
    from repro_torch.service.fabric import ShardedStratum
    kw.setdefault("memory_budget_bytes", 1 << 30)
    kw.setdefault("n_executors", 1)
    kw.setdefault("coalesce_window_s", 0.0)
    kw.setdefault("compiled_segments", False)
    if pkg == "port":
        return ShardedStratum(n_shards=n_shards, device="cpu", **kw)
    return JShardedStratum(n_shards=n_shards, **kw)


def _key_for_shard(fab, shard_id, tag="k"):
    for i in range(10_000):
        key = f"{tag}-{i}"
        if fab.router._ring.route(key) == shard_id:
            return key
    raise AssertionError("no key found")  # pragma: no cover


def _assert_slack_non_increasing(hops, eps=0.25):
    slacks = [h[3] for h in hops if h[3] is not None]
    for a, b in zip(slacks, slacks[1:]):
        assert b <= a + eps, slacks


def test_shard_gantt_spans_preemption_and_lost_workers():
    """A preempted job's two spans, and the open span of a job whose
    worker was killed closed as ``lost``: equal on both packages."""
    views = []
    for m, mod in ((O, replay), (JO, j_replay)):
        timelines = mod.reassemble([
            m.hop_record("j1", "t", h) for h in (
                m.make_hop(m.DISPATCHED, shard="s0", t=1.0),
                m.make_hop(m.PREEMPTED, shard="s0", t=2.0),
                m.make_hop(m.DISPATCHED, shard="s0", t=4.0),
                m.make_hop(m.COMPLETED, shard="s0", t=5.0))
        ] + [m.hop_record("j2", "t", m.make_hop(m.DISPATCHED, shard="s1",
                                                t=1.0))])
        views.append(mod.shard_gantt(timelines))
    assert views[0] == views[1]
    assert [(j, t0, t1, o) for j, t0, t1, o in views[0]["s0"]] == \
        [("j1", 1.0, 2.0, O.PREEMPTED), ("j1", 4.0, 5.0, O.COMPLETED)]
    assert views[0]["s1"] == [("j2", 1.0, 1.0, "lost")]


def test_envelope_hops_survive_the_wire_codec():
    from repro_torch.service.fabric import JobEnvelope, decode_job, encode_job
    hops = (O.make_hop(O.SUBMITTED, t=1.0, slack=9.0, tenant="t"),
            O.make_hop(O.ROUTED, shard="shard-1", t=1.5, slack=8.5,
                       attempt=0, requeue=False))
    env = JobEnvelope(envelope_id="e-7", tenant="t", priority=1,
                      routing_key="k", batch=_batch(), deadline_s=9.0,
                      hops=hops)
    out = decode_job(encode_job(env))
    assert out.hops == hops
    bare = decode_job(encode_job(JobEnvelope(
        envelope_id="e-8", tenant="t", priority=1, routing_key="k",
        batch=_batch())))
    assert bare.hops == ()


def _fabric_trace(pkg):
    tab, Batch = (T, PipelineBatch) if pkg == "port" else (JT, JBatch)
    fab = _fabric(pkg, trace=True)
    try:
        _, rep = fab.session("t").submit(
            Batch([_pipeline(tab)], ["p"]), deadline_s=300.0).result(
            timeout=TIMEOUT)
        tr = fab.traces.get(rep.envelope_id)
        return rep, tr
    finally:
        fab.stop()


def test_fabric_trace_reassembles_client_and_shard_hops():
    rep, tr = _fabric_trace("port")
    ev = _events(rep.hops)
    assert ev == [O.SUBMITTED, O.ROUTED, O.ADMITTED, O.QUEUED, O.DISPATCHED,
                  O.COMPLETED], ev
    _assert_monotone(rep.hops)
    _assert_slack_non_increasing(rep.hops)
    assert rep.hops[1][2] == rep.shard_id
    assert rep.hops[-1][2] == rep.shard_id
    assert tr is not None and tr.as_hops() == rep.hops
    j_rep, _ = _fabric_trace("ref")
    assert _events(j_rep.hops) == ev
    assert j_rep.shard_id == rep.shard_id


def test_fabric_untraced_reports_have_no_hops():
    fab = _fabric("port")
    try:
        _, rep = fab.session("t").submit(_batch()).result(timeout=TIMEOUT)
        assert rep.hops == ()
        assert fab.traces.enabled is False
    finally:
        fab.stop()


def _failover_events(pkg):
    tab, Batch = (T, PipelineBatch) if pkg == "port" else (JT, JBatch)
    fab = _fabric(pkg, autostart=False, trace=True)
    try:
        victim, survivor = fab.shard_ids()
        fut = fab.session("t").submit(
            Batch([_pipeline(tab)], ["p"]), deadline_s=300.0,
            affinity=_key_for_shard(fab, victim))
        assert fab.router.pending_count(victim) == 1
        assert fab.fail_shard(victim) == 1
        fab.start()
        _, rep = fut.result(timeout=TIMEOUT)
        return victim, survivor, rep
    finally:
        fab.stop()


def test_failover_trace_continuity_under_fail_shard():
    victim, survivor, rep = _failover_events("port")
    assert rep.shard_id == survivor
    ev = _events(rep.hops)
    assert ev[:2] == [O.SUBMITTED, O.ROUTED]
    fo = ev.index(O.FAILOVER)
    assert ev[fo + 1:] == [O.ROUTED, O.ADMITTED, O.QUEUED, O.DISPATCHED,
                           O.COMPLETED], ev
    assert rep.hops[fo][2] == victim
    assert rep.hops[1][2] == victim
    assert rep.hops[fo + 1][2] == survivor
    assert rep.hops[-1][2] == survivor
    _assert_monotone(rep.hops)
    _assert_slack_non_increasing(rep.hops)
    j_victim, j_survivor, j_rep = _failover_events("ref")
    assert (j_victim, j_survivor) == (victim, survivor)
    assert _events(j_rep.hops) == ev


def test_retired_shard_freezes_its_windows_snapshot():
    fab = _fabric("port")
    try:
        victim = fab.shard_ids()[0]
        fab.session("t").submit(_batch(), affinity=_key_for_shard(
            fab, victim)).result(timeout=TIMEOUT)
        fab.drain_shard(victim)
        per = fab.telemetry.per_shard()
        assert per[victim]["retired"] is True
        assert per[victim]["windows"]["completed"] >= 1
        assert fab.telemetry.global_snapshot()["windows"]["completed"] >= 1
    finally:
        fab.stop()
