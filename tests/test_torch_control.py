"""The port's closed-loop controller (``repro_torch.service.control``)
against ``repro.service.control``: the counterpart of
``tests/test_control.py``, its autoscaler cases included.

Each script feeds the windowed collector on a scripted clock and ticks the
controller; after every tick it records what the controller did and what
the queue's knobs read (admission limits, band gates, the INTERACTIVE
reserve, the WFQ weights, the controller's counters).  The same script
on both packages must leave the same record.  The actuations' RETUNED hops,
the snapshot and its ``top`` row, and the service's control block are held
to the reference's too.  The proc fabric's autoscaler, ticked by hand on
a fake fabric fed scripted windows, spawns exactly where the reference's
does: on a sustained windowed attainment sag, never on a single bad
window, and not once a window without SLO evidence has reset the trend.
"""

import json
import pickle
from types import SimpleNamespace

import pytest

import repro.service as JS
import repro_torch.service as S
from repro.service.observability import replay as j_replay
from repro_torch.service.control.controller import CONTROL_TRACE_KEY
from repro_torch.service.observability import RETUNED, replay, top

class FakeClock:
    def __init__(self, t0=1000.0):
        self.t = t0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _rig(m, policy, **queue_kw):
    clk = FakeClock()
    queue_kw.setdefault("max_queued_total", 128)
    queue = m.FairQueue(**queue_kw)
    windows = m.ThroughputCollector(window_s=1.0, n_windows=8, clock=clk)
    ctl = m.ServiceController(policy, queue, windows, clock=clk)
    return SimpleNamespace(m=m, clk=clk, pol=policy, queue=queue,
                           windows=windows, ctl=ctl)


def _state(r, acted):
    q, c = r.queue, r.ctl
    return (acted, q.max_queued_total, q.max_queued_per_tenant,
            dict(q.band_limits), q.reserve_interactive,
            {int(k): v for k, v in q.weights.items()},
            (c.retunes, c.admission_shrinks, c.admission_regrows,
             c.weight_boosts, c.weight_decays))


def _breach(r, n=None):
    for _ in range(n or r.pol.min_window_jobs):
        r.windows.record_dispatch(r.pol.dispatch_p99_target_s * 5,
                                  queue_depth=50)


def _ticks(r, n, dt=1.0, feed=None):
    out = []
    for _ in range(n):
        if feed is not None:
            feed(r)
        out.append(_state(r, r.ctl.maybe_tick()))
        r.clk.advance(dt)
    return out


def _script_shrink_cooldown(m):
    r = _rig(m, m.ControlPolicy(tick_interval_s=1.0, cooldown_s=10.0,
                                dispatch_p99_target_s=0.1))
    out = _ticks(r, 3, dt=1.0, feed=_breach)
    r.clk.advance(10.0)
    out += _ticks(r, 1, feed=_breach)
    assert out[-1][6][1] == 2 and out[-1][1] == 32
    return out


def _script_tick_interval(m):
    r = _rig(m, m.ControlPolicy(tick_interval_s=5.0))
    out = [r.ctl.maybe_tick(), r.ctl.maybe_tick()]
    r.clk.advance(4.9)
    out.append(r.ctl.maybe_tick())
    r.clk.advance(0.2)
    out.append(r.ctl.maybe_tick())
    assert out == [True, False, False, True]
    return out


def _script_floor(m):
    r = _rig(m, m.ControlPolicy(tick_interval_s=1.0, cooldown_s=0.0,
                                dispatch_p99_target_s=0.1,
                                min_queued_total=8))
    out = _ticks(r, 31, feed=_breach)
    assert out[-1][1] == 8
    return out


def _script_weight_cap(m):
    P = m.Priority
    r = _rig(m, m.ControlPolicy(tick_interval_s=1.0, cooldown_s=0.0,
                                weight_gain=2.0, max_weight_factor=8.0))
    out = _ticks(r, 11, feed=lambda r: r.windows.record_deadline_outcome(
        False, band=int(P.SCAVENGER)))
    assert out[-1][5][int(P.SCAVENGER)] == \
        m.DEFAULT_WEIGHTS[P.SCAVENGER] * 8.0
    return out


def _script_regrow(m):
    r = _rig(m, m.ControlPolicy(tick_interval_s=1.0, cooldown_s=0.0,
                                dispatch_p99_target_s=0.5,
                                admission_increase=16))
    out = _ticks(r, 1, feed=_breach)
    r.clk.advance(20.0)
    out += _ticks(r, 8)
    assert [s[1] for s in out[1:]] == [80, 96, 112, 128, 128, 128, 128, 128]
    assert out[-1][3] == {}
    return out


def _script_weight_decay(m):
    r = _rig(m, m.ControlPolicy(tick_interval_s=1.0, cooldown_s=0.0))
    base = {int(k): float(v) for k, v in r.queue.weights.items()}
    out = _ticks(r, 1, feed=lambda r: r.windows.record_deadline_outcome(
        False, band=int(m.Priority.BATCH)))
    r.clk.advance(20.0)
    out += _ticks(r, 20)
    assert out[-1][5] == base
    return out + [r.ctl.snapshot()["weights"]["factors"]]


def _script_idle(m):
    r = _rig(m, m.ControlPolicy(tick_interval_s=1.0))
    out = _ticks(r, 50)
    assert out[-1][6][0] == 0
    return out


def _script_thin_window(m):
    r = _rig(m, m.ControlPolicy(tick_interval_s=1.0, min_window_jobs=4))
    for _ in range(3):
        r.windows.record_dispatch(100.0)
    return _ticks(r, 2)


def _script_reserve(m):
    """The INTERACTIVE reserve admits probes past a full queue, never past
    a tenant quota; band gates refuse bulk only."""
    P = m.Priority
    r = _rig(m, m.ControlPolicy(interactive_reserve=4),
             max_queued_total=16, max_queued_per_tenant=6, aging_s=None)
    trail = []

    def push(i, tenant, prio=P.BATCH):
        job = m.Job(id=i, tenant=tenant, batch=None,
                    future=m.PipelineFuture(i, tenant, prio), priority=prio)
        try:
            r.queue.push(job)
            trail.append(("ok", i))
        except m.AdmissionError as e:
            trail.append(("refused", i, str(e)))

    for i in range(16):
        push(i, f"bulk{i % 3}")
    push(100, "bulk0")
    for i in range(7):
        push(200 + i, "probe", P.INTERACTIVE)
    trail.append([j.id for j in r.queue.pop_round(max_jobs=4,
                                                  max_per_tenant=4)])
    push(301, "probe", P.INTERACTIVE)
    r.queue.set_limits(band_limits={int(P.BATCH): 2})
    push(400, "late")
    return trail


SCRIPTS = {f.__name__[len("_script_"):]: f for f in (
    _script_shrink_cooldown, _script_tick_interval, _script_floor,
    _script_weight_cap, _script_regrow, _script_weight_decay, _script_idle,
    _script_thin_window, _script_reserve)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_controller_acts_as_the_reference_does(name):
    assert SCRIPTS[name](S) == SCRIPTS[name](JS)


def test_policy_validation_and_pickling_equal_the_references():
    for bad in (dict(admission_decrease=1.5), dict(tick_interval_s=0),
                dict(weight_gain=0.5),
                dict(max_weight_factor=1.5, weight_gain=2.0)):
        with pytest.raises(ValueError):
            S.ControlPolicy(**bad)
        with pytest.raises(ValueError):
            JS.ControlPolicy(**bad)
    p = S.ControlPolicy(dispatch_p99_target_s=0.25, interactive_reserve=4)
    assert pickle.loads(pickle.dumps(p)) == p
    assert vars(p) == vars(JS.ControlPolicy(dispatch_p99_target_s=0.25,
                                            interactive_reserve=4))


def _retuned_log(m, rp, directory):
    clk = FakeClock()
    pol = m.ControlPolicy(tick_interval_s=1.0, cooldown_s=0.0,
                          dispatch_p99_target_s=0.1)
    windows = m.ThroughputCollector(window_s=1.0, n_windows=8, clock=clk)
    sink = m.TraceSink(trace_dir=directory, component="ctl-test",
                       enabled=True)
    ctl = m.ServiceController(pol, m.FairQueue(max_queued_total=128),
                              windows, trace_sink=sink, shard_id="s0",
                              clock=clk)
    for _ in range(pol.min_window_jobs):
        windows.record_dispatch(0.5, queue_depth=50)
    ctl.maybe_tick()
    windows.record_deadline_outcome(False, band=int(m.Priority.BATCH))
    clk.advance(1.0)
    ctl.maybe_tick()
    sink.close()
    recs = rp.load_events(directory)
    return ([(r["job"], r["event"], r["shard"], r["detail"]["knob"])
             for r in recs], ctl.snapshot())


def test_actuations_emit_the_references_retuned_hops(tmp_path):
    port, port_snap = _retuned_log(S, replay, str(tmp_path / "port"))
    ref, ref_snap = _retuned_log(JS, j_replay, str(tmp_path / "ref"))
    assert port == ref
    assert {k for *_, k in port} == {"admission", "weights"}
    assert all(j == CONTROL_TRACE_KEY and e == RETUNED and s == "s0"
               for j, e, s, _ in port)
    # the snapshots agree but for the actions' wall-clock stamps
    for snap in (port_snap, ref_snap):
        for action in snap["last_actions"]:
            action.pop("t", None)
    assert port_snap == ref_snap


def test_snapshot_merge_and_top_row_equal_the_references():
    def snap(m):
        r = _rig(m, m.ControlPolicy(tick_interval_s=1.0, cooldown_s=0.0,
                                    dispatch_p99_target_s=0.1))
        _breach(r)
        r.ctl.maybe_tick()
        s = r.ctl.snapshot()
        for action in s["last_actions"]:
            action["t"] = 0.0
        return s

    port, ref = snap(S), snap(JS)
    assert port == ref
    assert port["admission"]["gated"] and \
        port["admission"]["max_queued_total"] == 64
    merged = S.merge_control_snapshots([port, port])
    assert merged == JS.merge_control_snapshots([ref, ref])
    assert merged["retunes"] == 2 and merged["gated_shards"] == 2
    frame = top.render({"jobs_submitted": 1, "control": port})
    assert "control:" in frame and "GATED" in frame
    assert "shards gated" in top.render({"control": merged})


@pytest.mark.parametrize("control", [True, False])
def test_service_control_block_equals_the_references(control):
    blocks = []
    for m, kw in ((S, {"device": "cpu"}), (JS, {})):
        svc = m.StratumService(
            memory_budget_bytes=1 << 28, autostart=False,
            control=m.ControlPolicy() if control else None, **kw)
        try:
            g = svc.telemetry.global_snapshot()
            blocks.append((svc.controller is None, g.get("control"),
                           svc.queue.reserve_interactive))
        finally:
            svc.stop(drain=False)
    assert blocks[0] == blocks[1]
    if control:
        assert blocks[0][1]["admission"]["configured_max_queued_total"] \
            == 1024
    else:
        assert blocks[0] == (True, None, 0)
    json.dumps(blocks[0][1])


# ---------------------------------------------------------------------------
# the proc fabric's autoscaler: windowed attainment trend, not whipsaw
# ---------------------------------------------------------------------------

class _FakeFabric:
    """Just enough fabric surface for ``Autoscaler._tick``."""

    def __init__(self, windows_seq):
        self._windows_seq = list(windows_seq)
        self.added = []
        self.router = SimpleNamespace(pending_count=lambda *a: 3)
        self.telemetry = self

    def shard_ids(self):
        return ["s0"]

    def shards(self):
        return {}

    def global_snapshot(self):
        return {"windows": (self._windows_seq.pop(0) if self._windows_seq
                            else {"deadline_jobs": 0})}

    def add_shard(self, sid):
        self.added.append(sid)

    def newest_shard(self):
        return None


def _autoscale_spawns(pkg, windows, ticks, trend_len=3):
    """The spawns of ``pkg``'s autoscaler after ``ticks`` hand ticks."""
    if pkg == "port":
        from repro_torch.service.fabric.proc.autoscale import (
            Autoscaler, AutoscalePolicy)
    else:
        from repro.service.fabric.proc.autoscale import (Autoscaler,
                                                         AutoscalePolicy)
    fab = _FakeFabric(windows)
    scaler = Autoscaler(fab, AutoscalePolicy(
        min_shards=1, max_shards=4, scale_up_backlog_per_shard=100.0,
        attainment_floor=0.9, attainment_trend_len=trend_len,
        scale_up_cooldown_s=0.0))           # never start()ed
    out = []
    for _ in range(ticks):
        scaler._tick()
        out.append(list(fab.added))
    return out


SAG = {"deadline_jobs": 5, "attainment": 0.5}
GOOD = {"deadline_jobs": 5, "attainment": 1.0}
BAD = {"deadline_jobs": 5, "attainment": 0.2}
IDLE = {"deadline_jobs": 0}


def test_autoscaler_needs_a_sustained_windowed_sag():
    port = _autoscale_spawns("port", [SAG] * 4, 4)
    assert port == _autoscale_spawns("ref", [SAG] * 4, 4)
    # two sags set no trend; the third spawns; the trend restarts after
    assert port == [[], [], ["auto-1"], ["auto-1"]]


def test_autoscaler_ignores_single_window_whipsaw():
    seq = [GOOD, BAD] * 3
    port = _autoscale_spawns("port", seq, 6)
    assert port == _autoscale_spawns("ref", seq, 6)
    assert port[-1] == []


def test_autoscaler_trend_clears_without_slo_evidence():
    seq = [SAG, SAG, IDLE, SAG]
    port = _autoscale_spawns("port", seq, 4)
    assert port == _autoscale_spawns("ref", seq, 4)
    assert port[-1] == []            # the idle window reset the trend
