"""The port's out-of-process fabric under failure, shutdown and scaling:
the SIGKILL, hung-worker, graceful-stop, orphan, scale-down hand-off,
autoscaler and kill-mid-dispatch-trace cases of
``tests/test_proc_fabric.py``, on real worker processes on the CPU.

* ``kill -9`` of a worker mid-flood loses no job: every result equals the
  unkilled run's, deadlines shrink across the failover, and the fabric
  counts exactly one failed shard.
* A stopped (``SIGSTOP``) worker is found by its heartbeat timeout and
  failed over; a graceful stop exits every worker 0 and leaves none
  alive; a worker whose supervisor is gone exits non-zero.
* Scale-down ships the departing worker's hottest cache entries to its
  ring successor (within the hand-off's byte bound), and a resubmitted
  job hits them there.
* The autoscaler grows under a backlog built deterministically — jobs
  held by a file the test creates to release them — and drains back to
  its minimum once idle.
* A worker killed while it holds a dispatched job leaves a JSONL trace
  that replays to a failover and a completion on the survivor.

Every wait has its own timeout and every worker is reaped in a
``finally``; workers run with compiled segments off.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

import repro_torch.tabular as T
from _fabric_helpers import hold_until
from repro_torch.core import GENERIC, LazyOp, PipelineBatch
from repro_torch.service.fabric import ProcConfig, ProcStratumFabric
from repro_torch.service.fabric.proc import supervisor as t_supervisor
from repro_torch.service.fabric.proc import worker as t_worker
from repro_torch.service.fabric.proc.frames import (CONFIG, FrameDecoder,
                                                    HELLO, decode_control,
                                                    encode_control,
                                                    write_frame)
from repro_torch.service.server import ServiceConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")

N_ROWS = 1200
TIMEOUT = 300


def _pipeline(data_seed=0, cols=(10, 11, 12), kind="mae"):
    x = T.read("uk_housing", N_ROWS, seed=data_seed)
    xs = T.scale(T.impute(T.project(x, list(cols))))
    y = T.project(x, [0])
    return T.metric(T.project(xs, [0]), y, kind=kind)


def _batch(name="p", **kw):
    return PipelineBatch([_pipeline(**kw)], [name])


def _held_batch(release: str, data_seed=0):
    """A job that holds its executor until ``release`` exists."""
    held = LazyOp(f"hold_{data_seed}", GENERIC,
                  spec={"fn": hold_until, "kwargs": {"path": release}},
                  inputs=(_pipeline(data_seed=data_seed),)).out()
    return PipelineBatch([held], ["p"])


@pytest.fixture(scope="module", autouse=True)
def _datasets():
    from repro_torch.data.tabular import ensure_files
    for seed in range(16):
        ensure_files("uk_housing", N_ROWS, seed=seed)


@pytest.fixture
def helpers_on_worker_path(monkeypatch):
    """Workers find ``_fabric_helpers`` (the held jobs' function)."""
    monkeypatch.setenv("PYTHONPATH", TESTS + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))


def _proc_fabric(n_shards=2, proc=None, **kw):
    kw.setdefault("memory_budget_bytes", 1 << 30)
    kw.setdefault("n_executors", 1)
    kw.setdefault("coalesce_window_s", 0.0)
    kw.setdefault("compiled_segments", False)
    kw.setdefault("device", "cpu")
    proc = proc or ProcConfig(heartbeat_s=0.1, heartbeat_timeout_s=3.0,
                              reconnect_grace_s=0.5)
    return ProcStratumFabric(n_shards=n_shards, proc=proc, **kw)


def _key_for_shard(fab, shard_id, tag="k"):
    for i in range(10_000):
        key = f"{tag}-{i}"
        if fab.router._ring.route(key) == shard_id:
            return key
    raise AssertionError("no key found")  # pragma: no cover


def _wait_for(cond, timeout_s=60.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _recv(sock) -> bytes:
    """One read from a worker's socket (its own timeout); the worker
    closing it before the test has what it waits for fails the test."""
    chunk = sock.recv(1 << 16)
    assert chunk, "the worker closed its socket"
    return chunk


# ---------------------------------------------------------------------------
# crashes and hangs: zero jobs lost
# ---------------------------------------------------------------------------

def test_sigkill_mid_flood_loses_zero_jobs_and_keeps_deadlines(
        tmp_path, helpers_on_worker_path):
    """Each shard holds the flood's first job until the victim is dead,
    so the victim's jobs are in flight when it is killed."""
    release = str(tmp_path / "release")
    fab = _proc_fabric(n_shards=2)
    try:
        victim, survivor = fab.shard_ids()
        keys = {sid: [_key_for_shard(fab, sid, f"{sid}-{i}")
                      for i in range(5)] for sid in (victim, survivor)}
        sess = fab.session("agent-0")
        specs = [(sid, i) for i in range(5) for sid in (victim, survivor)]
        seeds = [i + (sid == victim) * 5 for sid, i in specs]
        futs = [sess.submit(_held_batch(release, data_seed=seed) if i == 0
                            else _batch(data_seed=seed),
                            deadline_s=300.0, affinity=keys[sid][i])
                for (sid, i), seed in zip(specs, seeds)]
        os.kill(fab.supervisor.live_workers()[victim], signal.SIGKILL)
        assert _wait_for(lambda: victim not in fab.shard_ids())
        open(release, "w").close()
        done = [f.result(timeout=TIMEOUT) for f in futs]
        assert len(done) == 10
        g = fab.telemetry.global_snapshot()
        assert g["shards_failed"] == 1
        assert len(fab.supervisor.failures) == 1
        assert g["failover_requeues"] == 5
        reports = [rep for _, rep in done]
        retried = [r for r in reports if r.attempt > 0]
        assert len(retried) == 5
        assert {r.shard_id for r in reports} == {survivor}
        for r in retried:
            assert r.deadline_s is not None and r.deadline_s < 300.0
        assert all(r.deadline_met for r in reports)
        got = [float(res["p"]) for res, _ in done]
    finally:
        open(release, "w").close()
        fab.stop()
    # the same flood on an unkilled fabric gives the same results
    ref = _proc_fabric(n_shards=2)
    try:
        sess = ref.session("agent-0")
        want = [float(sess.submit(_batch(data_seed=seed)).result(
            timeout=TIMEOUT)[0]["p"]) for seed in seeds]
    finally:
        ref.stop()
    assert got == want


def test_hung_worker_detected_by_heartbeat_timeout_and_failed_over():
    proc = ProcConfig(heartbeat_s=0.1, heartbeat_timeout_s=1.0,
                      reconnect_grace_s=0.5)
    fab = _proc_fabric(n_shards=2, proc=proc)
    try:
        sess = fab.session("agent-0")
        futs = [sess.submit(_batch(data_seed=s)) for s in range(6)]
        victim = fab.shard_ids()[-1]
        pid = fab.supervisor.live_workers()[victim]
        os.kill(pid, signal.SIGSTOP)
        try:
            for f in futs:
                f.result(timeout=TIMEOUT)
        finally:
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
        assert any(sid == victim for sid, _ in fab.supervisor.failures)
        assert victim not in fab.shard_ids()
        # the live worker's gap was measured; the hung one's ended by a kill
        stats = fab.supervisor.worker_stats()
        assert stats[victim]["max_beat_gap_s"] < 1.0 + 0.5
    finally:
        fab.stop()


def test_graceful_stop_exits_zero_and_leaves_no_orphans():
    fab = _proc_fabric(n_shards=2)
    try:
        sess = fab.session("t")
        for s in range(3):
            sess.submit(_batch(data_seed=s)).result(timeout=TIMEOUT)
        pids = dict(fab.supervisor.live_workers())
    finally:
        fab.stop()
    assert set(fab.supervisor.reaped) == set(pids)
    for sid, rc in fab.supervisor.reaped.items():
        assert rc == 0, f"worker {sid} exited {rc}, not a clean drain"
    for pid in pids.values():
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert fab.supervisor.failures == []
    stats = fab.supervisor.worker_stats()
    assert set(stats) == set(pids)
    assert all(s["ready_s"] is not None and s["ready_s"] >= s["hello_s"]
               for s in stats.values())


def test_worker_exits_nonzero_when_supervisor_is_gone():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", t_supervisor.WORKER_MODULE,
         "--port", str(port), "--shard-id", "s0"],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == t_worker.EXIT_NO_SUPERVISOR


def test_orphaned_worker_exits_when_its_supervisor_vanishes():
    """A worker that built its service loses its supervisor (the socket
    closes and nothing listens any more): it tries to reconnect for its
    window, then exits non-zero instead of lingering."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(60)
    port = listener.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-m", t_supervisor.WORKER_MODULE, "--port",
         str(port), "--shard-id", "s0"], env=env)
    try:
        sock, _ = listener.accept()
        sock.settimeout(60)
        dec, frames = FrameDecoder(), []
        while not frames:
            frames = dec.feed(_recv(sock))
        assert decode_control(frames[0])[0] == HELLO
        import pickle
        write_frame(sock, encode_control(CONFIG, {
            "service_config": pickle.dumps(ServiceConfig(
                device="cpu", compiled_segments=False)),
            "heartbeat_s": 0.05, "preload": ("repro_torch.tabular",)}))
        ready = False
        while not ready:
            for f in dec.feed(_recv(sock)):
                kind, payload = decode_control(f)
                ready = ready or bool(payload.get("ready"))
        sock.close()
        listener.close()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        listener.close()
    assert rc == t_worker.EXIT_NO_SUPERVISOR


# ---------------------------------------------------------------------------
# elasticity: warm hand-off, autoscaling
# ---------------------------------------------------------------------------

def test_handoff_keeps_entries_within_its_byte_bound():
    entries = [("a", b"x" * 10), ("b", b"x" * 100), ("c", b"x" * 30),
               ("d", b"x" * 5)]
    assert t_worker._within_bytes(entries, 50) == [
        ("a", b"x" * 10), ("c", b"x" * 30), ("d", b"x" * 5)]
    assert t_worker._within_bytes(entries, 4) == []


def test_scale_down_hands_hot_cache_to_ring_successor():
    fab = _proc_fabric(n_shards=2)
    try:
        sess = fab.session("t")
        victim = fab.newest_shard()
        victim_seeds = []
        for s in range(8):
            _, rep = sess.submit(_batch(data_seed=s)).result(
                timeout=TIMEOUT)
            if rep.shard_id == victim:
                victim_seeds.append(s)
        assert victim_seeds, "hash spread should hit both shards"
        fab.scale_down(victim)
        assert fab.supervisor.handoff_entries_shipped > 0
        assert victim not in fab.shard_ids()
        assert fab.supervisor.reaped[victim] == 0
        (successor,) = fab.shard_ids()
        # the successor's heartbeat reports the entries it took in
        assert _wait_for(lambda: fab.supervisor.worker_stats()[successor][
            "handoff_imported"] == fab.supervisor.handoff_entries_shipped)
        _, rep = sess.submit(
            _batch(data_seed=victim_seeds[0])).result(timeout=TIMEOUT)
        assert rep.shard_id != victim
        assert rep.cache_hits > 0
    finally:
        fab.stop()


def test_autoscaler_grows_under_backlog_and_drains_idle(
        tmp_path, helpers_on_worker_path):
    release = str(tmp_path / "release")
    fab = ProcStratumFabric(
        n_shards=1, memory_budget_bytes=1 << 30, n_executors=1,
        coalesce_window_s=0.0, compiled_segments=False, device="cpu",
        autoscale=(1, 2),
        proc=ProcConfig(heartbeat_s=0.1, heartbeat_timeout_s=3.0))
    try:
        fab.autoscaler.policy.scale_up_backlog_per_shard = 2.0
        fab.autoscaler.policy.scale_down_idle_s = 1.0
        sess = fab.session("t")
        # ten held jobs: the backlog stands until the test releases it
        futs = [sess.submit(_held_batch(release, data_seed=s))
                for s in range(10)]
        assert _wait_for(lambda: fab.autoscaler.scale_ups >= 1)
        assert len(fab.shard_ids()) == 2
        open(release, "w").close()
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert _wait_for(lambda: len(fab.shard_ids()) == 1
                         and fab.autoscaler.scale_downs >= 1)
        assert fab.shard_ids() == ["shard-0"]
        assert fab.autoscaler.spawn_failures == 0
        proc_stats = fab.telemetry.global_snapshot()["proc"]
        assert proc_stats["autoscale"]["scale_ups"] >= 1
    finally:
        open(release, "w").close()
        fab.stop()


# ---------------------------------------------------------------------------
# observability under chaos: kill -9 mid-dispatch, the trace replays
# ---------------------------------------------------------------------------

def test_sigkill_mid_dispatch_trace_survives_and_replays(tmp_path):
    from repro_torch.service.observability import (COMPLETED, DISPATCHED,
                                                   FAILOVER, replay)
    tdir = str(tmp_path / "traces")
    fab = _proc_fabric(n_shards=2, trace=True, trace_dir=tdir)
    try:
        victim = fab.shard_ids()[0]
        sess = fab.session("agent-0")
        futs = [sess.submit(_batch(data_seed=s), deadline_s=600.0,
                            affinity=_key_for_shard(fab, victim, f"v{s}"))
                for s in range(6)]
        deadline = time.monotonic() + 120.0
        armed = False
        while time.monotonic() < deadline and not armed:
            recs = replay.load_events(tdir)
            done = {r["job"] for r in recs if r["event"] == COMPLETED}
            armed = any(r["event"] == DISPATCHED and r["shard"] == victim
                        and r["job"] not in done for r in recs)
            if not armed:
                time.sleep(0.02)
        assert armed, "victim never dispatched a job"
        os.kill(fab.supervisor.live_workers()[victim], signal.SIGKILL)
        reports = [f.result(timeout=TIMEOUT)[1] for f in futs]
        assert len(reports) == 6
        survivor = fab.shard_ids()[0]
        assert survivor != victim
    finally:
        fab.stop()

    timelines = replay.reassemble(replay.load_events(tdir))
    crossed = []
    for key, hops in timelines.items():
        ev = [r["event"] for r in hops]
        disp_shards = [r["shard"] for r in hops if r["event"] == DISPATCHED]
        if FAILOVER in ev and victim in disp_shards:
            crossed.append((key, hops))
    assert crossed, "no job was dispatched on the victim and failed over"
    for key, hops in crossed:
        ev = [r["event"] for r in hops]
        assert ev[-1] == COMPLETED, (key, ev)
        i_disp = next(i for i, r in enumerate(hops)
                      if r["event"] == DISPATCHED and r["shard"] == victim)
        i_fo = next(i for i, r in enumerate(hops)
                    if r["event"] == FAILOVER)
        assert i_disp < i_fo < len(hops) - 1, (key, ev)
        last_disp = [r for r in hops if r["event"] == DISPATCHED][-1]
        assert last_disp["shard"] == survivor
        assert hops[-1]["shard"] == survivor
        ts = [r["t"] for r in hops]
        assert ts == sorted(ts), (key, ts)
        slacks = [r["slack"] for r in hops if r["slack"] is not None]
        for a, b in zip(slacks, slacks[1:]):
            assert b <= a + 0.25, (key, slacks)
    gantt = replay.shard_gantt(timelines)
    assert victim in gantt and survivor in gantt
    summary = replay.summarize(timelines)
    assert summary["failovers"] >= 1
    assert summary["outcomes"].get(COMPLETED, 0) >= 6
