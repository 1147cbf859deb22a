"""The port's out-of-process fabric (``repro_torch.service.fabric.proc``)
against ``repro.service.fabric.proc``: the codec, frame, wire-exception,
matching-run, client, cancel, admission-window and entry-point cases of
``tests/test_proc_fabric.py`` (its failover, shutdown, hand-off and
autoscaler cases are in ``tests/test_torch_proc_failover.py``).

* Stream framing under fragmentation, interleaving, oversize length words
  and corruption; control frames of every kind; the frame a heartbeat
  with windowed stats makes.
* Exceptions pickled here unpickle in a fresh interpreter that imports the
  port only.
* Real worker processes on the CPU: the same score as the in-process
  fabric and as the reference's process fabric, the client's
  ``processes=True``, compiled segments across the wire, cancellation,
  the synchronous admission window.
* The port's workers never load the JAX package: ``ProcConfig().preload``
  and the spawn command name only ``repro_torch`` modules, and a live
  worker reports neither ``jax`` nor ``repro`` loaded.  A worker told
  ``cuda`` on a machine without a card exits ``EXIT_BAD_CONFIG``, and a
  fabric on the card without one raises before spawning.

Every wait has its own timeout and every worker is reaped in a
``finally``; workers run with compiled segments off but in the one case
that checks them.
"""

import base64
import os
import pickle
import socket
import subprocess
import sys
import time
from concurrent.futures import CancelledError

import pytest
import torch

import repro.service.fabric as JF
import repro.tabular as JT
import repro_torch.tabular as T
from _fabric_helpers import hold_until
from repro.core import PipelineBatch as JBatch
from repro_torch.core import GENERIC, LazyOp, PipelineBatch
from repro_torch.service.fabric import (CodecError, JobEnvelope, ProcConfig,
                                        ProcStratumFabric, ResultEnvelope,
                                        ShardedStratum, decode_job,
                                        encode_job, encode_result)
from repro_torch.service.fabric.proc import supervisor as t_supervisor
from repro_torch.service.fabric.proc import worker as t_worker
from repro_torch.service.fabric.proc.frames import (BYE, CONFIG, DRAIN,
                                                    HANDOFF_DATA,
                                                    HANDOFF_PUT, HANDOFF_REQ,
                                                    HEARTBEAT, HELLO,
                                                    FrameDecoder, FrameError,
                                                    decode_control,
                                                    encode_control,
                                                    write_frame)
from repro_torch.service.queue import AdmissionError, DeadlineExceeded
from repro_torch.service.server import ServiceConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")

N_ROWS = 1200
TIMEOUT = 120


def _pipeline(data_seed=0, cols=(10, 11, 12), kind="mae", tab=T):
    x = tab.read("uk_housing", N_ROWS, seed=data_seed)
    xs = tab.scale(tab.impute(tab.project(x, list(cols))))
    y = tab.project(x, [0])
    return tab.metric(tab.project(xs, [0]), y, kind=kind)


def _batch(name="p", **kw):
    return PipelineBatch([_pipeline(**kw)], [name])


@pytest.fixture(scope="module", autouse=True)
def _datasets():
    # workers read the shared data lake: write every seed up front, so no
    # worker races the atomic-write path mid-test
    from repro_torch.data.tabular import ensure_files
    for seed in range(16):
        ensure_files("uk_housing", N_ROWS, seed=seed)


def _proc_fabric(n_shards=2, proc=None, **kw):
    kw.setdefault("memory_budget_bytes", 1 << 30)
    kw.setdefault("n_executors", 1)
    kw.setdefault("coalesce_window_s", 0.0)
    kw.setdefault("compiled_segments", False)
    kw.setdefault("device", "cpu")
    proc = proc or ProcConfig(heartbeat_s=0.1, heartbeat_timeout_s=3.0,
                              reconnect_grace_s=0.5)
    return ProcStratumFabric(n_shards=n_shards, proc=proc, **kw)


def _wait_for(cond, timeout_s=30.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _frames_with_prefix(frames):
    out = bytearray()
    for f in frames:
        out += len(f).to_bytes(4, "big") + f
    return bytes(out)


# ---------------------------------------------------------------------------
# stream framing under adversity
# ---------------------------------------------------------------------------

def test_frame_decoder_reassembles_one_byte_feeds():
    frame = encode_control(HEARTBEAT, {"queue_depth": 3})
    stream = _frames_with_prefix([frame])
    dec = FrameDecoder()
    got = []
    for i in range(len(stream)):
        got += dec.feed(stream[i:i + 1])
    assert got == [frame]
    assert dec.pending_bytes() == 0


def test_frame_decoder_interleaved_kinds_in_one_chunk():
    job = encode_job(JobEnvelope(envelope_id="e-0", tenant="t",
                                 priority=1, routing_key="k",
                                 batch=_batch()))
    result = encode_result(ResultEnvelope(envelope_id="e-0", tenant="t",
                                          shard_id="s", ok=False,
                                          error=RuntimeError("x")))
    beat = encode_control(HEARTBEAT, {"inflight": 1})
    stream = _frames_with_prefix([job, beat, result])
    dec = FrameDecoder()
    got = dec.feed(stream[:len(stream) // 3])
    got += dec.feed(stream[len(stream) // 3:])
    assert got == [job, beat, result]


def test_frame_decoder_oversize_length_word_raises():
    dec = FrameDecoder(max_frame_bytes=1024)
    with pytest.raises(FrameError):
        dec.feed((1 << 20).to_bytes(4, "big") + b"xxxx")


def test_checksum_corruption_poisons_one_frame_not_the_stream():
    a = encode_control(HEARTBEAT, {"n": 1})
    b = encode_control(HEARTBEAT, {"n": 2})
    corrupted = a[:-1] + bytes([a[-1] ^ 0xFF])
    dec = FrameDecoder()
    frames = dec.feed(_frames_with_prefix([corrupted, b]))
    assert len(frames) == 2
    with pytest.raises(CodecError):
        decode_control(frames[0])
    assert decode_control(frames[1]) == (HEARTBEAT, {"n": 2})


def test_control_codec_round_trip_every_kind():
    for kind in (HELLO, CONFIG, HEARTBEAT, DRAIN, BYE,
                 HANDOFF_REQ, HANDOFF_DATA, HANDOFF_PUT):
        obj = {"kind": kind, "blob": b"\x00\xff" * 8}
        assert decode_control(encode_control(kind, obj)) == (kind, obj)
    with pytest.raises(ValueError):
        encode_control(0x01, {})
    with pytest.raises(CodecError):
        decode_control(encode_job(JobEnvelope(
            envelope_id="e", tenant="t", priority=1, routing_key="k",
            batch=_batch())))


def test_heartbeat_with_windowed_stats_survives_byte_feeds():
    from repro_torch.service.observability import ThroughputCollector
    col = ThroughputCollector(window_s=0.5, n_windows=8)
    col.record_submit()
    col.record_dispatch(0.012, queue_depth=4)
    col.record_completion()
    beat = {"shard_id": "shard-0", "pid": 4242, "t": 1.0, "ready": True,
            "queue_depth": 0, "inflight": 1, "tenants": {},
            "global": {"windows": col.snapshot()},
            "segments": {"traces": 1, "trace_s": 0.5, "compiles": 1,
                         "compile_s": 1.5}}
    frame = encode_control(HEARTBEAT, beat)
    stream = _frames_with_prefix([frame])
    dec = FrameDecoder()
    got = []
    for i in range(len(stream)):
        got += dec.feed(stream[i:i + 1])
    assert got == [frame] and dec.pending_bytes() == 0
    kind, payload = decode_control(got[0])
    assert kind == HEARTBEAT
    win = payload["global"]["windows"]
    assert win["submitted"] == 1 and win["completed"] == 1
    assert win["dispatch_p99_s"] == pytest.approx(0.012)
    assert win["queue_depth_max"] == 4
    assert win["per_window"]
    assert payload["segments"]["compile_s"] == 1.5


def test_traced_job_frame_corruption_poisons_one_frame_not_stream():
    from repro_torch.service.observability import ROUTED, SUBMITTED, make_hop
    env = JobEnvelope(envelope_id="e-t", tenant="t", priority=1,
                      routing_key="k", batch=_batch(),
                      hops=(make_hop(SUBMITTED, t=1.0, slack=5.0),
                            make_hop(ROUTED, shard="shard-0", t=2.0,
                                     attempt=0)))
    job = encode_job(env)
    beat = encode_control(HEARTBEAT, {"n": 1})
    corrupted = job[:-1] + bytes([job[-1] ^ 0xFF])
    dec = FrameDecoder()
    frames = dec.feed(_frames_with_prefix([corrupted, beat]))
    assert len(frames) == 2
    with pytest.raises(CodecError):
        decode_job(frames[0])
    assert decode_control(frames[1]) == (HEARTBEAT, {"n": 1})
    assert decode_job(job).hops == env.hops


def test_live_view_renders_synthetic_proc_snapshot():
    from repro_torch.service.observability import top
    frame = top.render(top.demo_snapshot())
    assert "proc:" in frame and "autoscale" in frame
    assert "shard0" in frame and "retired" in frame
    assert "p99" in frame


# ---------------------------------------------------------------------------
# wire-crossing exceptions survive a REAL process boundary
# ---------------------------------------------------------------------------

def _unpickles_in_fresh_process(obj, check: str) -> None:
    """Pickle here, unpickle in a clean interpreter, run ``check`` there;
    that interpreter must not have loaded the JAX package."""
    blob = base64.b64encode(pickle.dumps(obj)).decode()
    code = (f"import base64, pickle, sys\n"
            f"e = pickle.loads(base64.b64decode('{blob}'))\n"
            f"{check}\n"
            f"assert not [m for m in sys.modules if m == 'jax' or "
            f"m == 'repro' or m.startswith(('jax.', 'repro.'))]\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr


def test_execution_error_crosses_process_with_op_and_cause():
    from repro_torch.core.runtime import ExecutionError
    err = ExecutionError(_pipeline().op, ValueError("original cause"))
    _unpickles_in_fresh_process(
        err,
        "assert type(e).__name__ == 'ExecutionError'\n"
        "assert type(e).__module__.startswith('repro_torch.')\n"
        "assert e.op is not None and e.op.op_name\n"
        "assert isinstance(e.cause, ValueError)")


def test_execution_preempted_crosses_process_with_payload():
    from repro_torch.core.runtime import ExecutionPreempted
    p = ExecutionPreempted(salvage={"sig": (1, 2)}, waves_done=3)
    _unpickles_in_fresh_process(
        p, "assert e.salvage == {'sig': (1, 2)} and e.waves_done == 3")


def test_admission_and_deadline_errors_cross_process():
    _unpickles_in_fresh_process(
        AdmissionError("queue full"),
        "assert type(e).__name__ == 'AdmissionError'\n"
        "assert 'queue full' in str(e)")
    _unpickles_in_fresh_process(
        DeadlineExceeded("too late"),
        "assert type(e).__name__ == 'DeadlineExceeded'")


def test_execution_error_with_unpicklable_cause_degrades_not_drops():
    from repro_torch.core.runtime import ExecutionError
    from repro_torch.service.fabric.envelope import decode_result

    class Unpicklable(Exception):
        def __reduce__(self):
            raise TypeError("nope")

    err = ExecutionError(_pipeline().op, Unpicklable("device handle"))
    data = encode_result(ResultEnvelope(envelope_id="e", tenant="t",
                                        shard_id="s", ok=False, error=err))
    out = decode_result(data).error
    assert type(out).__name__ == "ExecutionError"
    assert out.op.op_name == err.op.op_name
    assert "device handle" in repr(out.cause)


# ---------------------------------------------------------------------------
# end-to-end over real worker processes
# ---------------------------------------------------------------------------

def test_proc_fabric_matches_in_process_fabric_and_the_reference():
    local = ShardedStratum(n_shards=1, memory_budget_bytes=1 << 30,
                           n_executors=1, coalesce_window_s=0.0,
                           compiled_segments=False, device="cpu")
    try:
        want, _ = local.session("t").submit(_batch()).result(
            timeout=TIMEOUT)
    finally:
        local.stop()
    fab = _proc_fabric(n_shards=2)
    try:
        got, report = fab.session("t").submit(_batch()).result(
            timeout=TIMEOUT)
        assert float(got["p"]) == pytest.approx(float(want["p"]))
        assert report.shard_id in fab.shard_ids()
        workers = fab.supervisor.worker_stats()
        assert set(workers) == set(fab.shard_ids())
        assert all(w["hello_s"] is not None and w["hello_s"] > 0
                   for w in workers.values())
    finally:
        fab.stop()
    ref = JF.ProcStratumFabric(
        n_shards=2, memory_budget_bytes=1 << 30, n_executors=1,
        coalesce_window_s=0.0, compiled_segments=False,
        proc=JF.ProcConfig(heartbeat_s=0.1, heartbeat_timeout_s=30.0))
    try:
        j_got, j_report = ref.session("t").submit(JBatch(
            [_pipeline(tab=JT)], ["p"])).result(timeout=TIMEOUT)
    finally:
        ref.stop()
    # the same shard on both rings, the score within the tabular tolerance
    assert j_report.shard_id == report.shard_id
    assert float(got["p"]) == pytest.approx(float(j_got["p"]), rel=2e-3,
                                            abs=2e-3)


def test_client_processes_true_is_the_same_surface():
    from repro_torch.client import StratumConfig, SubmitOptions, connect
    cfg = StratumConfig.make(memory_budget_bytes=1 << 30, n_shards=2,
                             processes=True, n_executors=1,
                             coalesce_window_s=0.0, compiled_segments=False,
                             device="cpu")
    with connect("fabric", cfg) as client:
        value, report = client.run(_pipeline(),
                                   options=SubmitOptions(deadline_s=120.0))
        assert report.deadline_met is True
        snap = client.telemetry.global_snapshot()
        assert len(snap["proc"]["workers"]) == 2
        for pid in snap["proc"]["workers"].values():
            os.kill(pid, 0)
        pids = list(snap["proc"]["workers"].values())
    for pid in pids:                    # close() reaped every worker
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_compiled_segments_cross_the_wire():
    """A worker at the client's default (compiled segments on) compiles
    the batch's torch segments and answers with the per-op score; its
    heartbeat carries the compile stats."""
    fab = _proc_fabric(n_shards=1, compiled_segments=True)
    try:
        got, report = fab.session("t").submit(_batch()).result(
            timeout=300)
        (sid, stats), = fab.supervisor.worker_stats().items()
        deadline = time.monotonic() + 30
        while not stats["segments"].get("compiles") and \
                time.monotonic() < deadline:
            time.sleep(0.1)
            stats = fab.supervisor.worker_stats()[sid]
        g = fab.telemetry.global_snapshot()
    finally:
        fab.stop()
    local = ShardedStratum(n_shards=1, memory_budget_bytes=1 << 30,
                           n_executors=1, coalesce_window_s=0.0,
                           compiled_segments=False, device="cpu")
    try:
        want, _ = local.session("t").submit(_batch()).result(
            timeout=TIMEOUT)
    finally:
        local.stop()
    assert report.per_backend.get("torch-seg", 0) > 0, report.per_backend
    assert float(got["p"]) == pytest.approx(float(want["p"]), rel=1e-6)
    assert stats["segments"]["compiles"] >= 1
    assert stats["segments"]["compile_s"] > 0
    assert g["per_shard"][sid]["plan_cache"]["uncompilable"] == 0


def test_admission_window_raises_synchronously_at_submit():
    proc = ProcConfig(heartbeat_s=0.1, heartbeat_timeout_s=3.0, window=1)
    fab = _proc_fabric(n_shards=1, proc=proc)
    try:
        sess = fab.session("t")
        futs, rejected = [], 0
        for s in range(8):
            try:
                futs.append(sess.submit(_batch(data_seed=s)))
            except AdmissionError:
                rejected += 1
        assert rejected > 0, "window=1 must push back synchronously"
        for f in futs:
            f.result(timeout=TIMEOUT)
    finally:
        fab.stop()


def test_cancel_crosses_the_wire_to_the_owning_worker(tmp_path,
                                                      monkeypatch):
    """The first job holds the one executor until the test releases it,
    so the last one is still queued on the worker when its cancel
    arrives: the cancel is honored there, never raced by the clock."""
    monkeypatch.setenv("PYTHONPATH", TESTS + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    release = str(tmp_path / "release")
    fab = _proc_fabric(n_shards=1, coalesce_max_jobs=1,
                       max_jobs_per_tenant_per_round=1)
    try:
        sess = fab.session("t")
        held = LazyOp("hold", GENERIC,
                      spec={"fn": hold_until, "kwargs": {"path": release}},
                      inputs=(_pipeline(),)).out()
        futs = [sess.submit(PipelineBatch([held], ["p"]))]
        futs += [sess.submit(_batch(data_seed=s)) for s in range(1, 4)]
        futs[-1].cancel()
        open(release, "w").close()
        for f in futs[:-1]:
            f.result(timeout=TIMEOUT)
        assert futs[-1]._event.wait(timeout=60)
        assert futs[-1].cancelled()
        with pytest.raises(CancelledError):
            futs[-1].result(timeout=1)
        assert fab.router.cancels_sent == 1
        # the heartbeat-fed ledger shows the worker-side cancel
        assert _wait_for(lambda: fab.telemetry.snapshot().get(
            "t", {}).get("jobs_cancelled") == 1)
    finally:
        open(release, "w").close()
        fab.stop()


# ---------------------------------------------------------------------------
# worker entrypoint hygiene: the port's modules only, the card or nothing
# ---------------------------------------------------------------------------

def test_worker_entrypoint_help_runs():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", t_supervisor.WORKER_MODULE, "--help"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0
    assert "shard" in r.stdout and "repro_torch" in r.stdout


def test_spawned_worker_never_imports_the_jax_package(tmp_path,
                                                      monkeypatch):
    """What a worker loads comes from the spawn command and the preload
    list, both the port's; a live worker that built its service and ran
    a job has loaded neither ``jax`` nor ``repro``."""
    assert t_supervisor.WORKER_MODULE == \
        "repro_torch.service.fabric.proc.worker"
    assert ProcConfig().preload == ("repro_torch.tabular",)
    out = str(tmp_path / "modules")
    monkeypatch.setenv("STRATUM_TEST_MODULES_OUT", out)
    monkeypatch.setenv("PYTHONPATH", TESTS + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    proc = ProcConfig(heartbeat_s=0.1, heartbeat_timeout_s=3.0,
                      preload=("repro_torch.tabular", "_fabric_helpers"))
    fab = _proc_fabric(n_shards=1, proc=proc)
    try:
        res, _ = fab.session("t").submit(_batch()).result(timeout=TIMEOUT)
        (pid,) = fab.supervisor.live_workers().values()
        os.kill(pid, 0)                  # the worker is alive here
    finally:
        fab.stop()
    assert fab.supervisor.reaped == {"shard-0": 0}
    with open(f"{out}.{pid}") as f:
        loaded = f.read().split("\n")
    assert loaded[0] == "loaded"
    assert loaded[1:] == [], f"the worker loaded {loaded[1:]}"


def _recv(sock) -> bytes:
    """One read from a worker's socket (its own timeout); the worker
    closing it before the test has what it waits for fails the test."""
    chunk = sock.recv(1 << 16)
    assert chunk, "the worker closed its socket"
    return chunk


def test_worker_told_cuda_without_a_card_exits_bad_config():
    """A fake supervisor hands a worker a config on ``cuda``; without a
    card the worker exits ``EXIT_BAD_CONFIG`` before it serves anything,
    and never reports a built service."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the config is valid")
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(60)
    port = listener.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-m", t_supervisor.WORKER_MODULE, "--port",
         str(port), "--shard-id", "s0"], env=env)
    beats = []
    try:
        sock, _ = listener.accept()
        sock.settimeout(60)
        dec = FrameDecoder()
        frames = []
        while not frames:
            frames = dec.feed(_recv(sock))
        assert decode_control(frames[0])[0] == HELLO
        write_frame(sock, encode_control(CONFIG, {
            "service_config": pickle.dumps(ServiceConfig(device="cuda")),
            "heartbeat_s": 0.05, "preload": ("repro_torch.tabular",)}))
        while True:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            beats += [decode_control(f) for f in dec.feed(chunk)]
        rc = proc.wait(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        listener.close()
    assert rc == t_worker.EXIT_BAD_CONFIG
    assert not any(kind == HEARTBEAT and payload.get("ready")
                   for kind, payload in beats)
    assert not any(kind == BYE for kind, _ in beats)


def test_fabric_on_the_card_without_one_raises_before_spawning(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.client import StratumConfig, connect
    spawned = []
    monkeypatch.setattr(t_supervisor.WorkerSupervisor, "spawn",
                        lambda self, *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        connect("fabric", StratumConfig.make(
            processes=True, n_shards=2, compiled_segments=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcStratumFabric(n_shards=1, compiled_segments=False)
    assert spawned == []
