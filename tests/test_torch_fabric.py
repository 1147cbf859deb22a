"""The port's in-process sharded fabric (``repro_torch.service.fabric``)
against ``repro.service.fabric``: the counterpart of
``tests/test_fabric.py``, and the fabric case of ``tests/test_client.py``.

* Every case of ``tests/test_fabric.py`` on the port, its shards on the
  CPU: the consistent-hash ring, the envelope codec (fresh uids, host
  numpy results, errors with their cause), routing and locality,
  admission, failover with no job lost, drain and growth, cancellation,
  deadlines on the wire, telemetry, the AIDE search on shards.
* Parity with the reference: ring owners and the keys that move on add
  and remove for 10,000 keys, ``routing_key_for`` of the same batch built
  through both packages, frame headers and control frames that decode in
  the other package, ``FabricTelemetry`` over the same snapshots, and a
  2-shard fabric of each package placing every job on the same shard with
  scores that agree within ``tests/test_torch_service.py``'s tolerances.

Shards run with compiled segments off; every wait has a timeout.
"""

import pickle
import time
from concurrent.futures import CancelledError
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.service.fabric as JF
import repro.service.fabric.proc.frames as j_frames
import repro.tabular as JT
import repro_torch.service.fabric.proc.frames as t_frames
import repro_torch.tabular as T
from repro.core import PipelineBatch as JBatch
from repro_torch.client import StratumConfig, SubmitOptions, connect
from repro_torch.core import GENERIC, LazyOp, PipelineBatch, Stratum
from repro_torch.core.dag import toposort
from repro_torch.core.runtime import ExecutionError
from repro_torch.service import (AdmissionError, DeadlineExceeded,
                                 StratumService, merge_tenant_snapshots)
from repro_torch.service.fabric import (CancelEnvelope, CodecError,
                                        ConsistentHashRing, FabricTelemetry,
                                        JobEnvelope, NoShardsError,
                                        ResultEnvelope, ShardedStratum,
                                        decode_cancel, decode_job,
                                        decode_result, encode_cancel,
                                        encode_job, encode_result,
                                        routing_key_for)
from repro_torch.service.fabric.envelope import FabricJobReport

TIMEOUT = 120


def _pipeline(n_rows=2000, cols=(10, 11, 12), kind="mae", data_seed=0,
              tab=T):
    x = tab.read("uk_housing", n_rows, seed=data_seed)
    xs = tab.scale(tab.impute(tab.project(x, list(cols))))
    y = tab.project(x, [0])
    return tab.metric(tab.project(xs, [0]), y, kind=kind)


def _batch(name="p", **kw):
    return PipelineBatch([_pipeline(**kw)], [name])


def _boom(*_a, **_k):
    raise ValueError("poisoned op")


def _fabric(n_shards=2, **kw):
    kw.setdefault("memory_budget_bytes", 1 << 30)
    kw.setdefault("n_executors", 1)
    kw.setdefault("coalesce_window_s", 0.0)
    kw.setdefault("compiled_segments", False)
    kw.setdefault("device", "cpu")
    return ShardedStratum(n_shards=n_shards, **kw)


def _key_for_shard(fab, shard_id: str, tag="k") -> str:
    """An affinity key that routes to ``shard_id`` on the current ring."""
    for i in range(10_000):
        key = f"{tag}-{i}"
        if fab.router._ring.route(key) == shard_id:
            return key
    raise AssertionError("no key found")  # pragma: no cover


# ---------------------------------------------------------------------------
# consistent-hash ring
# ---------------------------------------------------------------------------

KEYS = [f"key-{i}" for i in range(2000)]


def test_ring_routing_is_deterministic_across_instances():
    a = ConsistentHashRing(["s0", "s1", "s2"], vnodes=32)
    b = ConsistentHashRing(["s0", "s1", "s2"], vnodes=32)
    assert [a.route(k) for k in KEYS] == [b.route(k) for k in KEYS]
    counts = {n: 0 for n in a.nodes()}
    for k in KEYS:
        counts[a.route(k)] += 1
    assert min(counts.values()) > len(KEYS) * 0.1


def test_ring_add_moves_at_most_bounded_fraction_and_only_to_new_node():
    ring = ConsistentHashRing([f"s{i}" for i in range(4)], vnodes=64)
    before = {k: ring.route(k) for k in KEYS}
    ring.add("s4")
    moved = {k for k in KEYS if ring.route(k) != before[k]}
    assert len(moved) <= 2 * len(KEYS) / 5
    assert moved, "a new shard must take over some keys"
    assert all(ring.route(k) == "s4" for k in moved)


def test_ring_remove_remaps_only_the_removed_nodes_keys():
    ring = ConsistentHashRing([f"s{i}" for i in range(4)], vnodes=64)
    before = {k: ring.route(k) for k in KEYS}
    ring.remove("s2")
    for k in KEYS:
        if before[k] == "s2":
            assert ring.route(k) != "s2"
        else:
            assert ring.route(k) == before[k]


def test_ring_successors_distinct_and_respect_exclusion():
    ring = ConsistentHashRing([f"s{i}" for i in range(5)], vnodes=16)
    succ = list(ring.successors("some-key"))
    assert sorted(succ) == sorted(ring.nodes())
    assert succ[0] == ring.route("some-key")
    excl = list(ring.successors("some-key", exclude={"s1", "s3"}))
    assert "s1" not in excl and "s3" not in excl and len(excl) == 3


def test_ring_membership_errors():
    ring = ConsistentHashRing(["s0"])
    with pytest.raises(ValueError):
        ring.add("s0")
    with pytest.raises(KeyError):
        ring.remove("nope")
    ring.remove("s0")
    with pytest.raises(LookupError):
        ring.route("k")


def test_ring_owners_and_moves_equal_the_reference():
    """10,000 keys: the owner of every key, the keys that move when a
    shard joins and when one leaves, and each key's failover order, equal
    the reference ring's."""
    keys = [f"sig-{i:05d}" for i in range(10_000)]
    nodes = [f"shard-{i}" for i in range(4)]
    port, ref = ConsistentHashRing(nodes), JF.ConsistentHashRing(nodes)

    def owners(ring):
        return [ring.route(k) for k in keys]

    assert owners(port) == owners(ref)
    before = owners(port)
    port.add("shard-4")
    ref.add("shard-4")
    assert owners(port) == owners(ref)
    moved_on_add = [k for k, b, a in zip(keys, before, owners(port))
                    if a != b]
    assert moved_on_add and len(moved_on_add) < len(keys) / 2
    before = owners(port)
    port.remove("shard-1")
    ref.remove("shard-1")
    after = owners(port)
    assert after == owners(ref)
    assert all(b == "shard-1" for k, b, a in zip(keys, before, after)
               if a != b)
    assert [list(port.successors(k)) for k in keys[:500]] == \
        [list(ref.successors(k)) for k in keys[:500]]


# ---------------------------------------------------------------------------
# envelope codec — the serializable submission boundary
# ---------------------------------------------------------------------------

def test_job_envelope_round_trip_preserves_signatures_with_fresh_uids():
    batch = _batch()
    env = JobEnvelope(envelope_id="e-1", tenant="t", priority=0,
                      routing_key=routing_key_for(batch), batch=batch)
    out = decode_job(encode_job(env))
    assert (out.envelope_id, out.tenant, out.priority, out.routing_key) \
        == ("e-1", "t", 0, env.routing_key)
    assert out.batch.names == batch.names
    assert [r.signature for r in out.batch.sinks] \
        == [r.signature for r in batch.sinks]
    old_uids = {op.uid for op in toposort(batch.sinks)}
    new_uids = {op.uid for op in toposort(out.batch.sinks)}
    assert old_uids.isdisjoint(new_uids)


def test_codec_rejects_corruption_and_wrong_kind():
    data = encode_job(JobEnvelope("e", "t", 1, "rk", _batch()))
    flipped = data[:30] + bytes([data[30] ^ 0xFF]) + data[31:]
    with pytest.raises(CodecError):
        decode_job(flipped)
    with pytest.raises(CodecError):
        decode_result(data)
    with pytest.raises(CodecError):
        decode_job(b"not a frame at all")


def test_result_envelope_round_trip_hosts_arrays_and_carries_errors():
    ok = ResultEnvelope(envelope_id="e", tenant="t", shard_id="s", ok=True,
                        results={"p": torch.arange(4.0),
                                 "q": (torch.ones(2, dtype=torch.int64),
                                       {"r": np.float32(2.5)})})
    out = decode_result(encode_result(ok))
    assert isinstance(out.results["p"], np.ndarray)
    np.testing.assert_allclose(out.results["p"], [0.0, 1.0, 2.0, 3.0])
    # nested containers keep their shape; every tensor is host numpy
    q0, q1 = out.results["q"]
    assert isinstance(q0, np.ndarray) and q0.dtype == np.int64
    assert q1["r"] == np.float32(2.5)

    op = LazyOp("boom", GENERIC, spec={"fn": _boom})
    err = ExecutionError(op, ValueError("poisoned op"))
    bad = decode_result(encode_result(ResultEnvelope(
        envelope_id="e", tenant="t", shard_id="s", ok=False, error=err)))
    assert isinstance(bad.error, ExecutionError)
    assert isinstance(bad.error.cause, ValueError)
    assert bad.error.op.op_name == "boom"


def test_execution_error_pickles_directly():
    op = LazyOp("boom", GENERIC, spec={"fn": _boom})
    e = pickle.loads(pickle.dumps(ExecutionError(op, ValueError("x"))))
    assert isinstance(e.cause, ValueError) and e.op.op_name == "boom"


def test_routing_key_groups_by_source_not_by_sink():
    a = _batch(kind="mae")
    b = _batch(kind="rmse")
    c = _batch(data_seed=3)
    assert routing_key_for(a) == routing_key_for(b)
    assert routing_key_for(a) != routing_key_for(c)
    assert routing_key_for(a, "batch") != routing_key_for(b, "batch")
    with pytest.raises(ValueError):
        routing_key_for(a, "bogus")


@pytest.mark.parametrize("policy", ["sources", "batch"])
def test_routing_key_equals_the_reference(policy):
    """The same batches built through both packages hash to the same
    routing keys (their signatures are the reference's)."""
    specs = [dict(kind="mae"), dict(kind="rmse", cols=(10, 13)),
             dict(data_seed=3), dict(n_rows=500, cols=(11,))]
    for kw in specs:
        port = _batch(**kw)
        ref = JBatch([_pipeline(tab=JT, **kw)], ["p"])
        assert routing_key_for(port, policy) == \
            JF.routing_key_for(ref, policy), kw


def test_frames_share_the_reference_wire_format():
    """The same magic, version and kind bytes: a frame of either package
    is recognised by the other, control frames decode in both directions,
    and a cancel and an error-free result decode across the packages."""
    assert (t_frames.HELLO, t_frames.CONFIG, t_frames.HEARTBEAT,
            t_frames.DRAIN, t_frames.BYE, t_frames.HANDOFF_REQ,
            t_frames.HANDOFF_DATA, t_frames.HANDOFF_PUT) == \
        (j_frames.HELLO, j_frames.CONFIG, j_frames.HEARTBEAT,
         j_frames.DRAIN, j_frames.BYE, j_frames.HANDOFF_REQ,
         j_frames.HANDOFF_DATA, j_frames.HANDOFF_PUT)
    assert t_frames.MAX_FRAME_BYTES == j_frames.MAX_FRAME_BYTES
    for kind in sorted(t_frames.CONTROL_KINDS):
        obj = {"kind": kind, "blob": b"\x00\xff" * 8, "n": [1, 2.5]}
        port, ref = (t_frames.encode_control(kind, obj),
                     j_frames.encode_control(kind, obj))
        assert port == ref
        assert j_frames.decode_control(port) == (kind, obj)
        assert t_frames.decode_control(ref) == (kind, obj)
    cancel = encode_cancel(CancelEnvelope("c-1", "t", attempt=3))
    got = JF.decode_cancel(cancel)
    assert (got.envelope_id, got.tenant, got.attempt) == ("c-1", "t", 3)
    got = decode_cancel(JF.encode_cancel(JF.CancelEnvelope("c-2", "u", 1)))
    assert (got.envelope_id, got.tenant, got.attempt) == ("c-2", "u", 1)
    # the data-plane frames of each package carry the other's kind bytes
    job = encode_job(JobEnvelope("e", "t", 1, "k", _batch(n_rows=500)))
    ref_job = JF.encode_job(JF.JobEnvelope(
        "e", "t", 1, "k", JBatch([_pipeline(n_rows=500, tab=JT)], ["p"])))
    assert job[:6] == ref_job[:6]
    with pytest.raises(JF.CodecError):
        j_frames.decode_control(job)
    res = JF.decode_result(encode_result(ResultEnvelope(
        "e", "t", "s", ok=True, results={"p": torch.tensor([1.5])})))
    np.testing.assert_array_equal(res.results["p"], [1.5])


# ---------------------------------------------------------------------------
# fabric end-to-end
# ---------------------------------------------------------------------------

def test_fabric_executes_and_all_traffic_crosses_the_codec():
    fab = _fabric(n_shards=3)
    try:
        ref, _ = Stratum(memory_budget_bytes=1 << 30, device="cpu",
                         compiled_segments=False).run_batch(_batch())
        ref_val = float(ref["p"])
        futs = [fab.session(f"t{i}").submit(_batch()) for i in range(3)]
        for f in futs:
            results, report = f.result(timeout=TIMEOUT)
            assert float(results["p"]) == pytest.approx(ref_val, rel=1e-6)
            assert report.shard_id.startswith("shard-")
            assert isinstance(results["p"], np.ndarray)
        transports = fab.router._transports.values()
        assert sum(t.jobs_received for t in transports) == 3
        assert sum(t.results_sent for t in transports) == 3
        assert all(t.bytes_in > 0 or t.jobs_received == 0
                   for t in transports)
    finally:
        fab.stop()


def test_fabric_shards_share_one_device():
    fab = _fabric(n_shards=2, autostart=False)
    try:
        assert fab.device == torch.device("cpu")
        assert fab.config.device == "cpu"
        shards = fab._shards_snapshot().values()
        assert {svc.device for svc in shards} == {torch.device("cpu")}
        assert {svc.config.shard_id for svc in shards} == \
            set(fab.shard_ids())
    finally:
        fab.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedStratum(n_shards=2, compiled_segments=False)


def test_identical_sources_land_on_one_shard_and_share_work():
    fab = _fabric(n_shards=4, coalesce_window_s=0.05, autostart=False)
    try:
        f1 = fab.session("a").submit(_batch())
        f2 = fab.session("b").submit(_batch(kind="rmse"))
        fab.start()
        f1.result(timeout=TIMEOUT), f2.result(timeout=TIMEOUT)
        g = fab.telemetry.global_snapshot()
        routed = [s["envelopes_routed"] for s in g["per_shard"].values()]
        assert sorted(routed) == [0, 0, 0, 2]
        assert g["ops_deduped_cross_agent"] > 0
        assert g["signature_locality_hit_rate"] == pytest.approx(1.0)
    finally:
        fab.stop()


def test_affinity_overrides_content_routing():
    fab = _fabric(n_shards=4, autostart=False)
    try:
        f1 = fab.session("a").submit(_batch(data_seed=1), affinity="pin-me")
        f2 = fab.session("a").submit(_batch(data_seed=2), affinity="pin-me")
        fab.start()
        f1.result(timeout=TIMEOUT), f2.result(timeout=TIMEOUT)
        routed = [s["envelopes_routed"] for s in
                  fab.telemetry.per_shard().values()]
        assert sorted(routed) == [0, 0, 0, 2]
    finally:
        fab.stop()


def test_admission_backpressure_raises_synchronously_from_submit():
    fab = _fabric(n_shards=1, autostart=False, max_queued_total=2)
    try:
        ses = fab.session("t")
        ses.submit(_batch())
        ses.submit(_batch(kind="rmse"))
        with pytest.raises(AdmissionError):
            ses.submit(_batch(data_seed=9))
        assert fab.router.pending_count() == 2
    finally:
        fab.start()
        fab.stop()


def test_unencodable_batch_fails_future_without_leaking_pending():
    fab = _fabric(n_shards=1)
    try:
        bad = LazyOp("boom", GENERIC,
                     spec={"fn": lambda: None},     # lambdas don't pickle
                     inputs=(_pipeline(n_rows=500),)).out()
        fut = fab.session("t").submit(PipelineBatch([bad], ["bad"]))
        with pytest.raises(Exception):
            fut.result(timeout=10)
        assert fab.router.pending_count() == 0
    finally:
        fab.stop()


def test_execution_error_crosses_the_boundary_with_cause():
    fab = _fabric(n_shards=2)
    try:
        sink = LazyOp("boom", GENERIC, spec={"fn": _boom},
                      inputs=(_pipeline(n_rows=500),)).out()
        fut = fab.session("t").submit(PipelineBatch([sink], ["bad"]))
        with pytest.raises(ExecutionError) as ei:
            fut.result(timeout=TIMEOUT)
        assert isinstance(ei.value.cause, ValueError)
    finally:
        fab.stop()


# ---------------------------------------------------------------------------
# failover + rebalancing
# ---------------------------------------------------------------------------

def test_failover_requeues_all_inflight_zero_loss():
    fab = _fabric(n_shards=2, autostart=False)
    try:
        victim, survivor = fab.shard_ids()
        n_victim, n_survivor = 3, 2
        futs = []
        for i in range(n_victim):
            futs.append(fab.session("t").submit(
                _batch(name="p", cols=(10 + i, 11, 12)),
                affinity=_key_for_shard(fab, victim, f"v{i}")))
        for i in range(n_survivor):
            futs.append(fab.session("t").submit(
                _batch(name="p", cols=(10, 11 + i, 13)),
                affinity=_key_for_shard(fab, survivor, f"s{i}")))
        assert fab.router.pending_count(victim) == n_victim
        assert fab.fail_shard(victim) == n_victim
        fab.start()
        for f in futs:
            results, report = f.result(timeout=180)
            assert "p" in results
            assert report.shard_id == survivor
        g = fab.telemetry.global_snapshot()
        assert g["failover_requeues"] == n_victim
        assert g["shards_failed"] == 1
        assert fab.shard_ids() == [survivor]
        assert g["per_shard"][victim]["retired"] is True
        assert g["envelopes_routed"] == n_victim + n_survivor + n_victim
        assert g["n_shards"] == 1
    finally:
        fab.stop()


def test_dead_transport_detected_on_send_and_fails_over():
    fab = _fabric(n_shards=2)
    try:
        victim = fab.shard_ids()[0]
        key = _key_for_shard(fab, victim)
        fab.router._transports[victim].kill()
        fut = fab.session("t").submit(_batch(), affinity=key)
        results, report = fut.result(timeout=TIMEOUT)
        assert "p" in results and report.shard_id != victim
        assert fab.router.shards_failed == 1
    finally:
        fab.stop()


def test_router_fail_shard_alone_silences_transport():
    fab = _fabric(n_shards=2, autostart=False)
    try:
        victim = fab.shard_ids()[0]
        fut = fab.session("t").submit(
            _batch(), affinity=_key_for_shard(fab, victim))
        transport = fab.router._transports[victim]
        assert fab.router.fail_shard(victim) == 1
        assert transport._dead
        fab.start()
        results, report = fut.result(timeout=TIMEOUT)
        assert "p" in results and report.shard_id != victim
    finally:
        fab.stop()


def test_corrupted_reply_frame_is_counted_not_raised():
    fab = _fabric(n_shards=1)
    try:
        fab.router._on_result(b"garbage frame")
        assert fab.router.reply_codec_errors == 1
        assert fab.telemetry.global_snapshot()["reply_codec_errors"] == 1
        r, _ = fab.session("t").submit(_batch()).result(timeout=TIMEOUT)
        assert "p" in r
    finally:
        fab.stop()


def test_all_shards_dead_raises_no_shards():
    fab = _fabric(n_shards=1, autostart=False)
    try:
        victim = fab.shard_ids()[0]
        fut = fab.session("t").submit(_batch())
        fab.fail_shard(victim)
        with pytest.raises(NoShardsError):
            fut.result(timeout=10)
    finally:
        fab.stop()


def test_drain_shard_reroutes_new_work_and_keeps_results():
    fab = _fabric(n_shards=2)
    try:
        fab.session("t").submit(_batch()).result(timeout=TIMEOUT)
        victim = fab.shard_ids()[0]
        fab.drain_shard(victim, timeout=30)
        assert victim not in fab.shard_ids()
        r, rep = fab.session("t").submit(_batch(kind="rmse")).result(
            timeout=TIMEOUT)
        assert "p" in r and rep.shard_id == fab.shard_ids()[0]
        assert fab.telemetry.global_snapshot()["shards_drained"] == 1
        assert fab.telemetry.snapshot()["t"]["jobs_completed"] == 2
    finally:
        fab.stop()


def test_add_shard_extends_ring_and_serves():
    fab = _fabric(n_shards=1)
    try:
        new = fab.add_shard()
        assert len(fab.shard_ids()) == 2
        key = _key_for_shard(fab, new)
        r, rep = fab.session("t").submit(_batch(), affinity=key).result(
            timeout=TIMEOUT)
        assert "p" in r and rep.shard_id == new
    finally:
        fab.stop()


# ---------------------------------------------------------------------------
# telemetry aggregation + drivers
# ---------------------------------------------------------------------------

def test_merge_tenant_snapshots_sums_and_maxes():
    a = {"t": {"jobs_completed": 1, "queue_wait_s": 0.5,
               "queue_wait_max_s": 0.5, "per_backend": {"torch": 2}}}
    b = {"t": {"jobs_completed": 2, "queue_wait_s": 0.25,
               "queue_wait_max_s": 0.75, "per_backend": {"torch": 1,
                                                         "python": 4}},
         "u": {"jobs_completed": 1, "queue_wait_s": 0.0,
               "queue_wait_max_s": 0.0, "per_backend": {}}}
    m = merge_tenant_snapshots([a, b])
    assert m["t"]["jobs_completed"] == 3
    assert m["t"]["queue_wait_s"] == pytest.approx(0.75)
    assert m["t"]["queue_wait_max_s"] == pytest.approx(0.75)
    assert m["t"]["per_backend"] == {"torch": 3, "python": 4}
    assert m["u"]["jobs_completed"] == 1


def test_session_telemetry_merges_across_shards():
    fab = _fabric(n_shards=3)
    try:
        ses = fab.session("t")
        ses.submit(_batch()).result(timeout=TIMEOUT)
        ses.submit(_batch(data_seed=5)).result(timeout=TIMEOUT)
        snap = ses.telemetry
        assert snap["jobs_completed"] == 2
        assert snap["jobs_submitted"] == 2
    finally:
        fab.stop()


@pytest.fixture(scope="module")
def shard_snapshots():
    """Telemetry of two real port services (one traced with windows, one
    with a controller), and a retired one: the snapshots both packages'
    ``FabricTelemetry`` aggregate."""
    from repro_torch.service import ControlPolicy
    out = []
    for kw in (dict(), dict(control=ControlPolicy()), dict()):
        svc = StratumService(memory_budget_bytes=1 << 30, n_executors=1,
                             coalesce_window_s=0.0, compiled_segments=False,
                             device="cpu", **kw)
        try:
            for i, tenant in enumerate(("a", "b")):
                svc.session(tenant).submit(
                    _batch(cols=(10 + i, 11)), deadline_s=300.0).result(
                    timeout=TIMEOUT)
            out.append((svc.telemetry.snapshot(),
                        svc.telemetry.global_snapshot()))
        finally:
            svc.stop()
    return out


class _FrozenTelemetry:
    def __init__(self, snap, glob):
        self._snap, self._glob = snap, glob

    def snapshot(self):
        return pickle.loads(pickle.dumps(self._snap))

    def global_snapshot(self):
        return pickle.loads(pickle.dumps(self._glob))


def _frozen_shard(snap, glob, depth):
    return SimpleNamespace(telemetry=_FrozenTelemetry(snap, glob),
                           queue_depth=lambda: depth,
                           inflight=lambda: depth // 2)


def _fake_router(pkg_ring):
    r = SimpleNamespace(envelopes_routed={"shard-0": 3, "shard-1": 4,
                                          "shard-2": 1},
                        locality_hits=5, locality_lookups=6,
                        failover_requeues=2, shards_failed=1,
                        shards_added=3, shards_drained=0,
                        reply_codec_errors=0, cancels_sent=1,
                        cancels_confirmed=1)
    r.pending_count = lambda shard_id=None: {"shard-0": 1}.get(shard_id, 0)
    r.locality_hit_rate = lambda: 5 / 6
    return r


def test_fabric_telemetry_merges_equal_the_reference(shard_snapshots):
    """The same router counters and shard snapshots give the reference's
    per-shard rows, fabric-wide totals (plan cache, deadlines, windows,
    control), merged tenants and report text."""
    views = {}
    for name, cls in (("port", FabricTelemetry),
                      ("ref", JF.FabricTelemetry)):
        live = {f"shard-{i}": _frozen_shard(*shard_snapshots[i], depth=i)
                for i in range(2)}
        tel = cls(_fake_router(name), lambda live=live: dict(live))
        tel.retire("shard-2", _frozen_shard(*shard_snapshots[2], depth=0))
        views[name] = (tel.per_shard(), tel.global_snapshot(),
                       tel.snapshot(), tel.report())
    port, ref = views["port"], views["ref"]
    assert port == ref
    g = port[1]
    assert g["n_shards"] == 2 and g["per_shard"]["shard-2"]["retired"]
    assert g["deadline"]["jobs"] == 6 and "control" in g
    assert "windows" in g and g["windows"]["completed"] == 6


def test_async_aide_search_on_fabric_with_shard_affinity():
    from repro_torch.agents import AIDEAgent, AsyncAIDESearch
    fab = _fabric(n_shards=3, coalesce_window_s=0.02)
    try:
        agent = AIDEAgent(n_rows=2000, cv_k=2, seed=0)
        search = AsyncAIDESearch(fab.session("aide"), agent,
                                 batch_size=2, max_inflight=2,
                                 shard_affinity=True)
        best = search.run(n_rounds=2)
        assert best is not None and best.score is not None
        assert len(agent.nodes) == 4
        routed = [s["envelopes_routed"] for s in
                  fab.telemetry.per_shard().values()]
        assert sorted(routed) == [0, 0, 2]
        assert fab.telemetry.snapshot()["aide"]["jobs_completed"] == 2
    finally:
        fab.stop()


def _placements(pkg):
    """Eight jobs over four datasets on a 2-shard fabric of ``pkg``: each
    job's shard and score."""
    if pkg == "ref":
        tab, Batch = JT, JBatch
        fab = JF.ShardedStratum(n_shards=2, memory_budget_bytes=1 << 30,
                                n_executors=1, coalesce_window_s=0.0)
    else:
        tab, Batch = T, PipelineBatch
        fab = _fabric(n_shards=2)
    try:
        futs = [fab.session(f"t{i % 3}").submit(Batch(
            [_pipeline(n_rows=1000, data_seed=i % 4, cols=(10, 11 + i % 3),
                       kind=("mae", "rmse")[i % 2], tab=tab)], ["p"]))
            for i in range(8)]
        out = []
        for f in futs:
            res, rep = f.result(timeout=TIMEOUT)
            out.append((rep.shard_id, float(np.asarray(res["p"]))))
        return out
    finally:
        fab.stop()


def test_two_shard_fabric_places_and_scores_as_the_reference():
    port, ref = _placements("port"), _placements("ref")
    assert [s for s, _ in port] == [s for s, _ in ref]
    assert len({s for s, _ in port}) == 2       # both shards served
    for (_, p), (_, r) in zip(port, ref):
        assert np.isfinite(p)
        np.testing.assert_allclose(p, r, rtol=2e-3, atol=2e-3)


def test_client_tags_and_deadline_on_the_fabric_target():
    """``tests/test_client.py``'s fabric case: tags and the deadline
    verdict come back on the fabric target's report."""
    cfg = StratumConfig.make(memory_budget_bytes=1 << 30, n_executors=1,
                             coalesce_window_s=0.0, compiled_segments=False,
                             device="cpu", n_shards=2)
    with connect("fabric", cfg) as c:
        assert c.target == "fabric" and c.fabric.device.type == "cpu"
        _, report = c.submit(
            _batch(), SubmitOptions(deadline_s=120, tags=("x", "y"))
            ).result(timeout=TIMEOUT)
        assert tuple(report.tags) == ("x", "y")
        assert report.deadline_met is True
        # the pre-flight analysis runs on the client side, on fake tensors
        assert c.analyze(_batch()).ok
    with pytest.raises(ValueError, match="processes=True"):
        connect("fabric", StratumConfig.make(device="cpu", autoscale=(1, 2)))


# ---------------------------------------------------------------------------
# shard-aware cancellation (CancelEnvelope through the codec)
# ---------------------------------------------------------------------------

def test_cancel_envelope_codec_round_trip():
    env = CancelEnvelope(envelope_id="c-7", tenant="t", attempt=2)
    out = decode_cancel(encode_cancel(env))
    assert (out.envelope_id, out.tenant, out.attempt) == ("c-7", "t", 2)
    with pytest.raises(CodecError):
        decode_cancel(encode_job(JobEnvelope(
            envelope_id="x", tenant="t", priority=1, routing_key="k",
            batch=_batch())))


def test_fabric_cancel_removes_queued_work_on_owning_shard():
    fab = _fabric(n_shards=2, autostart=False)
    try:
        ses = fab.session("t")
        futs = [ses.submit(_batch(name=f"p{i}", data_seed=i),
                           affinity="pin") for i in range(3)]
        depths = {sid: row["queue_depth"] for sid, row in
                  fab.telemetry.per_shard().items()}
        owner = max(depths, key=depths.get)
        assert depths[owner] == 3
        assert futs[1].cancel() is True
        assert futs[1].cancelled()
        with pytest.raises(CancelledError):
            futs[1].result(timeout=5)
        assert fab.telemetry.per_shard()[owner]["queue_depth"] == 2
        assert fab.router.pending_count() == 2
        g = fab.telemetry.global_snapshot()
        assert g["cancels_sent"] == 1 and g["cancels_confirmed"] == 1
        assert fab.telemetry.snapshot()["t"]["jobs_cancelled"] == 1
        fab.start()
        for f in (futs[0], futs[2]):
            res, _ = f.result(timeout=TIMEOUT)
            assert all(np.isfinite(float(v)) for v in res.values())
    finally:
        fab.start()
        fab.stop()


def test_fabric_cancel_after_completion_returns_false():
    fab = _fabric(n_shards=1)
    try:
        fut = fab.session("t").submit(_batch())
        fut.result(timeout=TIMEOUT)
        assert fut.cancel() is False
        assert not fut.cancelled()
        assert fab.router.cancel("no-such-envelope") is False
    finally:
        fab.stop()


# ---------------------------------------------------------------------------
# SubmitOptions on the wire: deadline/tags through the envelope codec
# ---------------------------------------------------------------------------

def test_job_envelope_carries_deadline_and_tags_through_the_codec():
    batch = _batch()
    env = JobEnvelope(envelope_id="e-1", tenant="t", priority=1,
                      routing_key=routing_key_for(batch), batch=batch,
                      deadline_s=1.5, tags=("probe", "r3"))
    out = decode_job(encode_job(env))
    assert out.deadline_s == 1.5
    assert out.tags == ("probe", "r3")
    assert out.deadline_t is None
    bare = decode_job(encode_job(JobEnvelope(
        envelope_id="e-2", tenant="t", priority=1,
        routing_key=env.routing_key, batch=batch)))
    assert bare.deadline_s is None and bare.tags == ()


def test_deadline_envelope_corruption_still_raises_codec_error():
    env = JobEnvelope("e", "t", 1, "rk", _batch(), deadline_s=2.0,
                      tags=("x",))
    data = encode_job(env)
    flipped = data[:40] + bytes([data[40] ^ 0xFF]) + data[41:]
    with pytest.raises(CodecError):
        decode_job(flipped)


def test_stale_attempt_reply_dropped_for_deadline_job():
    fab = _fabric(n_shards=1, autostart=False)
    try:
        fut = fab.session("t").submit(_batch(), deadline_s=300.0,
                                      tags=("slo",))
        (eid, pending), = fab.router._pending.items()
        assert pending.envelope.deadline_s is not None
        pending.envelope.attempt += 1
        stale = encode_result(ResultEnvelope(
            envelope_id=eid, tenant="t", shard_id="s", ok=True,
            results={"p": np.zeros(1)},
            report=FabricJobReport(tenant="t", envelope_id=eid,
                                   shard_id="s"),
            attempt=0))
        fab.router._on_result(stale)
        assert not fut.done()
        assert fab.router.pending_count() == 1
    finally:
        fab.stop()


def test_fabric_future_resolves_deadline_exceeded_like_an_error():
    fab = _fabric(n_shards=2)
    try:
        ses = fab.session("t")
        with pytest.raises(DeadlineExceeded):
            ses.submit(_batch(), deadline_s=1e-9).result(timeout=60)
        fut = ses.submit(_batch(), deadline_s=1e-9)
        assert isinstance(fut.exception(timeout=60), DeadlineExceeded)
        assert fut.done() and not fut.cancelled()
        d = fab.telemetry.global_snapshot()["deadline"]
        assert d["jobs"] == 2 and d["shed"] == 2 and d["met"] == 0
    finally:
        fab.stop()


def test_remaining_deadline_shrinks_at_reencode_on_failover():
    fab = _fabric(n_shards=2, autostart=False)
    try:
        victim = fab.shard_ids()[0]
        fut = fab.session("t").submit(
            _batch(), deadline_s=300.0,
            affinity=_key_for_shard(fab, victim))
        (eid, pending), = fab.router._pending.items()
        sent_first = pending.envelope.deadline_s
        time.sleep(0.05)
        assert fab.fail_shard(victim) == 1
        sent_second = fab.router._pending[eid].envelope.deadline_s
        assert sent_second < sent_first <= 300.0
        fab.start()
        results, report = fut.result(timeout=180)
        assert "p" in results and report.deadline_met is True
    finally:
        fab.stop()
