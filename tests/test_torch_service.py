"""The port's single-process service (``repro_torch.service``) against
``repro.service``: the counterpart of ``tests/test_service.py`` and
``tests/test_scheduling.py``.

* The fair queue: the same scripted pushes, pops, requeues, cancels and
  closes on both packages give the same rounds — bands by weighted fair
  queuing, starvation aging (on a scripted clock), earliest deadline
  first, shedding, tight-slack jobs popped alone, admission limits.
* Coalescing and cross-agent dedup give the same accounting.
* The paper's four-tenant split of iteration 1 (tenant *i* submits the two
  pipelines of model *i*, ``autostart=False``, then ``start()``) runs as one
  super-batch on both, with the same coalescing, sharing and per-tier
  counts ("torch" for "jax", "torch-seg" for "jax-seg"), and the scores
  agree within ``tests/test_tabular.py``'s tolerances.
* The service's behaviour on the port: the shared cache across tenants,
  failure isolation, admission, cancellation, restart, preemption with an
  exact salvage, deadlines and their telemetry.

Every wait has a timeout; deterministic rounds use ``autostart=False``;
preemption waits on an event.  Services run on the CPU; the behaviour
tests turn compiled segments off (the split runs at the defaults).
"""

import threading
import time
from collections import Counter
from concurrent.futures import CancelledError
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.service as JS
import repro.service.queue as j_queue
import repro.tabular as JT
import repro_torch.service as S
import repro_torch.service.queue as t_queue
import repro_torch.tabular as T
from repro.service.coalesce import reachable_sigs as j_reachable_sigs
from repro.agents.aide import PipelineSpec as JSpec
from repro.core import PipelineBatch as JBatch
from repro_torch.agents.aide import MODELS, PREPROCS, PipelineSpec
from repro_torch.client import SubmitOptions
from repro_torch.core import GENERIC, LazyOp, PipelineBatch, Stratum
from repro_torch.core.runtime import ExecutionError
from repro_torch.service.coalesce import reachable_sigs

TIMEOUT = 120

PKGS = {
    "ref": SimpleNamespace(svc=JS, queue=j_queue,
                           reachable_sigs=j_reachable_sigs),
    "port": SimpleNamespace(svc=S, queue=t_queue,
                            reachable_sigs=reachable_sigs),
}


class FakeTime:
    """Stands in for the ``time`` module of ``service/queue.py``: the
    queue reads only ``perf_counter``."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def perf_counter(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# the fair queue: scripted rounds, equal on both packages
# ---------------------------------------------------------------------------

def _ids(jobs):
    return [j.id for j in jobs]


def _script_bands(ns, clk):
    P = ns.svc.Priority
    q, job = ns.svc.FairQueue(), ns.job
    for i in range(5):
        q.push(job(i, "bulk"))
    q.push(job(99, "probe", P.INTERACTIVE))
    out = [_ids(q.pop_round(max_jobs=4, max_per_tenant=4))]
    assert out[0] == [99]             # rounds are single-band
    out.append(_ids(q.pop_round(max_jobs=4, max_per_tenant=4)))
    return out


def _script_wfq(ns, clk):
    P = ns.svc.Priority
    q = ns.svc.FairQueue(weights={P.INTERACTIVE: 3, P.BATCH: 1,
                                  P.SCAVENGER: 0}, aging_s=None)
    for i in range(20):
        q.push(ns.job(i, "i", P.INTERACTIVE))
        q.push(ns.job(100 + i, "b", P.BATCH))
    served = [int(q.pop_round(max_jobs=1)[0].priority) for _ in range(8)]
    assert Counter(served) == {0: 6, 1: 2}
    return served


def _script_weight_zero(ns, clk):
    P = ns.svc.Priority
    q = ns.svc.FairQueue(weights={P.INTERACTIVE: 1, P.BATCH: 0,
                                  P.SCAVENGER: 0}, aging_s=None)
    q.push(ns.job(0, "s", P.SCAVENGER))
    q.push(ns.job(1, "i", P.INTERACTIVE))
    return [_ids(q.pop_round(max_jobs=1)), _ids(q.pop_round(max_jobs=1))]


def _script_blind(ns, clk):
    P = ns.svc.Priority
    q = ns.svc.FairQueue(priority_aware=False)
    q.push(ns.job(0, "a", P.SCAVENGER))
    q.push(ns.job(1, "b", P.INTERACTIVE))
    return _ids(q.pop_round(max_jobs=2, max_per_tenant=1))


def _script_has_work_above(ns, clk):
    P = ns.svc.Priority
    q, out = ns.svc.FairQueue(), []
    for i, p in enumerate((P.SCAVENGER, P.BATCH, P.INTERACTIVE)):
        q.push(ns.job(i, "t", p))
        out.append([q.has_work_above(int(b)) for b in P])
    return out


def _script_requeue(ns, clk):
    q = ns.svc.FairQueue(aging_s=None)
    q.push(ns.job(0, "a"))
    q.push(ns.job(1, "a"))
    first = q.pop_round(max_jobs=1, max_per_tenant=1)
    q.requeue(first)
    return [_ids(first), _ids(q.pop_round(max_jobs=1, max_per_tenant=1))]


def _script_aging(ns, clk):
    """Strict weights, sustained interactive load: the scavenger job is
    promoted one band per ``aging_s`` and then served."""
    P = ns.svc.Priority
    q = ns.svc.FairQueue(weights={P.INTERACTIVE: 1, P.BATCH: 0,
                                  P.SCAVENGER: 0}, aging_s=0.05)
    scav = ns.job(999, "s", P.SCAVENGER)
    q.push(scav)
    rounds, nxt = [], 0
    for _ in range(30):
        while q.pending_by_band()[int(P.INTERACTIVE)] < 2:
            q.push(ns.job(nxt, "i", P.INTERACTIVE))
            nxt += 1
        jobs = q.pop_round(max_jobs=1)
        rounds.append((_ids(jobs), scav.band))
        if 999 in _ids(jobs):
            break
        clk.advance(0.02)
    assert rounds[-1][0] == [999] and scav.band == int(P.INTERACTIVE)
    return rounds


def _script_flood(ns, clk):
    q = ns.svc.FairQueue()
    for i in range(10):
        q.push(ns.job(i, "flood"))
    q.push(ns.job(100, "small"))
    out = _ids(q.pop_round(max_jobs=4, max_per_tenant=2))
    assert 100 in out and len(out) == 3
    return out


def _script_edf(ns, clk):
    q = ns.svc.FairQueue()
    q.push(ns.job(0, "bulk-a"))
    q.push(ns.job(1, "bulk-b"))
    q.push(ns.job(2, "slo-loose", deadline_s=60.0))
    q.push(ns.job(3, "slo-tight", deadline_s=10.0))
    across = [j.tenant for j in q.pop_round(max_jobs=4, max_per_tenant=1)]
    assert across == ["slo-tight", "slo-loose", "bulk-a", "bulk-b"]
    q.push(ns.job(4, "t", deadline_s=60.0))
    q.push(ns.job(5, "t", deadline_s=5.0))
    q.push(ns.job(6, "t"))
    within = _ids(q.pop_round(max_jobs=3, max_per_tenant=3))
    assert within == [5, 4, 6]
    return across, within


def _script_shed(ns, clk):
    q = ns.svc.FairQueue()
    shed = []
    q.on_shed = shed.append
    job = ns.job(0, "t", deadline_s=1e-3)
    q.push(ns.job(1, "t"))
    q.push(job)
    clk.advance(0.002)
    out = _ids(q.pop_round(max_jobs=4, max_per_tenant=4))
    with pytest.raises(ns.svc.DeadlineExceeded):
        job.future.result(timeout=0)
    return out, _ids(shed), q.pending()


def _script_tight(ns, clk):
    P = ns.svc.Priority
    q = ns.svc.FairQueue()
    q.push(ns.job(0, "bulk-a"))
    q.push(ns.job(1, "bulk-b"))
    q.push(ns.job(2, "slo", deadline_s=0.2))
    solo = [j.tenant for j in q.pop_round(max_jobs=4, max_per_tenant=1,
                                           tight_slack_s=1.0)]
    q.push(ns.job(3, "slo", deadline_s=0.2))
    more = _ids(q.pop_round(max_jobs=4, max_per_tenant=1,
                            band=int(P.BATCH), tight_slack_s=1.0))
    return solo, more, q.pending()


def _script_deadline_blind(ns, clk):
    q = ns.svc.FairQueue(deadline_aware=False)
    q.push(ns.job(0, "bulk"))
    q.push(ns.job(1, "slo", deadline_s=1e-3))
    clk.advance(0.002)
    out = q.pop_round(max_jobs=4, max_per_tenant=1, tight_slack_s=1.0)
    return _ids(out), out[1].deadline_t is not None


def _script_deadline_total(ns, clk):
    q, trail = ns.svc.FairQueue(), []
    for j in (ns.job(0, "t", deadline_s=60.0), ns.job(1, "t"),
              ns.job(2, "u", deadline_s=1e-3),
              ns.job(3, "u", deadline_s=60.0)):
        q.push(j)
    trail.append(q._deadline_total)
    clk.advance(0.002)
    out = q.pop_round(max_jobs=1, max_per_tenant=1)
    trail += [_ids(out), q._deadline_total]
    q.requeue(out)
    trail += [q._deadline_total, q.cancel(3), q._deadline_total]
    trail += [_ids(q.close()), q._deadline_total]
    return trail


def _script_admission(ns, clk):
    """Per-tenant and total limits, the INTERACTIVE reserve, band gates."""
    P, Err = ns.svc.Priority, ns.svc.AdmissionError
    q, trail = ns.svc.FairQueue(max_queued_total=3,
                                max_queued_per_tenant=2), []

    def push(job):
        try:
            q.push(job)
            trail.append(("ok", job.id))
        except Err as e:
            trail.append(("refused", job.id, str(e)))

    push(ns.job(0, "greedy"))
    push(ns.job(1, "greedy"))
    push(ns.job(2, "greedy"))                 # per-tenant quota
    push(ns.job(3, "other"))
    push(ns.job(4, "third"))                  # global depth
    q.set_limits(max_queued_total=64, band_limits={int(P.BATCH): 3},
                 reserve_interactive=2)
    push(ns.job(5, "fourth"))                 # the BATCH band's gate
    push(ns.job(6, "probe", P.INTERACTIVE))
    trail.append(q.pending_by_band())
    return trail


QUEUE_SCRIPTS = {f.__name__[len("_script_"):]: f for f in (
    _script_bands, _script_wfq, _script_weight_zero, _script_blind,
    _script_has_work_above, _script_requeue, _script_aging, _script_flood,
    _script_edf, _script_shed, _script_tight, _script_deadline_blind,
    _script_deadline_total, _script_admission)}


def _run_script(script, pkg, monkeypatch):
    ns = PKGS[pkg]
    clk = FakeTime()
    monkeypatch.setattr(ns.queue, "time", clk)
    P = ns.svc.Priority

    def job(i, tenant="t", priority=P.BATCH, deadline_s=None):
        return ns.svc.Job(id=i, tenant=tenant, batch=None,
                          future=ns.svc.PipelineFuture(i, tenant, priority),
                          priority=priority, submit_t=clk.perf_counter(),
                          deadline_s=deadline_s)

    return script(SimpleNamespace(svc=ns.svc, job=job), clk)


@pytest.mark.parametrize("name", sorted(QUEUE_SCRIPTS))
def test_fair_queue_rounds_equal_the_references(name, monkeypatch):
    script = QUEUE_SCRIPTS[name]
    assert _run_script(script, "port", monkeypatch) == \
        _run_script(script, "ref", monkeypatch)


def test_priority_and_weights_equal_the_references():
    assert [(p.name, int(p)) for p in S.Priority] == \
        [(p.name, int(p)) for p in JS.Priority]
    assert {int(k): v for k, v in S.DEFAULT_WEIGHTS.items()} == \
        {int(k): v for k, v in JS.DEFAULT_WEIGHTS.items()}
    assert sorted(S.__all__) == sorted(JS.__all__)


# ---------------------------------------------------------------------------
# coalescing and cross-agent dedup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigs,tenants", [
    ([{"s1", "s2", "shared"}, {"s3", "shared"}], ["a", "b"]),
    ([{"s1", "s2", "shared"}, {"s3", "shared"}], ["a", "a"]),
    ([{"x", "y"}, {"x", "y", "z"}, {"y", "z"}, {"w"}], ["a", "b", "c", "a"]),
])
def test_cross_agent_dedup_equals_the_references(sigs, tenants):
    got = S.cross_agent_dedup(sigs, tenants)
    assert got == JS.cross_agent_dedup(sigs, tenants)
    if tenants == ["a", "b"]:
        assert got == (1, {"a": 1, "b": 1})


def _merge(pkg):
    """Three jobs of two tenants through ``coalesce``: the merged names,
    each job's sinks and reachable signatures, and the split of results."""
    ns = PKGS[pkg]
    tab, Batch = (JT, JBatch) if pkg == "ref" else (T, PipelineBatch)
    x = tab.read("uk_housing", 300, seed=0)
    a = tab.metric(tab.project(x, [0]), tab.project(x, [1]), kind="mae")
    b = tab.metric(tab.project(x, [0]), tab.project(x, [2]), kind="mae")
    jobs = [SimpleNamespace(id=i, tenant=t, batch=bt) for i, (t, bt) in
            enumerate((("p", Batch([a], ["one"])),
                       ("q", Batch([a, b], ["one", "two"])),
                       ("p", Batch([b], ["three"]))))]
    sb = ns.svc.coalesce(jobs)
    sinks = sb.batch.fused_sinks()
    reach = [sorted(ns.reachable_sigs(sb.job_sinks(sinks, j)))
             for j in range(len(jobs))]
    split = sb.split_results({n: n for n in sb.batch.names})
    dedup = ns.svc.cross_agent_dedup([set(r) for r in reach],
                                     [j.tenant for j in jobs])
    return list(sb.batch.names), reach, split, dedup


def test_coalesce_and_split_equal_the_references():
    port, ref = _merge("port"), _merge("ref")
    assert port == ref
    names, reach, split, dedup = port
    assert [set(s) for s in split] == [{"one"}, {"one", "two"}, {"three"}]
    assert dedup[0] > 0


# ---------------------------------------------------------------------------
# the four-tenant split of iteration 1
# ---------------------------------------------------------------------------

SPLIT_ROWS = 2000
# the reference's counts (any row count): one super-batch; each job
# coalesced with 3 and sharing 45 ops across agents; 135 deduped
SPLIT_BACKENDS = {"torch": 35, "torch-seg": 16, "python": 14}


def _split(pkg):
    svc_mod, Spec, Batch, kw = (
        (JS, JSpec, JBatch, {}) if pkg == "ref"
        else (S, PipelineSpec, PipelineBatch, {"device": "cpu"}))
    svc = svc_mod.StratumService(memory_budget_bytes=16 << 30,
                                 hardware_threads=8, coalesce_window_s=0.05,
                                 autostart=False, **kw)
    futs = []
    for i, model in enumerate(MODELS):
        specs = [Spec(preproc=p, model=model, cv_k=3, n_rows=SPLIT_ROWS,
                      seed=7) for p in PREPROCS]
        futs.append(svc.session(f"agent-{i}").submit(Batch(
            [s.build() for s in specs],
            [f"{s.preproc}+{s.model}" for s in specs])))
    svc.start()
    try:
        out = [f.result(timeout=300) for f in futs]
        return out, svc.telemetry.global_snapshot()
    finally:
        svc.stop()


@pytest.fixture(scope="module")
def split_runs():
    return {pkg: _split(pkg) for pkg in ("port", "ref")}


def test_split_shares_work_as_the_reference_does(split_runs):
    (port, pg), (ref, rg) = split_runs["port"], split_runs["ref"]
    assert pg["super_batches"] == rg["super_batches"] == 1
    assert pg["ops_deduped_cross_agent"] == \
        rg["ops_deduped_cross_agent"] == 135
    for (_, p), (_, r) in zip(port, ref):
        assert (p.coalesced_with, p.ops_shared_cross_agent, p.cache_hits) \
            == (r.coalesced_with, r.ops_shared_cross_agent, r.cache_hits) \
            == (3, 45, 0)
        assert p.per_backend == {k.replace("jax", "torch"): v
                                 for k, v in r.per_backend.items()}
        assert p.per_backend == SPLIT_BACKENDS


def test_split_scores_match_the_reference(split_runs):
    port, ref = split_runs["port"][0], split_runs["ref"][0]
    for (p, _), (r, _) in zip(port, ref):
        assert set(p) == set(r) and len(p) == 2
        for name in p:
            got, want = float(p[name]), float(np.asarray(r[name]))
            assert np.isfinite(got)
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# the service on the port
# ---------------------------------------------------------------------------

def _pipeline(n_rows=1000, cols=(10, 11, 12), kind="mae"):
    x = T.read("uk_housing", n_rows, seed=0)
    xs = T.scale(T.impute(T.project(x, list(cols))))
    return T.metric(T.project(xs, [0]), T.project(x, [0]), kind=kind)


def _batch(name="p", **kw):
    return PipelineBatch([_pipeline(**kw)], [name])


def _boom(*_a, **_k):
    raise ValueError("poisoned op")


def _poison_batch():
    sink = LazyOp("boom", GENERIC, spec={"fn": _boom},
                  inputs=(_pipeline(n_rows=500),)).out()
    return PipelineBatch([sink], ["bad"])


def _service(**kw):
    kw.setdefault("memory_budget_bytes", 1 << 30)
    kw.setdefault("n_executors", 2)
    kw.setdefault("compiled_segments", False)
    kw.setdefault("device", "cpu")
    return S.StratumService(**kw)


def _val(res, name="p"):
    return float(res[name])


def test_service_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        S.StratumService(autostart=False)
    svc = _service(autostart=False)
    assert svc.device == torch.device("cpu")
    assert svc._optimizer.device == torch.device("cpu")
    svc.stop()


def test_concurrent_sessions_share_cache():
    # at 6,000 rows (as the reference's test) the scaled block is worth
    # caching; at 1,000 neither package caches it
    svc = _service(coalesce_window_s=0.0)
    try:
        ref, _ = Stratum(memory_budget_bytes=1 << 30, device="cpu",
                         compiled_segments=False).run_batch(
            _batch(n_rows=6000))
        r1, _ = svc.session("t1").submit(_batch(n_rows=6000)).result(
            timeout=TIMEOUT)
        r2, rep2 = svc.session("t2").submit(_batch(n_rows=6000)).result(
            timeout=TIMEOUT)
        assert _val(r1) == pytest.approx(_val(ref), rel=1e-6)
        assert _val(r2) == pytest.approx(_val(ref), rel=1e-6)
        assert rep2.cache_hits > 0
        snap = svc.telemetry.snapshot()
        assert snap["t2"]["cache_hits"] > 0
        assert snap["t1"]["jobs_completed"] == 1
        assert svc.telemetry.global_snapshot()["cache_cross_tenant_hits"] > 0
    finally:
        svc.stop()


def _second_tenant_reuse(pkg, budget):
    """Tenant t1 runs a 6,000-row batch, then t2 the same one: t2's cache
    hits (cross-tenant), the cache's evictions, t2's score."""
    tab, Batch, kw = ((T, PipelineBatch, {"device": "cpu"}) if pkg == "port"
                      else (JT, JBatch, {}))
    x = tab.read("uk_housing", 6000, seed=0)
    xs = tab.scale(tab.impute(tab.project(x, [10, 11, 12])))
    batch = Batch([tab.metric(tab.project(xs, [0]), tab.project(x, [0]),
                              kind="mae")], ["p"])
    svc = PKGS[pkg].svc.StratumService(
        memory_budget_bytes=budget, n_executors=1, coalesce_window_s=0.0,
        compiled_segments=False, **kw)
    try:
        svc.session("t1").submit(batch).result(timeout=TIMEOUT)
        res, rep = svc.session("t2").submit(batch).result(timeout=TIMEOUT)
        g = svc.telemetry.global_snapshot()
        return (rep.cache_hits, g["cache_cross_tenant_hits"],
                g["cache_evictions_by_tenant"], float(np.asarray(res["p"])))
    finally:
        svc.stop()


@pytest.mark.parametrize("budget", [1 << 30, 1 << 18])
def test_cross_tenant_cache_hits_need_room(budget):
    """With room in the shared cache (10% of the budget) the second tenant
    reads the first one's intermediates; with a cache smaller than them
    nothing is kept, and both packages read no cross-tenant hit."""
    port, ref = _second_tenant_reuse("port", budget), \
        _second_tenant_reuse("ref", budget)
    assert port[:3] == ref[:3]
    np.testing.assert_allclose(port[3], ref[3], rtol=2e-3, atol=2e-3)
    assert (port[1] > 0) == (budget == 1 << 30)


def test_many_tenants_results_stay_isolated():
    svc = _service(coalesce_window_s=0.05, autostart=False)
    try:
        kinds, cols = ["mae", "rmse", "mae", "rmse"], [(10, 11)] * 2 + \
            [(11, 12)] * 2
        futs = [svc.session(f"t{i}").submit(_batch(kind=k, cols=c))
                for i, (k, c) in enumerate(zip(kinds, cols))]
        svc.start()
        res = [f.result(timeout=TIMEOUT)[0] for f in futs]
        assert all(set(r) == {"p"} for r in res)
        assert _val(res[0]) != _val(res[1])
        for r, k, c in zip(res, kinds, cols):
            alone, _ = Stratum(device="cpu", compiled_segments=False
                               ).run_batch(_batch(kind=k, cols=c))
            assert _val(r) == _val(alone)
    finally:
        svc.stop()


def test_identical_subdags_of_two_tenants_execute_once():
    svc = _service(autostart=False, coalesce_window_s=0.05)
    try:
        f1 = svc.session("a").submit(_batch())
        f2 = svc.session("b").submit(_batch())
        svc.start()
        (r1, rep1), (r2, rep2) = (f1.result(timeout=TIMEOUT),
                                  f2.result(timeout=TIMEOUT))
        assert rep1.coalesced_with == rep2.coalesced_with == 1
        g = svc.telemetry.global_snapshot()
        assert g["super_batches"] == 1 and g["ops_deduped_cross_agent"] > 0
        assert rep1.ops_shared_cross_agent == \
            rep2.ops_shared_cross_agent > 0
        assert _val(r1) == _val(r2)
    finally:
        svc.stop()


def test_flooding_tenant_cannot_starve_another():
    svc = _service(autostart=False, coalesce_window_s=0.0,
                   coalesce_max_jobs=2, max_jobs_per_tenant_per_round=1,
                   n_executors=1)
    try:
        done = []
        futs = [svc.session("flood").submit(_batch(name=f"f{i}"))
                for i in range(6)]
        victim = svc.session("victim").submit(_batch())
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _f, i=i: done.append(f"flood{i}"))
        victim.add_done_callback(lambda _f: done.append("victim"))
        svc.start()
        victim.result(timeout=TIMEOUT)
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert "victim" in done[:4], done
    finally:
        svc.stop()


def test_admission_control_rejects_over_quota():
    svc = _service(autostart=False, max_queued_total=3,
                   max_queued_per_tenant=2)
    try:
        s = svc.session("greedy")
        s.submit(_batch())
        s.submit(_batch())
        with pytest.raises(S.AdmissionError):
            s.submit(_batch())
        svc.session("other").submit(_batch())
        with pytest.raises(S.AdmissionError):
            svc.session("third").submit(_batch())
    finally:
        svc.start()
        svc.stop()


def test_cancel_while_queued_and_after_dispatch():
    svc = _service(autostart=False)
    try:
        fut = svc.session("t").submit(_batch())
        assert fut.cancel() and fut.cancelled()
        with pytest.raises(CancelledError):
            fut.result(timeout=5)
        assert svc.telemetry.snapshot()["t"]["jobs_cancelled"] == 1
        svc.start()
        later = svc.session("t").submit(_batch())
        assert "p" in later.result(timeout=TIMEOUT)[0]
        assert not later.cancel()
    finally:
        svc.stop()


def test_execution_error_fails_only_the_poisoned_job():
    svc = _service(autostart=False, coalesce_window_s=0.05)
    try:
        bad = svc.session("bad").submit(_poison_batch())
        good = svc.session("good").submit(_batch())
        svc.start()
        with pytest.raises(ExecutionError) as ei:
            bad.result(timeout=TIMEOUT)
        assert isinstance(ei.value.cause, ValueError)
        res, _ = good.result(timeout=TIMEOUT)
        alone, _ = Stratum(device="cpu", compiled_segments=False
                           ).run_batch(_batch())
        assert _val(res) == _val(alone)
        snap, g = svc.telemetry.snapshot(), svc.telemetry.global_snapshot()
        assert snap["good"]["jobs_completed"] == 1
        assert snap["bad"]["jobs_failed"] == 1
        # the innocent job's re-run is no new super-batch
        assert g["super_batches"] == 1 and g["jobs_coalesced"] == 2
        # the service still answers
        assert "p" in svc.session("after").submit(_batch()).result(
            timeout=TIMEOUT)[0]
    finally:
        svc.stop()


def test_restart_and_stop_without_start():
    svc = _service()
    try:
        svc.session("t").submit(_batch()).result(timeout=TIMEOUT)
        svc.stop()
        with pytest.raises(S.AdmissionError):
            svc.session("t").submit(_batch())
        svc.start()
        assert "p" in svc.session("t").submit(_batch()).result(
            timeout=TIMEOUT)[0]
    finally:
        svc.stop()
    idle = _service(autostart=False)
    fut = idle.session("t").submit(_batch())
    idle.stop()                     # must not wait for a dispatcher
    with pytest.raises(S.AdmissionError):
        fut.result(timeout=5)


# ---------------------------------------------------------------------------
# cooperative preemption: completed intermediates are never lost
# ---------------------------------------------------------------------------

EXEC_COUNTS: Counter = Counter()
_EXEC_LOCK = threading.Lock()
_WAVES = {}                         # tag prefix -> (count, event)


def _slow_identity(x, tag="", delay=0.05):
    with _EXEC_LOCK:
        EXEC_COUNTS[tag] += 1
        for prefix, (n, event) in _WAVES.items():
            if tag.startswith(prefix) and sum(
                    v for k, v in EXEC_COUNTS.items()
                    if k.startswith(prefix)) >= n:
                event.set()
    time.sleep(delay)
    return x


def _chain_batch(name, depth, delay, tag):
    ref = T.project(T.read("uk_housing", 1000, seed=0), [0])
    for d in range(depth):
        ref = LazyOp(f"slow_{tag}_{d}", GENERIC,
                     spec={"fn": _slow_identity,
                           "kwargs": {"tag": f"{tag}{d}", "delay": delay}},
                     inputs=(ref,)).out()
    return PipelineBatch([ref], [name])


def _after_ops(tag, n):
    event = threading.Event()
    _WAVES[tag] = (n, event)
    return event


@pytest.mark.parametrize("priority,max_preemptions", [
    ("SCAVENGER", 8), ("SCAVENGER", 1), ("INTERACTIVE", 8)])
def test_preemption_salvages_every_completed_intermediate(
        priority, max_preemptions):
    """A running SCAVENGER chain yields to an INTERACTIVE probe at a wave
    boundary and resumes from its salvage (every slow op runs once); with
    a cap of 1 it yields at most once; an INTERACTIVE chain never yields."""
    tag = f"pre{priority[0]}{max_preemptions}_{time.monotonic_ns()}"
    started = _after_ops(tag, 3)
    svc = _service(n_executors=1, coalesce_window_s=0.0, aging_s=None,
                   autostart=False, max_preemptions_per_job=max_preemptions)
    order = []
    try:
        chain = svc.session("bulk").submit(
            _chain_batch("chain", 8, 0.05, tag),
            priority=S.Priority[priority])
        chain.add_done_callback(lambda _f: order.append("chain"))
        svc.start()
        assert started.wait(TIMEOUT)    # three waves done
        probes = [svc.session("probe").submit(
            _batch(name=f"q{i}"), priority=S.Priority.INTERACTIVE)
            for i in range(2 if max_preemptions == 1 else 1)]
        probes[0].add_done_callback(lambda _f: order.append("probe"))
        for i, p in enumerate(probes):
            assert f"q{i}" in p.result(timeout=TIMEOUT)[0]
        res, rep = chain.result(timeout=TIMEOUT)
        assert "chain" in res
        counts = {k: v for k, v in EXEC_COUNTS.items() if k.startswith(tag)}
        assert len(counts) == 8 and set(counts.values()) == {1}, counts
        if priority == "INTERACTIVE":
            assert rep.preemptions == 0
        else:
            assert order[0] == "probe", order
            assert 1 <= rep.preemptions <= max_preemptions
            assert rep.ops_salvaged > 0
            assert svc.telemetry.snapshot()["bulk"]["preemptions"] >= 1
    finally:
        _WAVES.pop(tag, None)
        svc.stop()


# ---------------------------------------------------------------------------
# deadlines, tags, telemetry
# ---------------------------------------------------------------------------

def test_deadline_attainment_telemetry_and_shed():
    svc = _service(n_executors=1, coalesce_window_s=0.0)
    try:
        ses = svc.session("t")
        _, rep = ses.submit(_batch(), deadline_s=120, tags=("probe",),
                            priority=S.Priority.INTERACTIVE).result(
            timeout=TIMEOUT)
        assert (rep.deadline_met, rep.deadline_s, rep.tags) == \
            (True, 120, ("probe",))
        with pytest.raises(S.DeadlineExceeded):
            ses.submit(_batch(), deadline_s=1e-9).result(timeout=TIMEOUT)
        snap = svc.telemetry.snapshot()["t"]
        assert (snap["deadline_jobs"], snap["deadline_met"],
                snap["deadline_shed"]) == (2, 1, 1)
        assert snap["submitted_by_priority"] == {"INTERACTIVE": 1,
                                                 "BATCH": 1}
        g = svc.telemetry.global_snapshot()
        assert g["deadline"] == {"jobs": 2, "met": 1, "shed": 1,
                                 "attainment": 0.5}
        report = svc.telemetry.report()
        assert "deadlines:" in report and "preemptions:" in report
    finally:
        svc.stop()


def test_session_options_tenant_override():
    svc = _service(n_executors=1, coalesce_window_s=0.0)
    try:
        svc.session("default-tenant").submit(
            _batch(), options=SubmitOptions(tenant="override")).result(
            timeout=TIMEOUT)
        snap = svc.telemetry.snapshot()
        assert "override" in snap and "default-tenant" not in snap
    finally:
        svc.stop()
