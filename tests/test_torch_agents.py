"""The port's AIDE search (``repro_torch.agents``) and the paper's §6
workload end to end at the client's defaults: the counterpart of
``tests/test_system.py``.

* ``AIDEAgent`` proposes the same specs as the reference's for the same
  seed (its randomness is ``random.Random`` and numpy, seeded alike), and
  the specs build pipelines with the reference's signatures.
* The paper workload (iteration 1: 2 preprocessings × 4 models; iteration
  2: the grid on the winner) runs through both packages at their defaults
  on one shared session each: the per-tier counts ("torch" for "jax",
  "torch-seg" for "jax-seg"), waves, plan-cache misses and hits and the
  iteration-2 cache hits are equal, the winner is the same, and the scores
  agree within 1e-3 relative (``tests/test_torch_core.py``'s tolerance).
* ``AsyncAIDESearch`` runs on a local client session, with speculative
  precompile hints when the session compiles asynchronously, and through
  the service (``examples/agentic_search.py``'s service mode, cut down):
  concurrent agents on threads, each best score the local target's for
  its spec, work shared across agents, nothing uncompilable.

Tables are 2,000 rows (the reference's test uses 6,000); sessions run on
the CPU.
"""

import dataclasses

import numpy as np
import pytest

from repro.agents import paper_workload_batches as j_paper
from repro.agents.aide import AIDEAgent as JAgent
from repro.agents.aide import second_iteration_batch as j_second
from repro.client import StratumConfig as JConfig
from repro.client import connect as j_connect
from repro_torch.agents import (AIDEAgent, AsyncAIDESearch,
                                paper_workload_batches)
from repro_torch.agents.aide import diff_fraction, second_iteration_batch
from repro_torch.client import StratumConfig, connect
from repro_torch.core import ALL_FEATURES, PipelineBatch, Stratum, annotate
import repro_torch.tabular as T

N_ROWS = 2000


def _counts(rep):
    return ({k.replace("jax", "torch"): v
             for k, v in rep.run.per_backend.items()}, rep.run.waves,
            rep.run.plan_cache_misses, rep.run.plan_cache_hits,
            rep.run.ops_from_cache, rep.ops_submitted, rep.ops_planned)


@pytest.fixture(scope="module")
def paper_runs():
    """Iteration 1 then iteration 2 on its winner, through each package at
    the client's defaults (one local client each, 4 GiB as
    ``examples/agentic_search.py``'s run_sync, 8 threads)."""
    out = {}
    for name, paper, second, conn, cfg in (
            ("ref", j_paper, j_second, j_connect,
             JConfig.make(memory_budget_bytes=4 << 30, hardware_threads=8)),
            ("port", paper_workload_batches, second_iteration_batch, connect,
             StratumConfig.make(memory_budget_bytes=4 << 30,
                                hardware_threads=8, device="cpu"))):
        client = conn("local", cfg)
        _n, batch, ctx = next(iter(paper(n_rows=N_ROWS, cv_k=3)))
        res1, rep1 = client.run_batch(batch)
        scores = {k: float(np.asarray(v)) for k, v in res1.items()}
        best = min(scores, key=scores.get)
        batch2, specs2 = second(ctx["specs"][best])
        res2, rep2 = client.run_batch(batch2)
        out[name] = dict(scores=scores, rep1=rep1, best=best,
                         scores2={k: float(np.asarray(v))
                                  for k, v in res2.items()},
                         rep2=rep2, client=client)
    return out


def test_paper_workload_iteration1_all_models_score(paper_runs):
    port, ref = paper_runs["port"], paper_runs["ref"]
    assert len(port["scores"]) == 8                  # 2 preproc × 4 models
    for name, score in port["scores"].items():
        assert np.isfinite(score), name
        assert 0.05 < score < 5.0, (name, score)
        want = ref["scores"][name]
        assert abs(score - want) <= 1e-3 * abs(want), (name, score, want)
    rep = port["rep1"]
    assert rep.rewrites.cse_merged > 20
    assert rep.rewrites.reads_shared >= 7
    assert _counts(rep) == _counts(ref["rep1"])
    assert rep.run.per_backend == {"torch": 71, "torch-seg": 16,
                                   "python": 38}
    assert port["client"].stratum.plan_cache.snapshot()["uncompilable"] == 0


def test_iteration2_reuses_iteration1_preprocessing(paper_runs):
    port, ref = paper_runs["port"], paper_runs["ref"]
    assert port["best"] == ref["best"]
    rep2 = port["rep2"]
    assert rep2.run.ops_from_cache > 0               # cross-iteration reuse
    assert _counts(rep2) == _counts(ref["rep2"])
    for name, score in port["scores2"].items():
        assert np.isfinite(score)
        want = ref["scores2"][name]
        assert abs(score - want) <= 1e-3 * abs(want), (name, score, want)
    assert port["client"].stratum.plan_cache.snapshot()["uncompilable"] == 0


def test_aide_agent_proposes_the_references_specs():
    """Same seed, same proposals, same mutations: the two agents' specs
    are equal field by field and build pipelines of equal signatures."""
    for seed in (0, 3, 11):
        a, b = AIDEAgent(n_rows=N_ROWS, seed=seed), \
            JAgent(n_rows=N_ROWS, seed=seed)
        for round_ in range(4):
            pa, pb = a.propose(4), b.propose(4)
            assert [dataclasses.asdict(s) for s in pa] == \
                [dataclasses.asdict(s) for s in pb]
            scores = [1.0 - 0.01 * (round_ * 4 + i) for i in range(4)]
            a.observe(pa, scores)
            b.observe(pb, scores)
        assert [dataclasses.asdict(s) for s in a.speculate()] == \
            [dataclasses.asdict(s) for s in b.speculate()]
        assert a.propose(1)[0].build().op.signature == \
            b.propose(1)[0].build().op.signature


def test_ablation_features_produce_identical_scores():
    base = None
    for enable in [(), ("logical",), ("logical", "lowering"),
                   ALL_FEATURES]:
        en = tuple(enable) + (("lowering",) if "lowering" not in enable
                              else ())
        s = Stratum(memory_budget_bytes=2 << 30, enable=en, device="cpu")
        x = T.read("uk_housing", N_ROWS, seed=0)
        y = T.project(x, [0])
        Xv = T.scale(T.impute(T.project(x, [10, 11, 12, 13])))
        sink = T.cv_score(Xv, y, {"name": "ridge_fit", "alpha": 1.0},
                          k=2, seed=5)
        out, _ = s.run(sink)
        val = float(np.asarray(out))
        if base is None:
            base = val
        assert abs(val - base) / base < 5e-3, (en, val, base)


def test_grid_search_shares_folds_across_grid_points():
    x = T.read("uk_housing", N_ROWS, seed=2)
    y = T.project(x, [0])
    Xv = T.scale(T.impute(T.project(x, [10, 11, 12, 13])))
    best_score, best_idx = T.grid_search(
        x=Xv, y=y, estimator_name="ridge_fit",
        grid=[{"alpha": a} for a in (0.1, 1.0, 10.0)], k=3, seed=4)
    s = Stratum(memory_budget_bytes=2 << 30, device="cpu")
    results, report = s.run_batch(PipelineBatch([best_score, best_idx],
                                                ["score", "idx"]))
    kfolds = [op for w in report.plan.waves for op in w.ops
              if op.op_name == "kfold_split"]
    assert len(kfolds) == 3
    assert 0 <= int(np.asarray(results["idx"])) < 3


def test_fidelity_annotation_selects_approx_impl():
    x = T.read("uk_housing", N_ROWS, seed=0)
    Xv = T.scale(T.impute(T.project(x, [10, 11, 12, 13])))
    red = T.svd_reduce(Xv, k=2, seed=0)
    annotate(red, stage="explore")
    s = Stratum(memory_budget_bytes=2 << 30, device="cpu")
    sinks, sel, plan, *_ = s.compile_batch(PipelineBatch([red], ["p"]))
    from repro_torch.core.dag import toposort
    svd_ops = [op for op in toposort(sinks) if op.op_name == "svd_reduce"]
    assert svd_ops and sel[svd_ops[0].signature].fidelity == "approx"


def test_agent_diff_statistics_match_paper_characterization():
    """Fig 2a: ~50% of iterations change ≤16% of the pipeline code."""
    agent = AIDEAgent(seed=3)
    specs = agent.propose(4)
    agent.observe(specs, [1.0, 0.9, 1.1, 0.95])
    prev = agent.best().spec
    fracs = []
    for i in range(60):
        new = agent.propose(1)[0]
        fracs.append(diff_fraction(prev, new))
        agent.observe([new], [0.9 + 0.001 * i])
        prev = new
    frac_small = float(np.mean(np.asarray(fracs) <= 0.17))
    assert 0.35 <= frac_small <= 0.9


def test_agent_search_improves_over_drafts(paper_runs):
    agent = AIDEAgent(seed=1, n_rows=N_ROWS, cv_k=2)
    s = paper_runs["port"]["client"].stratum
    for _ in range(3):
        specs = agent.propose(2)
        batch = PipelineBatch([sp.build() for sp in specs],
                              [f"s{i}" for i in range(len(specs))])
        results, _ = s.run_batch(batch)
        agent.observe(specs, [float(np.asarray(results[f"s{i}"]))
                              for i in range(len(specs))])
    assert agent.best() is not None
    assert np.isfinite(agent.best().score)


def test_async_aide_search_on_a_local_session(paper_runs):
    """Two rounds of four through a tenant-scoped session of a local
    client: a best node with a finite score, every round's report kept."""
    client = paper_runs["port"]["client"]
    search = AsyncAIDESearch(client.session("aide"),
                             AIDEAgent(n_rows=N_ROWS, seed=0),
                             batch_size=4, max_inflight=2)
    best = search.run(n_rounds=2)
    assert best is not None and np.isfinite(best.score)
    assert len(search.reports) == 2 and search.analysis_rejections == 0


def test_async_aide_search_sends_speculative_hints():
    """With compile_async and a speculative depth, refinement rounds send
    the agent's likely-next structures to ``precompile``."""
    cfg = StratumConfig.make(memory_budget_bytes=1 << 30, device="cpu",
                             compile_async=True, speculative_depth=4,
                             hardware_threads=8)
    with connect("local", cfg) as client:
        agent = AIDEAgent(n_rows=1500, cv_k=2, seed=3)
        search = AsyncAIDESearch(client.session("aide"), agent,
                                 batch_size=2, max_inflight=1,
                                 speculate=True)
        best = search.run(n_rounds=3)
        assert best is not None and best.score is not None
        assert search.speculative_batches >= 1
        ex = client.stratum.plan_cache.executor
        assert ex.drain(timeout=300)
        snap = client.stratum.plan_cache.snapshot()
        assert snap["async_failures"] == 0 and snap["uncompilable"] == 0


def test_async_aide_search_runs_through_the_service():
    """Three agents, two rounds of two each, on threads against one
    ``connect("service")`` client (as ``examples/agentic_search.py``'s
    run_async): every round resolves, each agent's best is its spec's
    score on the local target, and the agents share work."""
    import threading
    cfg = StratumConfig.make(memory_budget_bytes=4 << 30, device="cpu",
                             hardware_threads=8, coalesce_window_s=0.05)
    bests, searches = [None] * 3, [None] * 3
    with connect("service", cfg) as client:
        def agent_main(i):
            searches[i] = AsyncAIDESearch(
                client.session(f"agent-{i}"),
                AIDEAgent(n_rows=N_ROWS, cv_k=2, seed=i),
                batch_size=2, max_inflight=2)
            bests[i] = searches[i].run(n_rounds=2)

        threads = [threading.Thread(target=agent_main, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        snap = client.telemetry.snapshot()
        g = client.telemetry.global_snapshot()
        unc = client.service.plan_cache.snapshot()["uncompilable"]
    assert [snap[f"agent-{i}"]["jobs_completed"] for i in range(3)] == \
        [2, 2, 2]
    assert g["ops_deduped_cross_agent"] + g["cache_cross_tenant_hits"] > 0
    assert unc == 0
    local = connect("local", StratumConfig.make(
        memory_budget_bytes=4 << 30, device="cpu", hardware_threads=8))
    for best, search in zip(bests, searches):
        assert best is not None and np.isfinite(best.score)
        assert len(search.reports) == 2
        value, _ = local.run(best.spec.build())
        np.testing.assert_allclose(best.score, float(value), rtol=1e-6)
    local.close()


def test_async_aide_search_sends_speculative_hints_to_the_service():
    cfg = StratumConfig.make(memory_budget_bytes=1 << 30, device="cpu",
                             compile_async=True, speculative_depth=4,
                             n_executors=1, coalesce_window_s=0.0)
    with connect("service", cfg) as client:
        search = AsyncAIDESearch(client.session("aide"),
                                 AIDEAgent(n_rows=1500, cv_k=2, seed=3),
                                 batch_size=2, max_inflight=1,
                                 speculate=True)
        best = search.run(n_rounds=3)
        assert best is not None and best.score is not None
        assert search.speculative_batches >= 1
        assert client.service.plan_cache.executor.drain(timeout=300)
        snap = client.service.plan_cache.snapshot()
        assert snap["async_failures"] == 0 and snap["uncompilable"] == 0
