"""The port's compiled-segment backend (``repro_torch.core.backends.
torch_segment``) against the reference's ``jax_segment``: the counterparts
of ``tests/test_backends.py`` and ``tests/test_compile_async.py`` (all but
the service and fabric snapshots, which wait for ``ROADMAP.md`` A2e).

* The same batch, built from the same seeds, runs through ``repro`` at its
  defaults and through the port at its defaults (``device="cpu"``): the
  per-tier counts ("torch" for "jax", "torch-seg" for "jax-seg"), the waves
  and the plan-cache misses and hits are equal, and the scores agree within
  the tabular tolerance of ``tests/test_torch_core.py`` (1e-3 relative).
* Compiled against per-op in the port: rtol 1e-6, as the reference's
  tests hold jit against per-op.
* Every ``traceable=True`` torch impl traces under
  ``make_fx(tracing_mode="fake")`` with its tunables as 0-d tensors, and the
  traced graph gives the per-op bits.
* More than 8 distinct segment structures in one process all run compiled
  (``"torch-seg"``): no structure meets the compiler's per-code recompile
  limit, and nothing falls back unnoticed.

Tables are 2,000 rows; the torch tier runs on the CPU, inductor compiling.
"""

import threading
import time

import numpy as np
import pytest
import torch

import repro.tabular as JT
import repro_torch.tabular as T
from repro.core import PipelineBatch as JBatch
from repro.core import Stratum as JStratum
from repro_torch.core import (PipelineBatch, PlanCache, Stratum,
                              structural_signature)
from repro_torch.core.backends.torch_segment import TorchSegmentBackend
from repro_torch.core.cache import IntermediateCache
from repro_torch.core.plan_cache import CompileExecutor, PlanCacheStats
from repro_torch.core.runtime import ExecutionPreempted, Runtime
from repro_torch.core.scheduler import partition_segments

ROWS = 2000
MB = 1 << 30
NO_CACHE = ("logical", "lowering", "selection", "parallel")


def _variant_sink(alpha, cols=(10, 11, 12, 13), n_rows=ROWS, ops=T):
    """A torch-heavy pipeline; alpha is a tunable constant."""
    x = ops.read("uk_housing", n_rows, seed=0)
    y = ops.project(x, [0])
    Xv = ops.scale(ops.impute(ops.project(x, list(cols))))
    w = ops.ridge_fit(Xv, y, alpha=alpha)
    return ops.metric(y, ops.predict(w, Xv), kind="rmse")


def _variant_batch(alphas, log1p=False, n_rows=ROWS, ops=T, batch=None):
    """AIDE-style refinement fan: identical structure, tunable alphas.
    ``log1p=True`` inserts one extra stage — a *structural* neighbor."""
    x = ops.read("uk_housing", n_rows, seed=0)
    y = ops.project(x, [0])
    Xs = ops.scale(ops.impute(ops.project(x, [10, 11, 12, 13])))
    if log1p:
        Xs = ops.log1p(Xs)
    sinks = [ops.metric(y, ops.predict(ops.ridge_fit(Xs, y, alpha=a), Xs),
                        kind="rmse") for a in alphas]
    return (batch or PipelineBatch)(sinks,
                                    [f"v{i}" for i in range(len(alphas))])


def _scores(res, batch):
    return [float(np.asarray(res[n])) for n in batch.names]


def _session(**kw):
    kw.setdefault("memory_budget_bytes", MB)
    return Stratum(device="cpu", **kw)


def _compiled_sessions(**kw):
    return _session(**kw), _session(compiled_segments=False, **kw)


# ---------------------------------------------------------------------------
# parity with the reference at both packages' defaults
# ---------------------------------------------------------------------------

def _quickstart(ops):
    from repro.data.tabular import feature_target_indices, schema_dict
    feats, tgt = feature_target_indices()
    raw = ops.read("uk_housing", n_rows=ROWS, seed=0)
    y = ops.project(raw, [tgt])
    X = ops.table_vectorizer(ops.project(raw, feats), schema_dict(), feats)
    return ([ops.cv_score(X, y, {"name": "ridge_fit", "alpha": 1.0}, k=3,
                          seed=7),
             ops.cv_score(X, y, {"name": "gbt_fit", "n_trees": 20}, k=3,
                          seed=7)], ["ridge", "gbt"])


def _fan(ops):
    b = _variant_batch((0.5, 2.0, 8.0), ops=ops,
                       batch=JBatch if ops is JT else PipelineBatch)
    return b.sinks, b.names


def _counts(rep):
    return ({k.replace("jax", "torch"): v
             for k, v in rep.run.per_backend.items()}, rep.run.waves,
            rep.run.plan_cache_misses, rep.run.plan_cache_hits,
            rep.run.ops_from_cache)


@pytest.mark.parametrize("build", [_quickstart, _fan],
                         ids=["quickstart", "ridge_fan"])
def test_defaults_match_reference(build):
    """Both packages at their defaults (compiled segments on), twice: the
    same per-tier counts, waves, plan-cache misses/hits and cache hits, and
    scores within 1e-3; the second run's scores equal the first's."""
    out = {}
    for name, ops, make, batch in (
            ("ref", JT, lambda: JStratum(memory_budget_bytes=16 << 30,
                                         hardware_threads=8), JBatch),
            ("port", T, lambda: _session(memory_budget_bytes=16 << 30,
                                         hardware_threads=8),
             PipelineBatch)):
        sinks, names = build(ops)
        s = make()
        runs = [s.run_batch(batch(sinks, names)) for _ in range(2)]
        out[name] = runs
    for (rr, rrep), (tr, trep) in zip(out["ref"], out["port"]):
        assert _counts(trep) == _counts(rrep)
        assert trep.run.per_backend.get("torch-seg", 0) > 0 or \
            trep.run.ops_from_cache > 0
        for key in rr:
            a, b = float(np.asarray(rr[key])), float(np.asarray(tr[key]))
            assert abs(b - a) <= 1e-3 * abs(a), (key, a, b)
    (first, _), (second, _) = out["port"]
    assert {k: float(v) for k, v in first.items()} == \
        {k: float(v) for k, v in second.items()}


# ---------------------------------------------------------------------------
# every traceable impl traces with tensor tunables and gives per-op bits
# ---------------------------------------------------------------------------

def _table(n=300, seed=0):
    from repro.data.tabular import generate_uk_housing
    return np.asarray(generate_uk_housing(n, seed=seed))


def _f32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _trace_cases():
    X = _table()
    num = X[:, 10:14]
    y = np.nan_to_num(X[:, 0])
    stats = np.stack([np.nanmean(num, 0), np.nanstd(num, 0) + 1e-3])
    return {
        ("project", "exact"): ({"cols": (1, 3, 5)}, [X]),
        ("concat", "exact"): ({}, [X[:, :3], X[:, 5:6]]),
        ("log1p", "exact"): ({}, [num]),
        ("clip_outliers", "exact"): ({"q": 0.05}, [num]),
        ("impute_fit", "exact"): ({}, [num]),
        ("impute_apply", "exact"): ({}, [np.nanmean(num, 0), num]),
        ("scaler_fit", "exact"): ({}, [num]),
        ("scaler_apply", "exact"): ({}, [stats, np.nan_to_num(num)]),
        ("onehot", "exact"): ({"cards": (4, 5)}, [X[:, 2:4]]),
        ("target_encode_fit", "exact"): ({"card": 40, "smoothing": 7.5},
                                         [X[:, 5:6], y]),
        ("target_encode_apply", "exact"): ({"card": 40},
                                           [np.linspace(0, 1, 40),
                                            X[:, 5:6]]),
        ("datetime_encode", "exact"): ({}, [X[:, 9:10]]),
        ("cleaner", "exact"): ({}, [X]),
        ("svd_reduce", "exact"): ({"k": 3}, [np.nan_to_num(num)]),
        ("svd_reduce", "approx"): ({"k": 2}, [np.nan_to_num(num)]),
        ("ridge_fit", "exact"): ({"alpha": 0.3}, [np.nan_to_num(num), y]),
        ("elasticnet_fit", "exact"): ({"alpha": 0.01, "l1_ratio": 0.3,
                                       "iters": 50},
                                      [np.nan_to_num(num), y]),
        ("linear_predict", "exact"): ({}, [np.linspace(-1, 1, 5),
                                           np.nan_to_num(num)]),
    }


def test_trace_cases_cover_every_traceable_impl():
    from repro_torch.core.selection import _REGISTRY
    traceable = {(i.op_name, i.fidelity) for impls in _REGISTRY.values()
                 for i in impls if i.backend == "torch" and i.traceable}
    assert traceable == set(_trace_cases())


@pytest.mark.parametrize("name,fidelity", sorted(_trace_cases()))
def test_traceable_impl_traces_with_tensor_tunables(name, fidelity):
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.core.dag import LazyOp, TRANSFORM, tunable_fields
    from repro_torch.core.selection import impls_for
    spec, inputs = _trace_cases()[(name, fidelity)]
    impl = next(i for i in impls_for(name) if i.backend == "torch"
                and i.fidelity == fidelity)
    op = LazyOp(name, TRANSFORM, spec=spec)
    ins = [_f32(a) for a in inputs]
    want = impl.fn(op, ins)                          # per-op: python floats
    hoisted = sorted(tunable_fields(name) & set(spec))

    def fn(*args):
        tensors, tun = args[:len(ins)], args[len(ins):]
        s = dict(spec)
        s.update(zip(hoisted, tun))
        return list(impl.fn(op.__class__(name, TRANSFORM, spec=s),
                            list(tensors)))

    tunables = [torch.tensor(float(spec[f]), dtype=torch.float64)
                for f in hoisted]
    gm = make_fx(fn, tracing_mode="fake")(*ins, *tunables)
    got = gm(*ins, *tunables)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # bit for bit, NaN where the per-op output has NaN
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# no hidden fallback: many structures, each compiled
# ---------------------------------------------------------------------------

def test_more_than_eight_structures_all_run_compiled():
    """Ten distinct segment structures in one process (more than dynamo's
    per-code recompile limit of 8): every one runs as ``torch-seg``, each
    key compiles once, nothing is uncompilable and error suppression is
    off."""
    assert not torch._dynamo.config.suppress_errors
    s = _session(enable=NO_CACHE)
    col_sets = [(10,), (11,), (12,), (13,), (10, 11), (10, 12), (10, 13),
                (11, 12), (11, 13), (12, 13)]
    for cols in col_sets:
        _, rep = s.run(_variant_sink(1.0, cols=cols))
        assert rep.run.per_backend.get("torch-seg", 0) == 8, cols
        assert rep.run.plan_cache_misses == 1
    snap = s.plan_cache.snapshot()
    assert snap["compiles"] == len(col_sets) == snap["entries"]
    assert snap["uncompilable"] == 0
    stats = s._backends["torch"].stats()
    assert stats["compiles"] == stats["traces"] == len(col_sets)
    assert not torch._dynamo.config.suppress_errors


# ---------------------------------------------------------------------------
# structural signatures
# ---------------------------------------------------------------------------

def test_structural_signature_shared_across_constants():
    a = _variant_sink(alpha=0.1)
    b = _variant_sink(alpha=42.0)
    c = _variant_sink(alpha=0.1, cols=(10, 11))          # topology change
    assert structural_signature([a]) == structural_signature([b])
    assert structural_signature([a]) != structural_signature([c])
    assert a.op.signature != b.op.signature


def test_structural_signature_nontunable_spec_is_structural():
    x = T.read("uk_housing", 1000, seed=0)
    y = T.project(x, [0])
    Xv = T.impute(T.project(x, [10, 11]))
    m1 = T.metric(y, T.project(Xv, [0]), kind="rmse")
    m2 = T.metric(y, T.project(Xv, [0]), kind="mae")
    assert structural_signature([m1]) != structural_signature([m2])


def test_structural_signature_seed_value_excluded():
    def fit(seed):
        x = T.read("uk_housing", 1000, seed=0)
        return T.ridge_fit(T.project(x, [1, 2]), T.project(x, [0]),
                           alpha=1.0, seed=seed)
    w1, w2 = fit(3), fit(9)
    assert w1.op.structural_signature == w2.op.structural_signature
    from repro_torch.core import ESTIMATOR, LazyOp
    w3 = LazyOp("ridge_fit", ESTIMATOR, spec={"alpha": 1.0},
                inputs=tuple(w1.op.inputs), seed=None).out()
    assert w1.op.structural_signature != w3.op.structural_signature


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def test_plan_cache_lru_eviction_and_telemetry():
    pc = PlanCache(capacity=2)
    pc.put("a", 1)
    pc.put("b", 2)
    assert pc.get("a") == 1
    pc.put("c", 3)                           # evicts b
    assert "b" not in pc and "a" in pc and "c" in pc
    assert pc.get("b") is None
    snap = pc.snapshot()
    assert (snap["entries"], snap["evictions"], snap["compiles"]) == (2, 1, 3)
    assert snap["hits"] == 1 and snap["misses"] == 1
    assert snap["hit_rate"] == 0.5
    pc.put("a", 10)
    assert pc.snapshot()["compiles"] == 3
    pc.discard("a")
    pc.discard("nothing")
    assert "a" not in pc and len(pc) == 1
    with pytest.raises(ValueError):
        PlanCache(capacity=0)


def test_plan_cache_reused_across_hyperparameter_variants():
    """The same structure with different constants compiles once; later
    variants are pure plan-cache hits (no retraces)."""
    s = _session(enable=NO_CACHE)
    scores = []
    for alpha in (0.1, 1.0, 10.0):
        r, rep = s.run(_variant_sink(alpha))
        scores.append(float(np.asarray(r)))
    snap = s.plan_cache.snapshot()
    assert snap["compiles"] > 0
    assert snap["hits"] >= snap["compiles"]
    first = snap["compiles"]
    traces = s._backends["torch"].stats()["traces"]
    s.run(_variant_sink(123.0))
    assert s.plan_cache.snapshot()["compiles"] == first
    assert s._backends["torch"].stats()["traces"] == traces
    assert len(set(scores)) == 3


# ---------------------------------------------------------------------------
# compiled execution equivalence
# ---------------------------------------------------------------------------

def test_compiled_segments_match_per_op_dispatch():
    on, off = _compiled_sessions()
    sink = _variant_sink(alpha=2.0)
    r_on, rep_on = on.run(sink)
    r_off, rep_off = off.run(sink)
    assert rep_on.run.per_backend.get("torch-seg", 0) > 0
    assert "torch-seg" not in rep_off.run.per_backend
    np.testing.assert_allclose(float(np.asarray(r_on)),
                               float(np.asarray(r_off)), rtol=1e-6)
    # a compiled op's outputs live on the session's device
    seg = [sig for sig, src in rep_on.run.sig_source.items()
           if src == "torch-seg"]
    assert seg and all(set(rep_on.run.placement[sig]) == {"cpu"}
                       for sig in seg)


def test_plan_has_backend_homogeneous_segments():
    s = _session()
    sinks, sel, plan, *_ = s.compile_batch(
        PipelineBatch([_variant_sink(1.0)], ["p"]))
    kinds = [seg.kind for seg in plan.segments]
    assert "torch" in kinds and "python" in kinds
    assert sum(len(seg.waves) for seg in plan.segments) == len(plan.waves)
    assert all(a != b for a, b in zip(kinds, kinds[1:]))
    for seg in plan.segments:
        if seg.kind != "torch":
            continue
        for wave in seg.waves:
            for op in wave.ops:
                impl = sel[op.signature]
                assert impl.backend == "torch" and impl.traceable


def test_one_op_torch_runs_demoted_to_python():
    from repro_torch.core.scheduler import Wave
    from repro_torch.core.selection import impls_for
    impl = next(i for i in impls_for("project") if i.backend == "torch")
    x = T.read("uk_housing", 500, seed=0)
    a, b = T.project(x, [1, 2]).op, T.project(x, [3, 4]).op
    sel = {a.signature: impl, b.signature: impl}
    assert [s.kind for s in
            partition_segments([Wave(ops=[a])], sel)] == ["python"]
    assert [s.kind for s in
            partition_segments([Wave(ops=[a]), Wave(ops=[b])], sel)] \
        == ["torch"]


def test_uncompilable_segment_falls_back_to_per_op(monkeypatch):
    """An impl wrongly declared traceable must not break execution: its
    fake trace fails (``torch.unique`` has a data-dependent shape and the
    impl hashes on the host), the segment falls back to per-op dispatch,
    the key is counted uncompilable, and results match the per-op path."""
    from repro_torch.core.selection import impls_for
    impl = next(i for i in impls_for("string_encode")
                if i.backend == "torch")
    monkeypatch.setattr(impl, "traceable", True)    # lie
    x = T.read("uk_housing", 1500, seed=0)
    y = T.project(x, [0])
    enc = T.string_encode(T.project(x, [5]), dim=4, seed=1)
    sink = T.metric(y, T.predict(
        T.ridge_fit(T.scale(T.impute(enc)), y, alpha=1.0),
        T.scale(T.impute(enc))), kind="rmse")
    on, off = _compiled_sessions()
    r_on, rep_on = on.run(sink)
    r_off, _ = off.run(sink)
    np.testing.assert_allclose(float(np.asarray(r_on)),
                               float(np.asarray(r_off)), rtol=1e-6)
    assert on.plan_cache.snapshot()["uncompilable"] == 1
    assert "torch-seg" not in rep_on.run.per_backend
    traces = on._backends["torch"].stats()["traces"]
    r_on2, _ = on.run(sink)           # straight to per-op, no retrace
    assert on._backends["torch"].stats()["traces"] == traces
    np.testing.assert_allclose(float(np.asarray(r_on2)),
                               float(np.asarray(r_off)), rtol=1e-6)


def test_runtime_failure_runs_per_op_and_keeps_the_program(monkeypatch):
    """A compiled program that raises after its first call runs that
    round per-op and stays in the plan cache (not uncompilable)."""
    from repro_torch.core.backends import torch_segment
    s = _session(enable=NO_CACHE)
    r1, _ = s.run(_variant_sink(1.0))
    calls = []

    def boom(self, ext_vals, hoist_vals):
        calls.append(1)
        raise RuntimeError("transient")

    monkeypatch.setattr(torch_segment._Graph, "__call__", boom)
    r2, rep = s.run(_variant_sink(1.0))
    assert calls and "torch-seg" not in rep.run.per_backend
    assert s.plan_cache.snapshot()["uncompilable"] == 0
    assert len(s.plan_cache) == 1
    np.testing.assert_allclose(float(r2), float(r1), rtol=1e-6)


# ---------------------------------------------------------------------------
# segment-boundary preemption: salvage exactness
# ---------------------------------------------------------------------------

def test_segment_boundary_preemption_salvage_exact():
    s = _session(enable=NO_CACHE)
    sink = _variant_sink(alpha=3.0)
    sinks, sel, plan, cands, *_ = s.compile_batch(
        PipelineBatch([sink], ["p"]))
    n_unique = len({op.signature for w in plan.waves for op in w.ops})
    fired = []

    def preempt_once():
        if not fired:
            fired.append(True)
            return True
        return False

    rt1 = Runtime(parallel=False, preempt_check=preempt_once,
                  backends=s._backends, device="cpu")
    with pytest.raises(ExecutionPreempted) as ei:
        rt1.execute(sinks, plan, sel)
    salvage = ei.value.salvage
    assert salvage
    rt2 = Runtime(parallel=False, preloaded=salvage, backends=s._backends,
                  device="cpu")
    results, rep2 = rt2.execute(sinks, plan, sel)
    assert ei.value.waves_done <= len(plan.waves)
    assert rep2.ops_executed + rep2.ops_salvaged == n_unique
    assert rep2.ops_executed < n_unique
    r_ref, _ = _session().run(sink)
    np.testing.assert_allclose(float(np.asarray(results[0])),
                               float(np.asarray(r_ref)), rtol=1e-6)


def test_batch_variants_cache_hits_attribute_cross_tenant():
    x = T.read("uk_housing", 1500, seed=0)
    y = T.project(x, [0])
    Xv = T.scale(T.impute(T.project(x, [10, 11, 12])))
    fits = [T.ridge_fit(Xv, y, alpha=a) for a in (0.5, 5.0)]
    batch = PipelineBatch(fits, ["w0", "w1"])
    cache = IntermediateCache(budget_bytes=64 << 20)
    s = _session(cache=cache, compiled_segments=False)
    sinks, sel, plan, cands, *_ = s.compile_batch(batch)
    fit_sigs = [op.signature for w in plan.waves for op in w.ops
                if op.op_name == "ridge_fit"]
    assert len(fit_sigs) == 2
    every = [op.signature for w in plan.waves for op in w.ops]
    rt_a = Runtime(cache=cache, cache_candidates=set(cands | set(fit_sigs)),
                   parallel=False, compiled_segments=False, device="cpu",
                   sig_tenant={sig: "A" for sig in every})
    rt_a.execute(sinks, plan, sel)
    assert all(sig in cache for sig in fit_sigs)
    before = cache.stats.cross_tenant_hits
    rt_b = Runtime(cache=cache, cache_candidates=cands, parallel=False,
                   compiled_segments=False, device="cpu",
                   sig_tenant={sig: "B" for sig in every})
    _, rep_b = rt_b.execute(sinks, plan, sel)
    assert all(rep_b.sig_source[sig] == "cache" for sig in fit_sigs)
    assert cache.stats.cross_tenant_hits >= before + 2
    assert rep_b.per_backend.get("torch-vmap", 0) == 0


# ---------------------------------------------------------------------------
# custom register_backend kinds get their own segments
# ---------------------------------------------------------------------------

class _ToyBackend:
    name = "toy"

    def __init__(self, plan_cache=None):
        self.plan_cache = plan_cache
        self.segments_executed = 0

    def execute_segment(self, rt, segment, selection, report):
        self.segments_executed += 1
        report.waves += len(segment.waves)
        for wave in segment.waves:
            for op in wave.ops:
                rt._run_op(op, selection, report)
            rt._free_wave(wave)


def test_partition_emits_segments_for_registered_custom_kind(monkeypatch):
    from repro_torch.core.backends.base import _FACTORIES
    from repro_torch.core.scheduler import Wave
    from repro_torch.core.selection import PhysicalImpl
    monkeypatch.setitem(_FACTORIES, "toy", _ToyBackend)
    toy_impl = PhysicalImpl(op_name="noop", backend="toy",
                            fn=lambda op, ins: (ins[0],))
    x = T.read("uk_housing", 500, seed=0)
    a, b = T.project(x, [1, 2]).op, T.project(x, [3, 4]).op
    sel = {a.signature: toy_impl, b.signature: toy_impl}
    segs = partition_segments([Wave(ops=[a]), Wave(ops=[b])], sel)
    assert [s.kind for s in segs] == ["toy"]
    monkeypatch.delitem(_FACTORIES, "toy")
    segs = partition_segments([Wave(ops=[a]), Wave(ops=[b])], sel)
    assert [s.kind for s in segs] == ["python"]


def test_custom_backend_executes_its_segments_end_to_end(monkeypatch):
    from repro_torch.core import GENERIC, LazyOp
    from repro_torch.core.backends.base import _FACTORIES, make_backends
    from repro_torch.core.scheduler import SchedulerConfig, plan as make_plan
    from repro_torch.core.selection import (BACKENDS, BackendProfile,
                                            PhysicalImpl)
    monkeypatch.setitem(_FACTORIES, "toy", _ToyBackend)
    monkeypatch.setitem(BACKENDS, "toy",
                        BackendProfile("toy", 1e9, 1e9, 1e-6, 1.0))
    a = LazyOp("toy_add", GENERIC, spec={"fn": lambda v: v + 1.0},
               inputs=(LazyOp("const0", GENERIC,
                              spec={"fn": lambda: np.zeros(4)}).out(),))
    sink = LazyOp("toy_add2", GENERIC, spec={"fn": lambda v: v + 1.0},
                  inputs=(a.out(),)).out()
    toy = PhysicalImpl(op_name="toy_add", backend="toy",
                       fn=lambda op, ins: (np.asarray(ins[0]) + 1.0,))
    sel = {a.signature: toy, sink.op.signature: toy}
    p = make_plan([sink], sel, SchedulerConfig())
    assert "toy" in {seg.kind for seg in p.segments}
    backends = make_backends(None, compiled=True)
    assert {"python", "torch", "toy"} <= set(backends)
    rt = Runtime(backends=backends, device="cpu")
    results, report = rt.execute([sink], p, sel)
    np.testing.assert_allclose(np.asarray(results[0]), np.full(4, 2.0))
    assert backends["toy"].segments_executed >= 1
    assert report.per_backend.get("toy", 0) == 2


# ---------------------------------------------------------------------------
# segment est_time budget bounds compiled-segment preempt latency
# ---------------------------------------------------------------------------

def test_segment_time_budget_splits_torch_segments():
    s_nb = _session()
    s_b = _session(segment_time_budget_s=1e-9)
    batch = PipelineBatch([_variant_sink(1.0)], ["p"])
    _, _, plan_nb, *_ = s_nb.compile_batch(batch)
    _, _, plan_b, *_ = s_b.compile_batch(batch)
    n_nb = sum(1 for seg in plan_nb.segments if seg.kind == "torch")
    n_b = sum(1 for seg in plan_b.segments if seg.kind == "torch")
    assert n_b > n_nb
    for seg in plan_b.segments:
        if seg.kind == "torch":
            assert len(seg.waves) == 1
    r_b, _ = s_b.run_batch(batch)
    r_nb, _ = s_nb.run_batch(batch)
    np.testing.assert_allclose(float(np.asarray(r_b["p"])),
                               float(np.asarray(r_nb["p"])), rtol=1e-6)


def test_segment_pieces_respect_the_budget():
    s = _session()
    sinks, sel, plan, *_ = s.compile_batch(
        PipelineBatch([_variant_sink(1.0)], ["p"]))
    base = [seg for seg in partition_segments(plan.waves, sel)
            if seg.kind == "torch"]
    assert base
    budget = max(w.est_time for seg in base for w in seg.waves) * 1.5
    for seg in partition_segments(plan.waves, sel, time_budget_s=budget):
        if seg.kind != "torch" or len(seg.waves) == 1:
            continue
        assert sum(w.est_time for w in seg.waves) <= budget


def test_budget_bounds_preempt_latency_at_segment_boundaries():
    s = _session(segment_time_budget_s=1e-9)
    batch = PipelineBatch([_variant_sink(1.0)], ["p"])
    sinks, sel, plan, candidates, *_ = s.compile_batch(batch)
    n_ops = sum(len(w.ops) for w in plan.waves)
    fired = {"n": 0}

    def preempt_after_first_progress():
        fired["n"] += 1
        return fired["n"] > 2

    rt = Runtime(preempt_check=preempt_after_first_progress,
                 backends=s._backends, device="cpu")
    with pytest.raises(ExecutionPreempted) as exc:
        rt.execute(sinks, plan, sel)
    salvage = exc.value.salvage
    assert 0 < len(salvage) < n_ops
    rt2 = Runtime(preloaded=salvage, backends=s._backends, device="cpu")
    results, report = rt2.execute(sinks, plan, sel)
    ref, _ = _session().run_batch(batch)
    np.testing.assert_allclose(float(np.asarray(results[0])),
                               float(np.asarray(ref["p"])), rtol=1e-6)
    assert report.ops_salvaged >= len(salvage)


# ---------------------------------------------------------------------------
# CompileExecutor: single-flight, bounds, shutdown
# ---------------------------------------------------------------------------

def test_executor_single_flight_under_thread_hammer():
    pc = PlanCache(capacity=64, compile_async=True)
    ex = pc.executor
    runs: dict = {}
    mu = threading.Lock()

    def job_for(key):
        def job():
            time.sleep(0.002)
            with mu:
                runs[key] = runs.get(key, 0) + 1
            pc.put(key, f"compiled-{key}")
        return job

    keys = [f"sig{i}" for i in range(8)]
    accepted = []

    def hammer():
        for key in keys:
            accepted.append(ex.submit(key, job_for(key)))

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ex.drain(timeout=30)
    assert runs == {k: 1 for k in keys}
    assert sum(accepted) == len(keys)
    snap = pc.snapshot()
    assert snap["async"] is True
    assert snap["async_compiles"] == len(keys)
    assert snap["async_failures"] == 0 and snap["inflight"] == 0
    assert snap["compile_time_s"] > 0
    for k in keys:
        assert pc.get(k) == f"compiled-{k}"
    pc.close()


def test_executor_lanes_are_bounded_and_speculative_drops_count():
    stats, lock = PlanCacheStats(), threading.Lock()
    ex = CompileExecutor(stats, lock, lambda k: False,
                         max_pending=2, speculative_depth=1)
    gate = threading.Event()
    assert ex.submit("busy", gate.wait)
    time.sleep(0.05)
    assert ex.submit("n1", lambda: None)
    assert ex.submit("n2", lambda: None)
    assert not ex.submit("n3", lambda: None)
    assert stats.speculative_dropped == 0
    assert ex.submit("s1", lambda: None, speculative=True)
    assert not ex.submit("s2", lambda: None, speculative=True)
    assert stats.speculative_dropped == 1
    assert not ex.submit("n1", lambda: None)
    gate.set()
    assert ex.drain(timeout=30)
    assert stats.inflight == 0
    assert stats.async_compiles == 4
    ex.close()


def test_executor_close_is_idempotent_and_drops_queued_work():
    stats, lock = PlanCacheStats(), threading.Lock()
    ex = CompileExecutor(stats, lock, lambda k: False, max_pending=8)
    gate = threading.Event()
    ran = []
    ex.submit("busy", gate.wait)
    time.sleep(0.05)
    ex.submit("queued", lambda: ran.append(1))
    gate.set()
    ex.close(timeout=10)
    ex.close(timeout=10)
    assert not ex.submit("after", lambda: ran.append(2))
    assert ran == []
    assert stats.inflight == 0
    assert ex._worker is not None and not ex._worker.is_alive()


def test_executor_counts_failures_without_dying():
    pc = PlanCache(capacity=8, compile_async=True)

    def boom():
        raise RuntimeError("trace failed")

    assert pc.executor.submit("bad", boom)
    assert pc.executor.submit("good", lambda: pc.put("good", 1))
    assert pc.executor.drain(timeout=30)
    snap = pc.snapshot()
    assert snap["async_failures"] == 1 and snap["async_compiles"] == 1
    assert pc.get("good") == 1
    pc.close()


def test_plan_cache_speculative_hit_accounting():
    pc = PlanCache(capacity=8, compile_async=True, speculative_depth=2)
    pc.put("warm", "program", speculative=True)
    snap = pc.snapshot()
    assert snap["speculative_compiles"] == 1 and snap["speculative_hits"] == 0
    assert pc.get("warm") == "program"
    assert pc.snapshot()["speculative_hits"] == 1
    pc.get("warm")
    assert pc.snapshot()["speculative_hits"] == 1
    pc.close()


# ---------------------------------------------------------------------------
# batched variant solves: one vmapped program, identical scores
# ---------------------------------------------------------------------------

def test_batched_variants_match_per_op_and_compiled():
    alphas = (0.5, 1.0, 2.0, 4.0)
    per_op = _session(compiled_segments=False)
    comp = _session()
    vb = _session(batch_variants=True)
    batch = _variant_batch(alphas)
    ref = _scores(per_op.run_batch(batch)[0], batch)
    got_c = _scores(comp.run_batch(_variant_batch(alphas))[0], batch)
    res_vb, rep_vb = vb.run_batch(_variant_batch(alphas))
    got_vb = _scores(res_vb, batch)
    assert rep_vb.run.per_backend.get("torch-seg", 0) > 0
    np.testing.assert_allclose(got_c, ref, rtol=1e-6)
    np.testing.assert_allclose(got_vb, ref, rtol=1e-6)
    assert len(set(ref)) == len(alphas)
    assert vb._backends["torch"]._key_tag == "torch-seg-vb"
    assert comp._backends["torch"]._key_tag == "torch-seg"
    # the fan's fits ran as one vmap call inside the program
    assert all(p.batched for p in vb.plan_cache._entries.values())


def test_batched_variants_reuse_one_compiled_program():
    vb = _session(batch_variants=True, enable=NO_CACHE)
    vb.run_batch(_variant_batch((0.5, 1.0, 2.0)))
    compiles = vb.plan_cache.snapshot()["compiles"]
    assert compiles > 0
    vb.run_batch(_variant_batch((3.0, 5.0, 7.0)))
    snap = vb.plan_cache.snapshot()
    assert snap["compiles"] == compiles
    assert snap["hits"] > 0


def test_variant_group_planning_is_safe_and_pure():
    plan = TorchSegmentBackend._plan_groups
    assert plan(("s", "s", "s"), (1, 1, 1),
                ((), (), ()), (("a",), ("a",), ("a",))) == ((0, 1, 2),)
    assert plan(("s", "t", "s"), (1, 1, 1),
                ((), (), ()), (("a",), ("a",), ("a",))) == ((0, 2),)
    assert plan(("s", "s"), (1, 1), ((), ()), ((), ())) == ((0, 1),)
    assert plan(("s", "x", "s"), (1, 2, 1),
                ((), ((1, 0, 0),), ()), (("a",), (), ("a",))) == ()


# ---------------------------------------------------------------------------
# async compilation: first touch falls back, next round runs compiled
# ---------------------------------------------------------------------------

def test_async_first_touch_falls_back_then_hits_warm():
    ref_s = _session(compiled_segments=False)
    s = _session(compile_async=True)
    try:
        res1, rep1 = s.run_batch(_variant_batch((0.5, 1.5)))
        assert rep1.run.plan_cache_fallback_rounds >= 1
        assert rep1.run.per_backend.get("torch-seg", 0) == 0
        assert s.plan_cache.executor.drain(timeout=120)
        batch2 = _variant_batch((2.5, 3.5))
        res2, rep2 = s.run_batch(batch2)
        assert rep2.run.plan_cache_fallback_rounds == 0
        assert rep2.run.per_backend.get("torch-seg", 0) > 0
        ref = _scores(ref_s.run_batch(_variant_batch((2.5, 3.5)))[0],
                      batch2)
        np.testing.assert_allclose(_scores(res2, batch2), ref, rtol=1e-6)
        snap = s.plan_cache.snapshot()
        assert snap["async_compiles"] >= 1 and snap["async_failures"] == 0
    finally:
        s.close()


def test_speculative_precompile_warms_future_structure():
    s = _session(compile_async=True, speculative_depth=4)
    try:
        s.run_batch(_variant_batch((0.5, 1.5)))
        assert s.plan_cache.executor.drain(timeout=120)
        s.run_batch(_variant_batch((2.0, 3.0)))
        assert s.plan_cache.executor.drain(timeout=120)
        counts = s.precompile_batch(_variant_batch((4.0, 5.0), log1p=True))
        assert counts.get("enqueued", 0) >= 1
        assert s.plan_cache.executor.drain(timeout=120)
        assert s.plan_cache.snapshot()["speculative_compiles"] >= 1
        batch = _variant_batch((6.0, 7.0), log1p=True)
        res, rep = s.run_batch(batch)
        assert s.plan_cache.snapshot()["speculative_hits"] >= 1
        assert rep.run.per_backend.get("torch-seg", 0) > 0
        ref = _scores(_session(compiled_segments=False).run_batch(
            _variant_batch((6.0, 7.0), log1p=True))[0], batch)
        np.testing.assert_allclose(_scores(res, batch), ref, rtol=1e-6)
    finally:
        s.close()


def test_uncompilable_set_is_lru_bounded_and_gauged():
    pc = PlanCache(capacity=8)
    be = TorchSegmentBackend(pc, uncompilable_max=8)
    for i in range(20):
        be._mark_uncompilable(("sig", i))
    assert len(be._uncompilable) == 8
    assert pc.snapshot()["uncompilable"] == 8
    assert be._is_uncompilable(("sig", 19))
    assert not be._is_uncompilable(("sig", 0))


def test_scheduler_clusters_variant_fans_deterministically():
    s = _session()
    _, _, p1, *_ = s.compile_batch(_variant_batch((0.5, 1.0, 2.0, 4.0)))
    _, _, p2, *_ = s.compile_batch(_variant_batch((0.5, 1.0, 2.0, 4.0)))
    lay1 = [[op.structural_signature for op in w.ops] for w in p1.waves]
    lay2 = [[op.structural_signature for op in w.ops] for w in p2.waves]
    assert lay1 == lay2
    for wave in lay1:
        seen = []
        for sig in wave:
            if sig in seen:
                assert sig == seen[-1], f"non-contiguous fan in {wave}"
            else:
                seen.append(sig)
