"""The planner core, the runtime's boundary between tiers and the local
client of the port, against ``repro.core`` and ``repro.client``.

* For the quickstart's batch (two pipelines, 3-fold CV of ridge and of a
  20-tree GBT over ``table_vectorizer`` features) and for a grid search
  over three ridge alphas, both packages give the same op signatures,
  rewrite stats, planned-op counts, waves and per-tier counts ("torch" in
  place of "jax"), and the same second-run cache hits; the CV scores agree
  within 1e-3 relative (the torch tier sums the GBT's histograms exactly,
  so an exact tie between two splits can break the other way).
* The session runs on one device and has no fallback: no CUDA raises, the
  service and fabric targets (``ROADMAP.md`` A2e, A5) raise, and a torch
  impl that raises ends the run.  Compiled segments and ``analyze_batch``
  are ported (``tests/test_torch_segments.py``,
  ``tests/test_torch_preflight.py``).
* The cache keeps tensors, spills and exports them as host arrays.

Both packages get ``hardware_threads=8``, which shapes the waves.
"""

import pickle
import warnings

import numpy as np
import pytest
import torch

import repro.tabular as JT
import repro_torch.tabular as T
from repro.client import StratumConfig as JConfig
from repro.client import connect as j_connect
from repro.core import PipelineBatch as JBatch
from repro.data.tabular import feature_target_indices, schema_dict
from repro_torch.client import (LocalTarget, PipelineFuture, StratumConfig,
                                SubmitOptions, connect)
from repro_torch.core import CONST, LazyOp, PipelineBatch, Stratum, toposort
from repro_torch.core import api as t_api
from repro_torch.core.backends import make_backends
from repro_torch.core.cache import IntermediateCache
from repro_torch.core.dag import _hash_payload
from repro_torch.core.metadata import collect_metadata
from repro_torch.core.rewrites import optimize_logical
from repro_torch.core.runtime import (ExecutionError, crossings,
                                      execute_reference, reset_crossings,
                                      to_tier)
from repro_torch.core.selection import (PhysicalImpl, SelectionConfig,
                                        impls_for)

THREADS = 8
ROWS = 3000


def _quickstart(ops, rows=ROWS):
    feats, tgt = feature_target_indices()
    raw = ops.read("uk_housing", n_rows=rows, seed=0)
    y = ops.project(raw, [tgt])
    X = ops.table_vectorizer(ops.project(raw, feats), schema_dict(), feats)
    ridge = ops.cv_score(X, y, {"name": "ridge_fit", "alpha": 1.0}, k=3,
                         seed=7)
    gbt = ops.cv_score(X, y, {"name": "gbt_fit", "n_trees": 20}, k=3,
                       seed=7)
    return [ridge, gbt], ["ridge", "gbt"]


def _grid(ops, rows=ROWS):
    x = ops.read("uk_housing", rows, seed=2)
    y = ops.project(x, [0])
    Xv = ops.scale(ops.impute(ops.project(x, [10, 11, 12, 13])))
    best, idx = ops.grid_search(
        x=Xv, y=y, estimator_name="ridge_fit",
        grid=[{"alpha": a} for a in (0.1, 1.0, 10.0)], k=3, seed=4)
    return [best, idx], ["score", "idx"]


def _cfg(make, **kw):
    return make.make(memory_budget_bytes=16 << 30, compiled_segments=False,
                     hardware_threads=THREADS, **kw)


def _run_both(build, tmp_path, monkeypatch):
    from repro.data import tabular as j_data
    from repro_torch.data import tabular as t_data
    monkeypatch.setattr(j_data, "_LAKE", str(tmp_path))
    monkeypatch.setattr(t_data, "_LAKE", str(tmp_path))
    out = {}
    for name, ops, conn, cfg, batch in (
            ("ref", JT, j_connect, _cfg(JConfig), JBatch),
            ("port", T, connect, _cfg(StratumConfig, device="cpu"),
             PipelineBatch)):
        sinks, names = build(ops)
        client = conn("local", cfg)
        first = client.run_batch(batch(sinks, names))
        second = client.run_batch(batch(sinks, names))
        sigs = [op.signature for w in first[1].plan.waves for op in w.ops]
        out[name] = (first, second, sigs)
    return out


@pytest.mark.parametrize("build", [_quickstart, _grid],
                         ids=["quickstart", "grid_search"])
def test_plan_and_tiers_match_reference(build, tmp_path, monkeypatch):
    out = _run_both(build, tmp_path, monkeypatch)
    (r1, rep1), (r2, rep2), sigs = out["ref"]
    (t1, trep1), (t2, trep2), tsigs = out["port"]
    assert tsigs == sigs                               # same ops, same order
    assert vars(trep1.rewrites) == vars(rep1.rewrites)
    assert (trep1.ops_submitted, trep1.ops_planned) == \
        (rep1.ops_submitted, rep1.ops_planned)
    assert trep1.run.waves == rep1.run.waves
    assert trep1.plan.inter_op_parallelism == rep1.plan.inter_op_parallelism
    assert [len(w.ops) for w in trep1.plan.waves] == \
        [len(w.ops) for w in rep1.plan.waves]
    want_tiers = {k.replace("jax", "torch"): v
                  for k, v in rep1.run.per_backend.items()}
    assert trep1.run.per_backend == want_tiers
    assert trep2.run.ops_from_cache == rep2.run.ops_from_cache > 0
    if build is _grid:       # the three alphas of a fold: one batched solve
        assert trep1.run.per_backend["torch-vmap"] == 9
    for key in r1:
        a, b = float(np.asarray(r1[key])), float(np.asarray(t1[key]))
        assert abs(b - a) <= 1e-3 * abs(a), (key, a, b)
        assert float(np.asarray(t2[key])) == b      # the cache is exact


def test_quickstart_plan_is_the_papers_batch(tmp_path, monkeypatch):
    """The plan the chip phase holds at 1,000,000 rows, here at 3,000:
    6 submitted, 42 planned, cse 6, pushed 4, 14 waves, inter_op 6,
    31 torch and 11 python ops; every torch op's output but read's (host
    numpy, as the reference's) is a tensor on the session's device."""
    from repro_torch.data import tabular as t_data
    monkeypatch.setattr(t_data, "_LAKE", str(tmp_path))
    sinks, names = _quickstart(T)
    s = Stratum(**_cfg(StratumConfig, device="cpu").stratum_kwargs())
    reset_crossings()
    results, rep = s.run_batch(PipelineBatch(sinks, names))
    assert (rep.ops_submitted, rep.ops_planned) == (6, 42)
    assert (rep.rewrites.cse_merged, rep.rewrites.projections_pushed) == \
        (6, 4)
    assert (rep.run.waves, rep.plan.inter_op_parallelism) == (14, 6)
    assert rep.run.per_backend == {"torch": 31, "python": 11}
    ops = {op.signature: op for w in rep.plan.waves for op in w.ops}
    for sig, source in rep.run.sig_source.items():
        where = rep.run.placement[sig]
        if source == "python":
            assert all(w in ("numpy", "float", "int") for w in where), where
        elif ops[sig].op_name == "read":
            assert where == ("numpy",)
        else:
            assert where == ("cpu",) * len(where), (ops[sig].op_name, where)
    assert crossings() == {"to_device": 0, "to_device_bytes": 0,
                           "to_host": 0, "to_host_bytes": 0}  # no card


# ---------------------------------------------------------------------------
# the boundary between tiers
# ---------------------------------------------------------------------------

def _impl(backend, traceable):
    return PhysicalImpl("x", backend, lambda op, ins: ins,
                        traceable=traceable)


def test_runtime_moves_inputs_to_each_tiers_side():
    cpu = torch.device("cpu")
    f64 = np.arange(6.0).reshape(2, 3)
    ints = np.arange(4)
    ten = torch.ones(3, dtype=torch.float64)
    # a traceable torch impl: float64 host arrays as float32 tensors, as the
    # reference's jnp.asarray makes them; tensors on the device as they are
    a, b, c, d = to_tier([f64, ints, ten, 2.5], _impl("torch", True), cpu)
    assert a.dtype == torch.float32 and torch.equal(a.double(),
                                                    torch.from_numpy(f64))
    assert b.dtype == torch.int64 and c is ten and d == 2.5
    # a non-traceable one (host code in the reference) keeps the dtype
    (a,) = to_tier([f64], _impl("torch", False), cpu)
    assert a.dtype == torch.float64
    # the python tier, and an op with no selected impl, get numpy
    for impl in (_impl("python", False), None):
        a, b, c = to_tier([torch.ones(2, dtype=torch.float32), f64, 3],
                          impl, cpu)
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert b is f64 and c == 3
    # a read-only array (the generator's table) is copied, not refused
    ro = f64.copy()
    ro.setflags(write=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (a,) = to_tier([ro], _impl("torch", False), cpu)
    assert torch.equal(a, torch.from_numpy(f64))


def test_crossing_counts_hold_under_concurrent_threads():
    """The inter-op threads count crossings concurrently: 16 threads of
    2,000 counts each, with a shortened switch interval, lose none."""
    import sys
    import threading

    from repro_torch.core.runtime import count_crossing
    reset_crossings()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            count_crossing("to_host", 3) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = crossings()
    reset_crossings()
    assert (got["to_host"], got["to_host_bytes"]) == (32000, 96000)


def test_torch_impl_failure_ends_the_run_without_fallback(monkeypatch):
    """A torch impl that raises ends the run as an ExecutionError; the
    python impl of the same op is never called."""
    calls = []
    torch_impl = next(i for i in impls_for("scaler_fit")
                      if i.backend == "torch")
    py_impl = next(i for i in impls_for("scaler_fit")
                   if i.backend == "python")

    def boom(op, ins):
        raise RuntimeError("planted failure")

    monkeypatch.setattr(torch_impl, "fn", boom)
    monkeypatch.setattr(py_impl, "fn",
                        lambda op, ins: calls.append(op) or (None,))
    x = T.read("uk_housing", 200, seed=0)
    sink = T.scale(T.project(x, [10, 11]))
    s = Stratum(device="cpu", compiled_segments=False, hardware_threads=2,
                enable=("lowering", "selection", "parallel"))
    with pytest.raises(ExecutionError, match="planted failure"):
        s.run(sink)
    assert calls == []


# ---------------------------------------------------------------------------
# the session: device, knobs not yet ported
# ---------------------------------------------------------------------------

def test_stratum_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Stratum(compiled_segments=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Stratum()
    with pytest.raises(RuntimeError, match="CUDA"):
        connect("local", StratumConfig.make(compiled_segments=False))


def test_unported_parts_raise_naming_the_roadmap():
    # the compiled-segment backend (A2b) and the analysis (A2c) are ported
    s = Stratum(device="cpu")                 # compiled_segments=True
    assert set(s._backends) == {"python", "torch"}
    assert set(make_backends(compiled=True)) == {"python", "torch"}
    x = T.read("uk_housing", 100)
    assert s.analyze_batch(PipelineBatch([x], ["x"])).ok
    assert s.precompile_batch(PipelineBatch([x], ["x"])) == {}  # not async
    with pytest.raises(NotImplementedError, match="A2e"):
        connect("service")
    with pytest.raises(NotImplementedError, match="A5"):
        connect("fabric")
    with pytest.raises(ValueError, match="unknown target"):
        connect("nowhere")
    with pytest.raises(ValueError, match="TPU"):
        Stratum(device="cpu", compiled_segments=False, platform="tpu")
    with pytest.raises(ValueError, match="TPU"):
        SelectionConfig(platform="tpu").resolved_platform()
    assert SelectionConfig(device="cuda").resolved_platform() == "gpu"
    assert SelectionConfig(device="cpu").resolved_platform() == "cpu"


def test_jit_cache_dir_is_accepted_and_warns_once(monkeypatch, tmp_path):
    """``jit_cache_dir`` points inductor's on-disk cache at the directory,
    process-wide (the reference's persistent compilation cache); it has
    an effect now, so it warns no time at all."""
    import os
    monkeypatch.setattr(t_api, "_warned_once", set())
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", "unset")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Stratum(device="cpu", jit_cache_dir=str(tmp_path / "d"))
        Stratum(device="cpu", compiled_segments=False, jit_cache_dir="d")
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == os.path.abspath("d")


def test_local_client_config_and_deadline():
    cfg = StratumConfig.make(compiled_segments=False, device="cpu",
                             hardware_threads=2)
    assert cfg.stratum_kwargs()["device"] == "cpu"
    with connect("local", cfg) as client:
        assert isinstance(client, LocalTarget)
        assert client.stratum.device == torch.device("cpu")
        x = T.read("uk_housing", 100)
        fut = client.submit(PipelineBatch([T.project(x, [0])], ["y"]),
                            SubmitOptions(deadline_s=600, tags=("t",)))
        assert isinstance(fut, PipelineFuture) and fut.done()
        results, report = fut.result()
        assert tuple(results["y"].shape) == (100, 1)
        assert client.telemetry.global_snapshot()["deadline"]["met"] == 1


# ---------------------------------------------------------------------------
# tensors in the DAG and in the cache
# ---------------------------------------------------------------------------

def test_tensor_payloads_hash_fold_and_size_as_host_arrays():
    """A tensor hashes by its bytes (as the reference hashes a jax array),
    and a tensor constant takes metadata and folds like a numpy one."""
    v = np.arange(12.0).reshape(3, 4)
    same = LazyOp("const", CONST, spec={"value": torch.from_numpy(v.copy())})
    other = LazyOp("const", CONST, spec={"value": torch.from_numpy(v + 1)})
    a = LazyOp("const", CONST, spec={"value": torch.from_numpy(v)}).out()
    assert a.op.signature == same.signature != other.signature
    assert _hash_payload(torch.from_numpy(v)) == _hash_payload(
        torch.from_numpy(v.copy()))
    s = LazyOp("metric", "eval", spec={"kind": "mae"}, inputs=(a, a)).out()
    collect_metadata([s])
    assert a.op.meta.outputs[0].shape == (3, 4)
    out, stats = optimize_logical([s], execute_reference)
    assert stats.constants_folded >= 1 and out[0].op.op_class == CONST
    assert float(np.asarray(out[0].op.spec["value"])) == 0.0


def test_cache_keeps_tensors_and_spills_them_as_host_arrays(tmp_path):
    c = IntermediateCache(budget_bytes=3000, spill_dir=str(tmp_path))
    t = torch.arange(256, dtype=torch.float64)            # 2 KB
    c.put("a", (t, 3))
    assert c.stats.bytes_in_ram == t.nbytes + 64
    assert c.get("a")[0] is t                             # kept as given
    c.put("b", (t.clone(),))                              # evicts "a"
    reloaded = c.get("a")                                 # from disk
    assert isinstance(reloaded[0], np.ndarray)
    assert np.array_equal(reloaded[0], t.numpy()) and reloaded[1] == 3
    hot = c.export_hot_entries()
    assert hot and all(isinstance(pickle.loads(blob)[0], np.ndarray)
                       for _, blob in hot)
    c2 = IntermediateCache(budget_bytes=3000)
    assert c2.import_spilled(hot) == len(hot)
