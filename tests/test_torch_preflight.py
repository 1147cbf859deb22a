"""The port's pre-flight analysis (``repro_torch.core.analysis``) on the
local target: the counterpart of ``tests/test_preflight.py`` (the service,
fabric and envelope cases wait for ``ROADMAP.md`` A2e and A5).

* The analyzer's verdicts equal the reference's on the same batches: the
  same findings by rule, the same op count, and the same segment partition
  ("torch" for "jax") with the same ops in each segment.
* ``Stratum.analyze_batch`` fake-traces the session's torch segments on the
  inferred avals: as many segments are pre-verified as the plan has torch
  segments, and the run after the analysis traces nothing again.
* ``SubmitOptions(verify=True)`` rejects at submit with ``AnalysisError``;
  the AIDE agent repairs around rejected specs.

Tables are 2,000 rows; sessions run on the CPU.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import pytest

import repro.tabular as JT
import repro_torch.tabular as T
from repro.agents import paper_workload_batches as j_paper
from repro.core import PipelineBatch as JBatch
from repro.core.analysis import analyze as j_analyze
from repro.core.dag import LazyOp as JLazyOp
from repro_torch.agents import paper_workload_batches
from repro_torch.agents.aide import (AIDEAgent, AsyncAIDESearch, PipelineSpec,
                                     second_iteration_batch)
from repro_torch.client import StratumConfig, SubmitOptions, connect
from repro_torch.core import PipelineBatch, Stratum
from repro_torch.core.analysis import AnalysisError, analyze, validate_wiring
from repro_torch.core.dag import TRANSFORM, LazyOp

from _hypothesis_compat import given, settings, st

REPO = Path(__file__).resolve().parent.parent
ROWS = 2000


def _pipeline(ops=T, n_rows=ROWS, cols=(10, 11, 12)):
    x = ops.read("uk_housing", n_rows, seed=0)
    xs = ops.scale(ops.impute(ops.project(x, list(cols))))
    return ops.metric(ops.project(xs, [0]), ops.project(x, [0]), kind="mae")


def _valid_batch(name="p"):
    return PipelineBatch([_pipeline()], [name])


def _invalid_batch(name="bad", op="no_such_op", ops=T, lazy=LazyOp,
                   batch=PipelineBatch):
    t = ops.read("uk_housing", ROWS, seed=0)
    return batch([lazy(op, TRANSFORM, inputs=(t,)).out()], [name])


def _config(**overrides):
    base = dict(memory_budget_bytes=1 << 30, device="cpu",
                hardware_threads=8)
    base.update(overrides)
    return StratumConfig.make(**base)


# one compiled session shared by the executing tests, as an agent's is
_SHARED = Stratum(memory_budget_bytes=1 << 30, device="cpu",
                  hardware_threads=8)


# ---------------------------------------------------------------------------
# the verdicts equal the reference's
# ---------------------------------------------------------------------------

def _summary(report):
    return (report.ok, sorted((f.rule, f.severity, f.op_name)
                              for f in report.findings),
            report.n_ops, report.n_pipelines,
            [(s["kind"].replace("jax", "torch"), s["n_ops"], s["n_waves"],
              s["ops"]) for s in report.segments])


def _corpus(port: bool):
    from repro.agents.aide import PipelineSpec as JSpec
    from repro.agents.aide import second_iteration_batch as j_second
    if port:
        batches = [b for _n, b, _c in paper_workload_batches(n_rows=ROWS)]
        batches.append(second_iteration_batch(PipelineSpec(n_rows=ROWS))[0])
        batches.append(_invalid_batch())
    else:
        batches = [b for _n, b, _c in j_paper(n_rows=ROWS)]
        batches.append(j_second(JSpec(n_rows=ROWS))[0])
        batches.append(_invalid_batch(ops=JT, lazy=JLazyOp, batch=JBatch))
    return batches


def test_verdicts_equal_the_references():
    """Both analyzers at their defaults (the thread count of the host)."""
    for got, want in zip(_corpus(True), _corpus(False)):
        t, r = analyze(got, device="cpu"), j_analyze(want)
        assert _summary(t) == _summary(r)
        assert t.op_shapes.keys() == r.op_shapes.keys()


# ---------------------------------------------------------------------------
# verdict correctness: no false positives, and OK verdicts really execute
# ---------------------------------------------------------------------------

def test_zero_false_positives_on_paper_corpus():
    batches = [b for _n, b, _c in paper_workload_batches(n_rows=ROWS)]
    batches.append(second_iteration_batch(PipelineSpec(n_rows=ROWS))[0])
    for batch in batches:
        report = analyze(batch, device="cpu")
        assert report.ok, [str(f) for f in report.errors]


@settings(max_examples=6, deadline=None)
@given(st.integers(min_value=0, max_value=40))
def test_analyzer_ok_implies_executable(seed):
    """Any AIDE-space batch the analyzer passes executes (one compiled
    session shared by the examples, as an agent's would be)."""
    agent = AIDEAgent(n_rows=ROWS, seed=seed)
    specs = agent.propose(2)
    batch = PipelineBatch([s.build() for s in specs],
                          [f"v{i}" for i in range(len(specs))])
    report = analyze(batch, device="cpu")
    assert report.ok, [str(f) for f in report.errors]
    results, _ = _SHARED.run_batch(batch)
    assert len(results) == len(specs)


def test_invalid_batch_findings_have_provenance():
    report = analyze(_invalid_batch(), device="cpu")
    assert not report.ok
    assert any(f.rule == "unknown-op" and f.op_name == "no_such_op"
               for f in report.errors)
    with pytest.raises(AnalysisError) as ei:
        report.raise_if_invalid()
    assert "unknown-op" in ei.value.rules


# ---------------------------------------------------------------------------
# admission-time rejection on the local target
# ---------------------------------------------------------------------------

def test_verify_rejects_at_submit_on_the_local_target():
    with connect("local", _config()) as client:
        report = client.analyze(_invalid_batch())
        assert not report.ok and "unknown-op" in {f.rule
                                                  for f in report.errors}
        with pytest.raises(AnalysisError):
            client.submit(_invalid_batch(),
                          options=SubmitOptions(verify=True))
        value, rep = client.run(_pipeline(),
                                options=SubmitOptions(verify=True))
        assert float(value) == float(value)
        assert rep.run.per_backend.get("torch-seg", 0) > 0
    # the config default verifies every submission
    with connect("local", _config(admission_analysis=True)) as client:
        with pytest.raises(AnalysisError):
            client.submit(_invalid_batch())


def test_submit_options_verify_must_be_bool():
    with pytest.raises(ValueError):
        SubmitOptions(verify="yes")


def test_analysis_error_pickle_roundtrip():
    err = pytest.raises(
        AnalysisError,
        analyze(_invalid_batch(), device="cpu").raise_if_invalid).value
    clone = pickle.loads(pickle.dumps(err))
    assert isinstance(clone, AnalysisError)
    assert clone.rules == err.rules and clone.findings == err.findings


def test_wiring_error_is_structured_without_analysis():
    with pytest.raises(AnalysisError) as ei:
        Stratum(memory_budget_bytes=1 << 30, device="cpu").run_batch(
            _invalid_batch())
    assert "unknown-op" in ei.value.rules


# ---------------------------------------------------------------------------
# feasibility classification pre-verifies compiled segments
# ---------------------------------------------------------------------------

def test_preverified_segments_recorded_and_results_unchanged():
    """``analyze_batch`` pre-verifies every torch segment of the session's
    plan; the run that follows traces nothing (the probe was discharged)
    and gives the scores of a session that analyzed nothing."""
    name, batch, _ctx = next(iter(paper_workload_batches(n_rows=ROWS)))
    st_ = Stratum(memory_budget_bytes=1 << 30, device="cpu",
                  hardware_threads=8)
    report = st_.analyze_batch(batch)
    assert report.ok and report.segments
    backend = st_._backends["torch"]
    traces = backend.stats()["traces"]
    results, rep = st_.run_batch(batch)
    n_torch = sum(1 for s in rep.plan.segments if s.kind == "torch")
    assert report.preverified_segments == n_torch == 2
    assert backend.stats()["traces"] == traces            # no probe again
    assert backend.stats()["compiles"] == n_torch
    assert rep.run.per_backend["torch-seg"] == 16
    ref, _ = _SHARED.run_batch(paper_workload_batches(n_rows=ROWS)
                               .__next__()[1])
    for key in results:
        assert float(results[key]) == pytest.approx(float(ref[key]),
                                                    rel=1e-6)


def test_feasibility_pass_preverifies_with_a_live_backend():
    """``analyze(..., torch_backend=)`` fake-traces each predicted torch
    segment on the inferred avals and marks it on the backend; nothing
    is compiled."""
    from repro_torch.core.backends import TorchSegmentBackend
    be = TorchSegmentBackend()
    report = analyze(_valid_batch(), device="cpu", torch_backend=be)
    torch_segs = [s for s in report.segments if s["kind"] == "torch"]
    assert torch_segs and all(s["preverified"] for s in torch_segs)
    assert report.preverified_segments == len(torch_segs)
    assert be.stats()["traces"] == len(torch_segs)
    assert be.stats()["compiles"] == 0 and len(be.plan_cache) == 0


def test_analysis_without_compiled_segments_verifies_nothing():
    st_ = Stratum(memory_budget_bytes=1 << 30, device="cpu",
                  compiled_segments=False)
    report = st_.analyze_batch(_valid_batch())
    assert report.ok and report.preverified_segments == 0


# ---------------------------------------------------------------------------
# the agent reads the verdict and repairs instead of resubmitting blind
# ---------------------------------------------------------------------------

def test_aide_agent_never_reproposes_rejected_spec():
    agent = AIDEAgent(n_rows=ROWS, seed=3)
    first = agent.propose(4)
    err = pytest.raises(
        AnalysisError,
        analyze(_invalid_batch(), device="cpu").raise_if_invalid).value
    agent.observe_rejection(first[:2], err)
    assert agent.rejection_rules.get("unknown-op", 0) >= 1
    for _ in range(6):
        for spec in agent.propose(4):
            assert spec not in agent.rejected_specs


def test_async_search_survives_admission_analysis():
    with connect("local", _config(admission_analysis=True)) as client:
        agent = AIDEAgent(n_rows=ROWS, seed=1)
        search = AsyncAIDESearch(client.session("aide"), agent,
                                 batch_size=2, max_inflight=2)
        best = search.run(n_rounds=2)
        assert best is not None and best.score is not None
        assert search.analysis_rejections == 0


# ---------------------------------------------------------------------------
# the runtime's own concurrency lint covers the port's new modules
# ---------------------------------------------------------------------------

def test_concurrency_lint_clean_on_the_port():
    paths = [str(REPO / "src" / "repro_torch" / p) for p in (
        "core/backends/torch_segment.py", "core/plan_cache.py",
        "core/runtime.py", "core/analysis", "agents")]
    out = subprocess.run([sys.executable, str(REPO / "scripts_check_"
                                              "concurrency.py"), *paths],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout + out.stderr


# ---------------------------------------------------------------------------
# lint findings (warnings) don't reject, and reach the report
# ---------------------------------------------------------------------------

def test_lint_warnings_do_not_reject():
    x = T.read("uk_housing", ROWS, seed=0)
    dead = T.scale(T.project(x, [1]))     # never reaches a sink
    sink = T.metric(T.project(x, [0]), T.project(x, [0]), kind="mae")
    report = analyze(PipelineBatch([sink], ["p"]), extra_roots=(dead,),
                     device="cpu")
    assert report.ok
    assert "dead-op" in {f.rule for f in report.findings}
    assert analyze(PipelineBatch([sink], ["p"]), device="cpu").ok


def test_validate_wiring_is_the_always_on_subset():
    findings = validate_wiring(_invalid_batch().fused_sinks())
    assert any(f.rule == "unknown-op" for f in findings)
    assert not [f for f in validate_wiring(_valid_batch().fused_sinks())
                if f.severity == "error"]


def test_shape_inference_runs_a_traceable_impl_on_fake_tensors(monkeypatch):
    """An op with no metadata rule but a traceable torch impl gets its
    output avals from a fake-tensor run of the impl (the reference's
    ``jax.eval_shape``), float64 inputs as float32 as ``to_tier`` gives
    them; an impl that fails there is a warning, never an error."""
    from repro_torch.core import metadata
    from repro_torch.core.analysis.infer import infer_shapes
    from repro_torch.core.dag import toposort
    monkeypatch.delitem(metadata._RULES, "log1p")
    x = T.read("uk_housing", ROWS, seed=0)
    sink = T.log1p(T.project(x, [10, 11]))
    infos, findings = infer_shapes(toposort([sink]))
    assert not findings
    out = infos[sink.op.signature][0]
    assert (tuple(out.shape), out.dtype) == ((ROWS, 2), "float32")
    from repro_torch.core.selection import impls_for
    impl = next(i for i in impls_for("string_encode")
                if i.backend == "torch")
    monkeypatch.setattr(impl, "traceable", True)       # lie: host hashing
    monkeypatch.delitem(metadata._RULES, "string_encode")
    bad = T.string_encode(T.project(x, [5]), dim=4)
    _, findings = infer_shapes(toposort([bad]))
    assert [(f.rule, f.severity) for f in findings] == \
        [("untraceable-impl", "warning")]
