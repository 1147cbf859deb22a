"""Whole-segment compilation — the compiled backend (the port of the
reference's ``core/backends/jax_segment.py``).

A ``"torch"`` segment contains only ops whose selected implementation is a
*traceable* torch-tier function (``PhysicalImpl.traceable``).  Instead of
dispatching them one by one through python, this backend traces the whole
segment into ONE compiled program:

* **inputs** — values produced outside the compute set (earlier segments,
  intermediate-cache hits, preemption salvage) enter as runtime arguments,
  moved to the session's device through ``runtime.to_tier`` (so
  ``CROSSINGS`` counts them as on the per-op path);
* **tunable constants** — spec fields declared via
  :func:`repro_torch.core.dag.declare_tunable` (``alpha``, ``l1_ratio``,
  ...) are hoisted to 0-d tensor arguments on the device, so
  hyperparameter variants of the same structure reuse one compiled program
  with zero retraces;
* **outputs** — every computed op's outputs are returned and stored back
  into the runtime's value store, so cache inserts, liveness freeing and
  preemption salvage behave exactly as on the per-op path.

**The compile unit.** A segment's function is traced once per plan-cache
key and input avals (shape, dtype, device — as ``jax.jit`` traces once per
aval) by ``make_fx(..., tracing_mode="fake")``: the impls run on fake
tensors, so the trace touches no data and is also the probe (the
counterpart of ``jax.eval_shape``).  The traced ``GraphModule`` is compiled
by ``torch.compile(gm, fullgraph=True, dynamic=False)`` (inductor, on the
CPU and on CUDA) at its first call.  Each trace is a graph of its own with
a code object of its own, so the compiler's per-code recompile limit never
sees two segments; a graph traced at other avals is never run.

Compiled programs live in a :class:`~repro_torch.core.plan_cache.PlanCache`
keyed by the segment's structural signature plus the runtime *cut* (which
ops were served from cache/salvage and therefore became inputs).  The
cache is shared per service shard, so a thousand structurally identical
agent plans compile once and then pay one dispatch per segment.

**Batched variant solves** (``batch_variants=True``): ops inside one
segment that share a structural signature and implementation but differ in
hoisted tunable values (an agent's hyperparameter sweep, coalesced into
one plan) are grouped and traced as ONE ``torch.func.vmap`` call over
stacked tunable columns — a single batched solve instead of N sequential
solves unrolled in the program.  Inputs shared across members (the common
design matrix) pass through unbatched (``in_dims=None``); inputs that
differ are stacked.  Outputs are unstacked per member before commit, so
salvage, cache inserts and telemetry are identical to the unbatched path.
Grouping is a pure function of the plan-cache key, and batched keys carry
a distinct tag, so programs built with and without the knob never mix.

**Async compilation**: when the plan cache owns a
:class:`~repro_torch.core.plan_cache.CompileExecutor`
(``compile_async=True``), a cache miss no longer blocks the round on
trace+compile.  The backend snaps the segment's shape (proxy ops, wiring,
input avals) into a closure, enqueues it on the executor — single-flight,
so concurrent tenants racing on the same new signature compile once — and
dispatches the current round per-op through the fallback path (variant
groups still batched there).  The background job traces, compiles with a
warm call on zero-filled inputs on the device and publishes to the cache;
the next structurally identical round runs compiled.
``precompile_segment`` feeds the same machinery speculatively: a predictor
(e.g. the AIDE driver's next-refinement guess) can enqueue likely-next
shapes at low priority before any tenant submits them, using observed input
avals (falling back to inferred metadata) to warm the exact program.

Semantics at the boundary: the intermediate cache is probed (one
tenant-aware ``get`` per op) *before* tracing — hits become inputs, not
traced ops — and marked candidates are inserted after execution;
cooperative preemption yields between segments.  Failure handling keeps
the reference's "degrades performance, never correctness" contract and
nothing more: a segment shape whose fake trace fails (mis-declared
traceable impl), or whose program raises at its first call (where the
compiler runs), is remembered as uncompilable — kept out of the plan cache
so hit rates stay honest, in an LRU bounded by ``uncompilable_max``, and
counted in the plan cache's ``uncompilable`` gauge — and runs per-op
forever after (a batched build whose trace fails first retries unbatched).
A *later* runtime failure of a compiled program falls back per-op for that
round only, reproducing any precise per-op error exactly as the uncompiled
path would.  No other path catches a compile or launch failure, and the
compiler's own error suppression is never turned on, so no segment runs
eagerly unnoticed.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import torch

from ..dag import LazyOp, tunable_fields
from ..plan_cache import PlanCache
from .base import ExecutionBackend

_EXT, _INT = 0, 1


class _TracedOp:
    """Stand-in for a LazyOp during tracing: exposes exactly the surface
    impl functions read (``op_name``/``op_class``/``spec``/``n_outputs``)
    without pinning the source plan's DAG — no ``inputs``, no ``meta``, so
    a cached compiled segment never keeps a whole submitted plan alive.

    Reading ``seed`` raises: seed *values* are excluded from structural
    signatures, so a traceable impl consuming one would bake this plan's
    seed into a program reused by seed-variants of the same structure.
    The trap turns that contract violation into a trace-time error — the
    backend falls back to per-op execution, degrading performance, never
    correctness."""

    __slots__ = ("op_name", "op_class", "spec", "n_outputs")

    def __init__(self, op_name: str, op_class: str, spec: dict,
                 n_outputs: int):
        self.op_name = op_name
        self.op_class = op_class
        self.spec = spec
        self.n_outputs = n_outputs

    @classmethod
    def of(cls, op: LazyOp) -> "_TracedOp":
        return cls(op.op_name, op.op_class, dict(op.spec), op.n_outputs)

    def with_spec(self, spec: dict) -> "_TracedOp":
        return _TracedOp(self.op_name, self.op_class, spec, self.n_outputs)

    @property
    def seed(self):
        raise TypeError(
            "op.seed is unavailable inside a compiled segment: seed values "
            "are not part of the structural signature, so a traceable impl "
            "must not read them (mark the impl traceable=False)")


# ---------------------------------------------------------------------------
# avals: what a compiled graph is keyed on
# ---------------------------------------------------------------------------

def _aval_of(v):
    if isinstance(v, torch.Tensor):
        return ("arr", tuple(v.shape), v.dtype, str(v.device))
    return ("raw", v)


def _device_name(device) -> str:
    """A device as tensors on it name theirs ("cuda:0", never "cuda")."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _hoist_tensor(value, device) -> torch.Tensor:
    """A hoisted tunable (a scalar hyperparameter) as a 0-d float64 tensor
    on the device, which holds the python float exactly: the impl casts it
    to its working dtype, as it casts the python float on the per-op
    path."""
    return torch.tensor(float(value), dtype=torch.float64, device=device)


class _Graph:
    """One traced graph of a segment at one set of input avals, and its
    compiled form (``torch.compile`` compiles at the first call)."""

    def __init__(self, gm, lens, is_tensor):
        self.gm = gm
        self.lens = lens                  # outputs per compute op
        self.is_tensor = is_tensor        # which external inputs are args
        self.compiled = torch.compile(gm, fullgraph=True, dynamic=False)
        self.ready = False                # its first call returned

    def __call__(self, ext_vals, hoist_vals):
        args = [v.contiguous() for v, t in zip(ext_vals, self.is_tensor)
                if t]
        flat = self.compiled(*args, *hoist_vals)
        outs, i = [], 0
        for n in self.lens:
            outs.append(tuple(flat[i:i + n]))
            i += n
        return tuple(outs)


class _Program:
    """A plan-cache entry: the segment's function and its compiled graphs
    keyed by input avals."""

    def __init__(self, seg_fn, batched: bool):
        self.seg_fn = seg_fn
        self.batched = batched            # variant groups run as vmap calls
        self._graphs: dict = {}           # guarded-by: _lock
        self._lock = threading.Lock()

    def graph(self, avals) -> Optional[_Graph]:
        with self._lock:
            return self._graphs.get(avals)

    def add(self, avals, graph: _Graph) -> None:
        with self._lock:
            self._graphs[avals] = graph


# make_fx keeps its current tracer in a module global, and a compiled
# graph's first call runs dynamo and inductor: the service's executors, the
# runtime's inter-op threads and the compile worker trace and first-call
# graphs under this one lock, so two builds never interleave (a race there
# would surface as a trace failure, i.e. a silent per-op fallback)
_BUILD_LOCK = threading.RLock()


def _trace(seg_fn, ext_specs, n_hoist: int, device) -> _Graph:
    """The probe and the compile unit: ``seg_fn`` traced by ``make_fx`` on
    fake tensors of ``ext_specs``' avals (and 0-d float64 hoists) — no data
    is touched, nothing runs on the device.  Raises if an impl cannot be
    traced."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    is_tensor = tuple(spec[0] == "arr" for spec in ext_specs)
    raws = tuple(None if t else spec[1]
                 for spec, t in zip(ext_specs, is_tensor))
    lens: list = []

    def flat_fn(*args):
        it = iter(args)
        ext = tuple(next(it) if t else raw for t, raw in zip(is_tensor, raws))
        hoist = tuple(it)
        outs = seg_fn(ext, hoist)
        lens[:] = [len(o) for o in outs]
        return [v for o in outs for v in o]

    with _BUILD_LOCK:
        with FakeTensorMode():
            args = [torch.empty(spec[1], dtype=spec[2], device=spec[3])
                    for spec, t in zip(ext_specs, is_tensor) if t]
            args += [torch.empty((), dtype=torch.float64, device=device)
                     for _ in range(n_hoist)]
        gm = make_fx(flat_fn, tracing_mode="fake")(*args)
        return _Graph(gm, tuple(lens), is_tensor)


class TorchSegmentBackend(ExecutionBackend):
    name = "torch"

    def __init__(self, plan_cache: Optional[PlanCache] = None,
                 batch_variants: bool = False,
                 uncompilable_max: int = 1024):
        # a private cache when none is injected: a bare Runtime still
        # benefits within its own lifetime; services inject the shared
        # per-shard cache so all tenants reuse each other's compiles
        self.plan_cache = plan_cache if plan_cache is not None \
            else PlanCache()
        self.batch_variants = bool(batch_variants)
        # programs built with variant batching are traced differently, so
        # they key under a distinct tag — the off path stays identical
        self._key_tag = "torch-seg-vb" if self.batch_variants else "torch-seg"
        # segment shapes whose trace or first call failed (mis-declared
        # traceable impl): go straight to per-op, never re-trace.  Kept OUT
        # of the plan cache so its hit rate reflects compiled reuse only,
        # and bounded so one bad impl on an open-ended stream of distinct
        # structures cannot grow a shard's memory without limit.  Guarded
        # by its own lock: background compile jobs mark entries too.
        self._uncompilable: "OrderedDict" = OrderedDict()  # guarded-by: _unc_lock
        self._uncompilable_max = max(1, int(uncompilable_max))
        self._unc_lock = threading.Lock()
        # keys whose probe the static analyzer already discharged
        # (analysis.preverify_segment), with the graph it traced per input
        # avals: the first dispatch at those avals compiles that graph
        # without tracing again.  Advisory only — a key or avals absent
        # here just traces as before.  Shares _unc_lock with _uncompilable.
        self._preverified: "OrderedDict" = OrderedDict()  # guarded-by: _unc_lock
        self._preverified_max = max(1, int(uncompilable_max))
        # observed avals of segment-external inputs, keyed by the input
        # ref's full signature: speculative precompiles warm with the
        # exact runtime (shape, dtype) instead of trusting inferred
        # metadata, so the warmed program matches the real dispatch
        self._ext_avals: "OrderedDict[str, tuple]" = OrderedDict()  # guarded-by: _aval_lock
        self._ext_avals_max = 4096
        self._aval_lock = threading.Lock()
        # traces (probes) made and graphs compiled, with the seconds spent
        self._stats = {"traces": 0, "compiles": 0,   # guarded-by: _stats_lock
                       "trace_s": 0.0, "compile_s": 0.0}
        self._stats_lock = threading.Lock()

    def stats(self) -> dict:
        """Traces (each one a probe), graphs compiled, and their seconds."""
        with self._stats_lock:
            return dict(self._stats)

    def _count(self, what: str, seconds: float) -> None:
        with self._stats_lock:
            self._stats[what + "s"] += 1
            self._stats[what + "_s"] += seconds

    # ------------------------------------------------------------------
    def execute_segment(self, rt, segment, selection, report) -> None:
        report.waves += len(segment.waves)
        compute: list[LazyOp] = []
        produced: set[str] = set()
        for wave in segment.waves:
            for op in wave.ops:
                sig = op.signature
                if sig in rt._skips:
                    rt._mark_salvaged(op, report)
                    continue
                if sig in produced:
                    continue      # identical-signature peer: one compute
                if sig in rt.preloaded:
                    rt._store(op, rt.preloaded[sig])
                    rt._mark_salvaged(op, report)
                    continue
                # one tenant-aware probe; the hit becomes a segment
                # input instead of a traced op
                if rt._try_cache_hit(op, report) is not None:
                    continue
                compute.append(op)
                produced.add(sig)
        if compute:
            self._run_compiled(rt, segment, compute, selection, report)
        # liveness freeing at the segment boundary (the planner's
        # est_peak_mem accounts for the deferral — see scheduler.plan)
        for wave in segment.waves:
            rt._free_wave(wave)

    # ------------------------------------------------------------------
    def _wiring(self, compute: Sequence[LazyOp]):
        """Input wiring for the compute set: per op, each input is either
        (_INT, producer_position, out_index) — produced inside the segment
        — or (_EXT, arg_position, 0) — fetched from the value store."""
        pos_by_sig: dict[str, int] = {}
        for i, op in enumerate(compute):
            pos_by_sig.setdefault(op.signature, i)
        ext_keys: list[str] = []
        ext_index: dict[str, int] = {}
        in_specs = []
        for op in compute:
            specs = []
            for r in op.inputs:
                p = pos_by_sig.get(r.op.signature)
                if p is not None:
                    specs.append((_INT, p, r.index))
                else:
                    key = r.signature
                    j = ext_index.get(key)
                    if j is None:
                        j = ext_index[key] = len(ext_keys)
                        ext_keys.append(key)
                    specs.append((_EXT, j, 0))
            in_specs.append(tuple(specs))
        return tuple(in_specs), ext_keys

    def _key_parts(self, compute, selection):
        in_specs, ext_keys = self._wiring(compute)
        hoists = tuple(tuple(sorted(tunable_fields(op.op_name)
                                    & set(op.spec))) for op in compute)
        ssigs = tuple(op.structural_signature for op in compute)
        impl_ids = tuple(id(selection[op.signature]) for op in compute)
        # key: structure of every traced op + the cut (which inputs are
        # external) + the exact impl chosen (fidelity annotations can
        # swap impls between structurally identical plans)
        key = (self._key_tag, ssigs, in_specs, impl_ids)
        return key, in_specs, ext_keys, hoists, ssigs, impl_ids

    def _fallback(self, rt, segment, compute, selection, report) -> None:
        """Per-op execution of the segment's compute set, wave-aligned so
        it keeps the python path's pool parallelism, variant batching and
        intra-wave preemption polls — the fallback must never be worse
        than running with compiled segments disabled."""
        pending = {id(op) for op in compute}
        for wave in segment.waves:
            wave_ops = [op for op in wave.ops if id(op) in pending]
            if wave_ops:
                todo = rt._batch_variants(wave_ops, selection, report)
                rt._run_ops_parallel(todo, selection, report)

    # -- uncompilable bookkeeping --------------------------------------

    def _is_uncompilable(self, key) -> bool:
        with self._unc_lock:
            return key in self._uncompilable

    def _mark_uncompilable(self, key) -> None:
        with self._unc_lock:
            self._uncompilable[key] = True
            self._uncompilable.move_to_end(key)
            while len(self._uncompilable) > self._uncompilable_max:
                self._uncompilable.popitem(last=False)
            n = len(self._uncompilable)
        self.plan_cache.note_uncompilable(n)

    # -- statically pre-verified segments (analysis feasibility pass) ---

    def mark_preverified(self, key, avals, graph: _Graph) -> None:
        with self._unc_lock:
            self._preverified.setdefault(key, {})[avals] = graph
            self._preverified.move_to_end(key)
            while len(self._preverified) > self._preverified_max:
                self._preverified.popitem(last=False)

    def _preverified_graph(self, key, avals) -> Optional[_Graph]:
        with self._unc_lock:
            return self._preverified.get(key, {}).get(avals)

    def preverify_segment(self, segment, selection, infos, device=None):
        """Statically discharge a segment's first-dispatch probe.

        Builds the segment program exactly as ``_run_compiled`` would and
        traces it on fake tensors of the analyzer's inferred input avals
        (``infos``: op signature -> list[TensorInfo]; float64 as float32,
        as ``to_tier`` moves them, on ``device``).  On success the
        plan-cache key is marked pre-verified with the traced graph and
        returned — a first dispatch at those avals compiles it without
        tracing again; on failure returns None and changes nothing —
        inferred avals may be less precise than runtime values, so a static
        miss must never poison the runtime's own probe.  Never executes or
        compiles."""
        from ..runtime import tier_dtype
        compute: list = []
        produced: set = set()
        for wave in segment.waves:
            for op in wave.ops:
                if op.signature in produced:
                    continue
                compute.append(op)
                produced.add(op.signature)
        if not compute or any(op.signature not in selection
                              for op in compute):
            return None
        key, in_specs, ext_keys, hoists, _s, _i = self._key_parts(
            compute, selection)
        device = _device_name(device if device is not None else "cpu")
        ext_info: dict = {}
        for op in compute:
            for r in op.inputs:
                if r.op.signature in produced:
                    continue
                outs = infos.get(r.op.signature)
                if outs is None or r.index >= len(outs):
                    return None
                ext_info[r.signature] = outs[r.index]
        try:
            specs = tuple(("arr", tuple(ext_info[k].shape),
                           tier_dtype(ext_info[k].dtype), device)
                          for k in ext_keys)
            protos = [_TracedOp.of(op) for op in compute]
            impl_fns = [selection[op.signature].fn for op in compute]
            seg_fn = self._build(protos, impl_fns, in_specs, hoists, ())
            graph = self._timed_trace(seg_fn, specs,
                                      sum(len(fs) for fs in hoists), device)
        except Exception:  # noqa: BLE001 — advisory probe, stay silent
            return None
        self.mark_preverified(key, specs, graph)
        return key

    # -- observed input avals (speculative warm-up fidelity) -----------

    def _note_ext(self, ext_keys, ext_vals) -> None:
        with self._aval_lock:
            for k, v in zip(ext_keys, ext_vals):
                a = _aval_of(v)
                if a[0] == "raw" and not isinstance(
                        v, (int, float, bool, str, bytes, type(None))):
                    continue   # don't pin arbitrary host objects
                self._ext_avals[k] = a
                self._ext_avals.move_to_end(k)
            while len(self._ext_avals) > self._ext_avals_max:
                self._ext_avals.popitem(last=False)

    @staticmethod
    def _zeros(ext_specs):
        """Zero-filled stand-ins on the device matching recorded avals, so
        warming on them compiles the exact graph the real dispatch will
        look up."""
        out = []
        for spec in ext_specs:
            if spec[0] == "arr":
                _, shape, dtype, device = spec
                out.append(torch.zeros(shape, dtype=dtype, device=device))
            else:
                out.append(spec[1])
        return tuple(out)

    # ------------------------------------------------------------------
    def _run_compiled(self, rt, segment, compute, selection,
                      report) -> None:
        from ..runtime import to_tier
        key, in_specs, ext_keys, hoists, ssigs, impl_ids = self._key_parts(
            compute, selection)
        if self._is_uncompilable(key):
            self._fallback(rt, segment, compute, selection, report)
            return
        with rt._lock:
            raw_ext = [rt._values[k] for k in ext_keys]
        # every compute op selected a traceable torch impl: its inputs go
        # to the device as on the per-op path (float64 host arrays as
        # float32), once a segment input
        ext_vals = tuple(to_tier(raw_ext, selection[compute[0].signature],
                                 rt.device))
        if self.plan_cache.executor is not None:
            self._note_ext(ext_keys, ext_vals)
        hoist_vals = tuple(_hoist_tensor(op.spec[f], rt.device)
                           for op, fs in zip(compute, hoists)
                           for f in fs)
        program = self.plan_cache.get(key)
        with rt._lock:
            if program is None:
                report.plan_cache_misses += 1
            else:
                report.plan_cache_hits += 1
        if program is None:
            groups = self._plan_groups(ssigs, impl_ids, in_specs, hoists) \
                if self.batch_variants else ()
            protos = [_TracedOp.of(op) for op in compute]
            impl_fns = [selection[op.signature].fn for op in compute]
            ex = self.plan_cache.executor
            if ex is not None:
                # async: build off the critical path, run this round
                # per-op.  The job closes over proxies and avals only —
                # never the submitted DAG.
                specs = tuple(_aval_of(v) for v in ext_vals)
                ex.submit(key, self._make_job(
                    key, protos, impl_fns, in_specs, hoists, groups,
                    specs, hoist_vals, rt.device, speculative=False))
                with rt._lock:
                    report.plan_cache_fallback_rounds += 1
                self._fallback(rt, segment, compute, selection, report)
                return
            program = self._build_probed(
                key, protos, impl_fns, in_specs, hoists, groups,
                tuple(_aval_of(v) for v in ext_vals), rt.device)
            if program is None:
                # per-op reproduces any precise error
                self._fallback(rt, segment, compute, selection, report)
                return
            outs = self._call(key, program, ext_vals, hoist_vals, rt.device)
            if outs is None:
                self._fallback(rt, segment, compute, selection, report)
                return
            self.plan_cache.put(key, program)
        else:
            outs = self._call(key, program, ext_vals, hoist_vals, rt.device)
            if outs is None:
                # a runtime failure (possibly transient, e.g. memory): run
                # per-op this round WITHOUT forgetting the compiled program
                # — trace and compile failures were marked uncompilable, so
                # the next structurally identical plan tries compiled again
                self._fallback(rt, segment, compute, selection, report)
                return
        self._commit(rt, compute, outs, report)

    def _call(self, key, program: _Program, ext_vals, hoist_vals, device):
        """The program's outputs for these values, or None: a failed trace
        or first call of a graph marks ``key`` uncompilable (the compiler
        runs in the first call); a later failure only returns None."""
        from ..runtime import linalg_ready
        avals = tuple(_aval_of(v) for v in ext_vals)
        graph = program.graph(avals)
        if graph is not None and graph.ready:
            try:
                return graph(ext_vals, hoist_vals)
            except Exception:  # noqa: BLE001 — runtime failure, per-op
                return None
        if graph is None:
            # a structure seen before at new avals: trace it at these
            try:
                graph = self._timed_trace(program.seg_fn, avals,
                                          len(hoist_vals), device)
            except Exception:  # noqa: BLE001 — tracing failure
                self._mark_uncompilable(key)
                self.plan_cache.discard(key)
                return None
        # the compiled program's first call must not be a thread's first
        # use of the lazily loaded CUDA linear algebra (not thread-safe)
        linalg_ready(device)
        with _BUILD_LOCK:
            t0 = time.perf_counter()
            try:
                outs = graph(ext_vals, hoist_vals)
            except Exception:  # noqa: BLE001 — compile or first-run failure
                self._mark_uncompilable(key)
                self.plan_cache.discard(key)
                return None
            self._count("compile", time.perf_counter() - t0)
            graph.ready = True
        program.add(avals, graph)
        return outs

    def _timed_trace(self, seg_fn, specs, n_hoist, device) -> _Graph:
        t0 = time.perf_counter()
        graph = _trace(seg_fn, specs, n_hoist, device)
        self._count("trace", time.perf_counter() - t0)
        return graph

    def _make_job(self, key, protos, impl_fns, in_specs, hoists, groups,
                  ext_specs, hoist_vals, device, speculative: bool):
        """Background compile closure: trace → compile by a warm call on
        zero-filled inputs on the device → publish.  A trace or warm-call
        failure marks the key uncompilable (the warm call is the program's
        first call), and the demand path runs it per-op."""
        def job():
            program = self._build_probed(
                key, protos, impl_fns, in_specs, hoists, groups, ext_specs,
                device)
            if program is None:
                return           # marked uncompilable; demand runs per-op
            zeros = self._zeros(ext_specs)
            if self._call(key, program, zeros, hoist_vals, device) is None:
                return
            self.plan_cache.put(key, program, speculative=speculative)
        return job

    def _build_probed(self, key, protos, impl_fns, in_specs, hoists,
                      groups, ext_specs, device) -> Optional[_Program]:
        """Build + fake-trace probe, batched first.  A batched build whose
        trace fails (non-uniform member shapes, an impl vmap can't lift)
        silently retries unbatched; only when the plain build also fails
        to trace is the shape marked uncompilable.  The trace of the build
        that passed is kept for the program's first call."""
        n_hoist = sum(len(fs) for fs in hoists)
        for gs in ((groups, ()) if groups else ((),)):
            seg_fn = self._build(protos, impl_fns, in_specs, hoists, gs)
            program = _Program(seg_fn, batched=bool(gs))
            graph = None if gs else self._preverified_graph(key, ext_specs)
            if graph is None:
                try:
                    graph = self._timed_trace(seg_fn, ext_specs, n_hoist,
                                              device)
                except Exception:  # noqa: BLE001 — tracing failure
                    continue
            # the static analyzer's trace (unbatched only: vmap-liftability
            # is a separate question it does not answer) is used as is
            program.add(ext_specs, graph)
            return program
        self._mark_uncompilable(key)
        return None

    # -- variant-group planning ----------------------------------------

    @staticmethod
    def _plan_groups(ssigs, impl_ids, in_specs, hoists):
        """Homogeneous variant groups, as a pure function of the plan-cache
        key components (so every plan that maps to the key gets the same
        grouping).  Members share a structural signature and impl — same
        non-tunable spec, same wiring shape.  What varies per member is
        the batched axis: hoisted tunable values, differing inputs, or
        both — so a whole refinement chain (clip → impute → scale → fit →
        predict → metric) collapses stage by stage into batched calls,
        not just the tunable-carrying ops.  (Members with nothing varying
        cannot exist past CSE; a degenerate group fails the vmap trace
        and retries unbatched.)  A group executes at its LAST member's
        position; any group whose deferral would starve an earlier
        consumer (an internal edge whose producer moves past its reader)
        is dropped, checked to fixpoint since dropping one group shifts
        execution positions."""
        classes: dict = {}
        for i, (s, m) in enumerate(zip(ssigs, impl_ids)):
            classes.setdefault((s, m), []).append(i)
        groups = [tuple(g) for g in classes.values() if len(g) >= 2]
        while groups:
            group_of = {}
            last = {}
            for gi, g in enumerate(groups):
                for i in g:
                    group_of[i] = gi
                last[gi] = max(g)

            def exec_pos(i):
                return last[group_of[i]] if i in group_of else i

            bad = set()
            for i, specs in enumerate(in_specs):
                for tag, p, _oi in specs:
                    if tag == _INT and exec_pos(p) >= exec_pos(i):
                        bad.add(group_of[p] if p in group_of
                                else group_of[i])
            if not bad:
                break
            groups = [g for gi, g in enumerate(groups) if gi not in bad]
        return tuple(groups)

    # ------------------------------------------------------------------
    def _build(self, protos, impl_fns, in_specs, hoists, groups=()):
        """The segment's function ``seg_fn(ext_vals, hoist_vals)`` → one
        tuple of outputs per compute op.  Takes proxies + impl functions,
        never LazyOps: background compile jobs must not pin submitted
        DAGs.

        With ``groups``, each variant group becomes ONE ``torch.func.vmap``
        call: per-member hoisted tunables stack into (k,) columns (in_dims
        0 each); per-member inputs that are the same traced value pass
        through shared (in_dims None), differing ones stack on a new
        leading axis.  Outputs unstack per member, so everything
        downstream — later traced ops, commit, salvage — is oblivious."""
        n = len(protos)
        h_idx, h = [], 0
        for fs in hoists:
            h_idx.append(tuple(range(h, h + len(fs))))
            h += len(fs)
        group_of, last = {}, {}
        for gi, g in enumerate(groups):
            for i in g:
                group_of[i] = gi
            last[gi] = max(g)

        def gather(i, ext_vals, outs):
            return [ext_vals[j] if tag == _EXT else outs[j][oi]
                    for tag, j, oi in in_specs[i]]

        def run_one(i, ext_vals, hoist_vals, outs):
            op = protos[i]
            if hoists[i]:
                # fresh spec per trace: traced values must not leak into
                # the shared proto (concurrent retraces would race on it)
                spec = dict(op.spec)
                for f, hx in zip(hoists[i], h_idx[i]):
                    spec[f] = hoist_vals[hx]
                op = op.with_spec(spec)
            o = impl_fns[i](op, gather(i, ext_vals, outs))
            return o if isinstance(o, tuple) else (o,)

        def run_group(gi, ext_vals, hoist_vals, outs):
            members = groups[gi]
            proto, fn = protos[members[0]], impl_fns[members[0]]
            fields = hoists[members[0]]
            per_in = [gather(m, ext_vals, outs) for m in members]
            dims, bins = [], []
            for t in range(len(per_in[0])):
                vals = [row[t] for row in per_in]
                if all(v is vals[0] for v in vals[1:]):
                    dims.append(None)       # shared (the design matrix)
                    bins.append(vals[0])
                else:
                    dims.append(0)          # member-varying: stack
                    bins.append(torch.stack(vals))
            h_cols = tuple(
                torch.stack([hoist_vals[h_idx[m][t]] for m in members])
                for t in range(len(fields)))

            def member_fn(hv, ins):
                spec = dict(proto.spec)
                for f, v in zip(fields, hv):
                    spec[f] = v
                o = fn(proto.with_spec(spec), list(ins))
                return o if isinstance(o, tuple) else (o,)

            stacked = torch.func.vmap(
                member_fn, in_dims=((0,) * len(fields), tuple(dims)))(
                h_cols, tuple(bins))
            for q, m in enumerate(members):
                outs[m] = tuple(o[q] for o in stacked)

        def seg_fn(ext_vals, hoist_vals):
            outs: list = [None] * n
            for i in range(n):
                gi = group_of.get(i)
                if gi is None:
                    outs[i] = run_one(i, ext_vals, hoist_vals, outs)
                elif i == last[gi]:
                    run_group(gi, ext_vals, hoist_vals, outs)
            return tuple(outs)

        return seg_fn

    # -- speculative warm-up -------------------------------------------

    def precompile_segment(self, segment, selection, cache=None,
                           device=None) -> str:
        """Enqueue a low-priority background compile for a segment of a
        plan that has NOT been submitted — the speculative warm-up hook.
        Simulates the runtime cut against the intermediate cache
        side-effect-free (``in`` probes only: no hit counting, no LRU
        touch, no tenant attribution — the plan is hypothetical), derives
        the same plan-cache key the real dispatch would, and submits on
        the speculative lane.  Input avals come from observations of the
        same input signatures on real runs, falling back to inferred op
        metadata (float64 as float32, on ``device``).  Returns a status
        string (for telemetry/tests): ``enqueued`` | ``cached`` |
        ``inflight`` | ``uncompilable`` | ``rejected`` (lane full /
        closed) | ``no-executor`` | ``empty`` | ``no-spec`` (an input's
        aval is unknown)."""
        from ..runtime import tier_dtype
        ex = self.plan_cache.executor
        if ex is None:
            return "no-executor"
        device = torch.device(device if device is not None else "cpu")
        compute: list[LazyOp] = []
        produced: set[str] = set()
        for wave in segment.waves:
            for op in wave.ops:
                sig = op.signature
                if sig in produced:
                    continue
                if cache is not None and sig in cache:
                    continue      # would be served as a segment input
                compute.append(op)
                produced.add(sig)
        if not compute:
            return "empty"
        key, in_specs, ext_keys, hoists, ssigs, impl_ids = self._key_parts(
            compute, selection)
        if self._is_uncompilable(key):
            return "uncompilable"
        if key in self.plan_cache:
            return "cached"
        if ex.inflight(key):
            return "inflight"
        ref_by_sig: dict = {}
        for op in compute:
            for r in op.inputs:
                ref_by_sig.setdefault(r.signature, r)
        specs = []
        with self._aval_lock:
            observed = {k: self._ext_avals.get(k) for k in ext_keys}
        for k in ext_keys:
            a = observed.get(k)
            if a is None:
                r = ref_by_sig[k]
                try:
                    ti = r.op.meta.outputs[r.index]
                    a = ("arr", tuple(ti.shape), tier_dtype(ti.dtype),
                         _device_name(device))
                except Exception:  # noqa: BLE001 — no inferred metadata
                    return "no-spec"
            specs.append(a)
        hoist_vals = tuple(_hoist_tensor(op.spec[f], device)
                           for op, fs in zip(compute, hoists)
                           for f in fs)
        groups = self._plan_groups(ssigs, impl_ids, in_specs, hoists) \
            if self.batch_variants else ()
        protos = [_TracedOp.of(op) for op in compute]
        impl_fns = [selection[op.signature].fn for op in compute]
        ok = ex.submit(key, self._make_job(
            key, protos, impl_fns, in_specs, hoists, groups,
            tuple(specs), hoist_vals, device, speculative=True),
            speculative=True)
        return "enqueued" if ok else "rejected"

    # ------------------------------------------------------------------
    def _commit(self, rt, compute, outs, report) -> None:
        from ..runtime import ExecutionError, _where
        for op, out in zip(compute, outs):
            if len(out) != op.n_outputs:
                raise ExecutionError(
                    op, ValueError(f"impl returned {len(out)} outputs, "
                                   f"declared {op.n_outputs}"))
            rt._store(op, out)
            sig = op.signature
            with rt._lock:
                report.ops_executed += 1
                report.per_backend["torch-seg"] = \
                    report.per_backend.get("torch-seg", 0) + 1
                report.sig_source[sig] = "torch-seg"
                report.placement[sig] = tuple(_where(v) for v in out)
            if (rt.cache is not None and op.cacheable
                    and sig in rt.cache_candidates):
                rt.cache.put(sig, out, tenant=rt.sig_tenant.get(sig))
