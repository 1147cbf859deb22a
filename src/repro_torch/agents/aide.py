"""AIDE-style agentic pipeline search, simulated deterministically (the
port of ``repro.agents.aide``: the same specs, proposals and seeds; the
pipelines are built from ``repro_torch.tabular``).

The paper's §6 workload, verbatim:

  iteration 1 — all combinations of two preprocessing strategies
      (1) manual: imputation + StringEncoder + custom target encoder +
          StandardScaler,
      (2) TableVectorizer (automatic cleaning + one-hot for low-cardinality +
          StringEncoder for high-cardinality),
    with four models: Ridge, XGBoost, LightGBM, ElasticNet  → 8 pipelines.
  iteration 2 — hyperparameter grid search on the best (preproc, model) pair.

Beyond the paper workload, :class:`AIDEAgent` also implements the AIDE
draft→debug→improve tree policy over :class:`PipelineSpec` mutations, so
larger/broader searches can be generated for scaling experiments.  Each spec
renders to pseudo-code (``to_code``) for the Fig. 2 diff-size statistics.
"""

from __future__ import annotations

import difflib
import random
from dataclasses import dataclass, replace
from typing import Callable, Iterator, Optional, Sequence

from ..core import PipelineBatch, annotate
from ..core.dag import LazyOp, LazyRef, TRANSFORM, host_array
from ..data.tabular import (CATEGORICAL,
                            DATETIME,
                            NUMERIC,
                            feature_target_indices,
                            schema_dict)
from .. import tabular as T

MODELS = ("ridge", "elasticnet", "gbt_xgboost", "gbt_lightgbm")
PREPROCS = ("manual", "table_vectorizer")

_MODEL_SPECS = {
    "ridge": ("ridge_fit", {"alpha": 1.0}),
    "elasticnet": ("elasticnet_fit",
                   {"alpha": 0.001, "l1_ratio": 0.5, "iters": 100}),
    "gbt_xgboost": ("gbt_fit", {"flavor": "xgboost", "n_trees": 20,
                                "depth": 3, "learning_rate": 0.1}),
    "gbt_lightgbm": ("gbt_fit", {"flavor": "lightgbm", "n_trees": 20,
                                 "depth": 3, "learning_rate": 0.1}),
}

_GRIDS = {
    "ridge": [{"alpha": a} for a in
              (0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0)],
    "elasticnet": [{"alpha": a, "l1_ratio": r, "iters": 100}
                   for a in (1e-4, 1e-3, 1e-2) for r in (0.2, 0.5, 0.8)],
    "gbt_xgboost": [{"flavor": "xgboost", "n_trees": t, "depth": d,
                     "learning_rate": lr}
                    for t in (20, 40) for d in (2, 3) for lr in (0.05, 0.1)],
    "gbt_lightgbm": [{"flavor": "lightgbm", "n_trees": t, "depth": d,
                      "learning_rate": lr}
                     for t in (20, 40) for d in (2, 3) for lr in (0.05, 0.1)],
}


@dataclass(frozen=True)
class PipelineSpec:
    """Declarative pipeline description — what the agent 'writes'."""
    preproc: str = "manual"
    model: str = "ridge"
    params: tuple = ()            # sorted (key, value) hyperparams
    cv_k: int = 3
    n_rows: int = 30_000
    data_seed: int = 0
    seed: int = 7
    log_target: bool = True
    clip_outliers: bool = False
    stage: str = "exploit"        # "explore" enables low-fidelity selection

    def params_dict(self) -> dict:
        base = dict(_MODEL_SPECS[self.model][1])
        base.update(dict(self.params))
        return base

    def fit_name(self) -> str:
        return _MODEL_SPECS[self.model][0]

    # -- DAG construction --------------------------------------------------
    def build(self) -> LazyRef:
        feats, tgt = feature_target_indices()
        raw = T.read("uk_housing", self.n_rows, seed=self.data_seed)
        y = T.project(raw, [tgt])
        X = T.project(raw, feats)
        sd = schema_dict()
        kinds, cards = sd["kinds"], sd["cards"]

        if self.preproc == "table_vectorizer":
            Xv = T.table_vectorizer(X, sd, feats)
        else:
            # manual: impute+scale numerics, target- & hash-encode town,
            # one-hot the small categoricals, encode the date
            num = [i for i, c in enumerate(feats) if kinds[c] == NUMERIC]
            low = [i for i, c in enumerate(feats)
                   if kinds[c] == CATEGORICAL and cards[c] <= 16]
            high = [i for i, c in enumerate(feats)
                    if kinds[c] == CATEGORICAL and cards[c] > 16]
            dts = [i for i, c in enumerate(feats) if kinds[c] == DATETIME]
            parts = []
            xn = T.project(X, num)
            if self.clip_outliers:
                xn = LazyOp("clip_outliers", TRANSFORM, spec={"q": 0.01},
                            inputs=(xn,)).out()
            parts.append(T.scale(T.impute(xn)))
            for i in high:
                col = T.project(X, [i])
                parts.append(T.target_encode(col, y, cards[feats[i]],
                                             seed=self.seed))
                parts.append(T.string_encode(col, dim=16, seed=self.seed))
            if low:
                parts.append(T.onehot(T.project(X, low),
                                      [cards[feats[i]] for i in low]))
            for i in dts:
                parts.append(T.datetime_encode(T.project(X, [i])))
            Xv = T.concat(parts)

        if self.log_target:
            y = LazyOp("log1p", TRANSFORM, inputs=(y,)).out()
        est = {"name": self.fit_name(), **self.params_dict()}
        sink = T.cv_score(Xv, y, est, k=self.cv_k, seed=self.seed)
        if self.stage == "explore":
            annotate(sink, stage="explore")
        return sink

    # -- pseudo-code rendering (Fig. 2 diff statistics) ---------------------
    def to_code(self) -> list[str]:
        lines = [
            "import pandas as pd",
            "from sklearn.pipeline import make_pipeline",
            f"df = read_parquet('uk_housing', n_rows={self.n_rows})",
            "y = df['price']",
            "X = df.drop(columns=['price'])",
        ]
        if self.preproc == "table_vectorizer":
            lines += [
                "from skrub import TableVectorizer",
                "vec = TableVectorizer()",
                "Xv = vec.fit_transform(X)",
            ]
        else:
            lines += [
                "num = X.select_dtypes('number')",
                "num = SimpleImputer().fit_transform(num)",
                "num = StandardScaler().fit_transform(num)",
            ]
            if self.clip_outliers:
                lines.append("num = clip_outliers(num, q=0.01)")
            lines += [
                "town_te = TargetEncoder().fit_transform(X['town'], y)",
                "town_se = StringEncoder(dim=16).fit_transform(X['town'])",
                "cats = OneHotEncoder().fit_transform(X[LOW_CARD])",
                "dt = DatetimeEncoder().fit_transform(X['date'])",
                "Xv = np.hstack([num, town_te, town_se, cats, dt])",
            ]
        if self.log_target:
            lines.append("y = np.log1p(y)")
        name, params = self.fit_name(), self.params_dict()
        args = ", ".join(f"{k}={v}" for k, v in sorted(params.items()))
        lines += [
            f"model = {self.model}({args})",
            f"scores = cross_val_score(model, Xv, y, cv={self.cv_k})",
            "print(scores.mean())",
        ]
        return lines


def diff_fraction(a: "PipelineSpec", b: "PipelineSpec") -> float:
    """Fraction of changed lines between two specs' rendered code (Fig. 2a)."""
    ca, cb = a.to_code(), b.to_code()
    sm = difflib.SequenceMatcher(a=ca, b=cb)
    same = sum(m.size for m in sm.get_matching_blocks())
    total = max(len(ca), len(cb))
    return 1.0 - same / total


# ---------------------------------------------------------------------------
# the paper's §6 two-iteration workload
# ---------------------------------------------------------------------------

def paper_workload_batches(n_rows: int = 30_000, cv_k: int = 3,
                           seed: int = 7,
                           best_hint: Optional[tuple] = None
                           ) -> Iterator[tuple[str, PipelineBatch, dict]]:
    """Yields (iteration_name, batch, context).  The caller runs iteration 1,
    selects the best (preproc, model), and passes results back via ``send``
    — implemented instead as a two-phase generator protocol: iteration 2 is
    produced by :func:`second_iteration_batch` given iteration-1 scores."""
    specs = [PipelineSpec(preproc=p, model=m, cv_k=cv_k, n_rows=n_rows,
                          seed=seed)
             for p in PREPROCS for m in MODELS]
    names = [f"{s.preproc}+{s.model}" for s in specs]
    batch = PipelineBatch([s.build() for s in specs], names)
    yield "iteration1", batch, {"specs": dict(zip(names, specs))}


def second_iteration_batch(best_spec: PipelineSpec,
                           scores_by_name: Optional[dict] = None
                           ) -> tuple[PipelineBatch, list[PipelineSpec]]:
    """Grid search around the winning (preproc, model) pair (paper §6)."""
    grid = _GRIDS[best_spec.model]
    specs = [replace(best_spec, params=tuple(sorted(p.items())))
             for p in grid]
    names = [f"grid_{i}" for i in range(len(specs))]
    return PipelineBatch([s.build() for s in specs], names), specs


# ---------------------------------------------------------------------------
# AIDE draft → debug → improve tree policy (generalized search)
# ---------------------------------------------------------------------------

@dataclass
class SearchNode:
    spec: PipelineSpec
    score: Optional[float] = None
    parent: Optional[int] = None


class AIDEAgent:
    """Seeded AIDE-like policy: drafts diverse roots, then improves the best
    leaf by small mutations (hyperparameter tweak ≫ stage swap ≫ model swap —
    mutation sizes calibrated so ~50% of iterations change ≤16% of lines,
    matching Fig. 2a)."""

    def __init__(self, n_rows: int = 30_000, cv_k: int = 3, seed: int = 0,
                 n_drafts: int = 4, explore_first: bool = True):
        self.rng = random.Random(seed)
        self.base = PipelineSpec(n_rows=n_rows, cv_k=cv_k, seed=7)
        self.n_drafts = n_drafts
        self.explore_first = explore_first
        self.nodes: list[SearchNode] = []
        # specs a backend's pre-flight analyzer rejected (docs/ANALYSIS.md):
        # the agent repairs by never re-proposing a known-invalid spec
        self.rejected_specs: set = set()
        self.rejection_rules: dict[str, int] = {}

    def _draft(self) -> PipelineSpec:
        return replace(
            self.base,
            preproc=self.rng.choice(PREPROCS),
            model=self.rng.choice(MODELS),
            stage="explore" if self.explore_first else "exploit",
        )

    def _mutate(self, spec: PipelineSpec) -> PipelineSpec:
        r = self.rng.random()
        if r < 0.55:   # small hyperparameter tweak (most common, small diff)
            params = spec.params_dict()
            key = self.rng.choice(sorted(params))
            val = params[key]
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                scale = self.rng.choice((0.3, 0.5, 2.0, 3.0))
                newv = type(val)(val * scale) if val else val
                params[key] = newv
            return replace(spec, params=tuple(sorted(params.items())),
                           stage="exploit")
        if r < 0.75:   # toggle a preprocessing detail
            return replace(spec, clip_outliers=not spec.clip_outliers,
                           stage="exploit")
        if r < 0.9:    # swap preprocessing strategy
            other = [p for p in PREPROCS if p != spec.preproc][0]
            return replace(spec, preproc=other, stage="exploit")
        # full redraft (large diff)
        return self._draft()

    def _repair(self, candidates: list[PipelineSpec],
                make: Callable[[], PipelineSpec]) -> list[PipelineSpec]:
        """Replace any known statically-invalid candidate with a fresh
        proposal (bounded retries, so a pathological rejection set can
        never spin the proposal loop forever)."""
        if not self.rejected_specs:
            return candidates
        out = []
        for spec in candidates:
            for _ in range(8):
                if spec not in self.rejected_specs:
                    break
                spec = make()
            out.append(spec)
        return out

    def propose(self, batch_size: int = 4) -> list[PipelineSpec]:
        if not self.nodes:
            drafts = [self._draft() for _ in range(min(batch_size,
                                                       self.n_drafts))]
            return self._repair(drafts, self._draft)
        scored = [n for n in self.nodes if n.score is not None]
        scored.sort(key=lambda n: n.score)
        best = scored[0].spec if scored else self._draft()
        return self._repair([self._mutate(best) for _ in range(batch_size)],
                            lambda: self._mutate(best))

    def observe(self, specs: Sequence[PipelineSpec],
                scores: Sequence[float]) -> None:
        for sp, sc in zip(specs, scores):
            self.nodes.append(SearchNode(spec=sp, score=float(sc)))

    def observe_rejection(self, specs: Sequence[PipelineSpec],
                          error=None) -> None:
        """Feed a pre-flight :class:`~repro_torch.core.analysis.AnalysisError`
        verdict back into the search: the rejected specs are remembered
        (``propose`` will not re-draw them) and the violated rules are
        tallied for introspection."""
        self.rejected_specs.update(specs)
        for rule in getattr(error, "rules", ()):
            self.rejection_rules[rule] = self.rejection_rules.get(rule, 0) + 1

    def best(self) -> Optional[SearchNode]:
        scored = [n for n in self.nodes if n.score is not None]
        return min(scored, key=lambda n: n.score) if scored else None

    def speculate(self, max_specs: int = 2) -> list[PipelineSpec]:
        """Likely-next *structural* neighbors of the current best node —
        the prediction feeding speculative plan compilation.

        ``_mutate``'s most common move (a hyperparameter tweak) keeps the
        structural signature, so an already-warm program covers it; the
        moves that need a fresh compile are the single-stage structure
        mutations.  Those are enumerable without consuming ``self.rng``
        (which would perturb the deterministic draft sequence): toggle
        ``clip_outliers``, swap the preprocessing strategy."""
        best = self.best()
        base = best.spec if best is not None else self.base
        neighbors = [
            replace(base, clip_outliers=not base.clip_outliers,
                    stage="exploit"),
            replace(base, preproc=[p for p in PREPROCS
                                   if p != base.preproc][0],
                    stage="exploit"),
        ]
        seen, out = set(), []
        for s in neighbors:
            k = (s.preproc, s.model, s.clip_outliers, s.log_target, s.stage)
            if k not in seen:
                seen.add(k)
                out.append(s)
        return out[:max(0, max_specs)]


# ---------------------------------------------------------------------------
# async search driver: overlap planning with in-flight execution (paper §3)
# ---------------------------------------------------------------------------

class AsyncAIDESearch:
    """Drives an :class:`AIDEAgent` through a non-blocking execution session.

    The synchronous loop (propose → run → observe) serializes the agent
    behind its own executions.  This driver keeps up to ``max_inflight``
    batches in flight: while the service executes batch *k*, the agent is
    already drafting batch *k+1* from whatever results have landed — the
    paper's "decouples pipeline execution from planning and reasoning".

    ``session`` is anything with ``submit(batch) -> future`` whose future's
    ``result()`` returns ``(name→value, report)`` — preferably a
    :class:`repro_torch.client.StratumClient` (or one of its tenant-scoped
    sessions), which makes the driver **target-agnostic**: the same search
    runs unchanged against a local session, a multi-tenant service or a
    sharded fabric.  A :class:`repro_torch.service.Session`
    (or any object with the older keyword surface) still works.

    When the session accepts :class:`repro_torch.client.SubmitOptions` (an
    ``options=`` parameter), the driver submits one options object per
    round; otherwise it falls back to the legacy keyword probes.  Either
    way it stratifies its own traffic: initial *drafts* are exploratory
    bulk work and go in at ``draft_priority`` (default BATCH), while
    *refinements* of the current best node — the work the agent's search
    frontier is actually blocked on — go in at ``refine_priority`` (default
    INTERACTIVE).  ``deadline_s`` (optional) attaches an SLO to every
    refinement submission: on a deadline-aware backend late refinements are
    shed with :class:`~repro_torch.service.queue.DeadlineExceeded` instead of
    silently stalling the search frontier.

    Against a sharded fabric (:class:`repro_torch.service.ShardedStratum`),
    ``shard_affinity=True`` tags every submission of this search with one
    stable affinity key, pinning the whole search tree to a single shard:
    successive rounds mutate the same pipeline prefix, so the shard that
    cached round *k*'s intermediates is exactly where round *k+1* wants to
    run.  Sessions whose ``submit`` lacks an ``affinity`` parameter (plain
    services, bare ``Stratum`` adapters) ignore the flag.
    """

    def __init__(self, session, agent: AIDEAgent, batch_size: int = 4,
                 max_inflight: int = 2,
                 draft_priority=None, refine_priority=None,
                 shard_affinity: bool = False,
                 deadline_s: Optional[float] = None,
                 speculate: bool = False):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        from ..service.priority import Priority
        self.session = session
        self.agent = agent
        self.batch_size = batch_size
        self.max_inflight = max_inflight
        self.deadline_s = deadline_s
        # capability probe up front — catching TypeError around submit()
        # itself would mask real errors and could double-enqueue a batch
        self._supports_priority = False
        self._supports_affinity = False
        self._supports_options = False
        try:
            import inspect
            params = inspect.signature(session.submit).parameters
            var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
            # the unified surface: one SubmitOptions instead of kwargs —
            # it carries priority/affinity/deadline, so supporting options
            # implies supporting all three
            self._supports_options = "options" in params
            self._supports_priority = ("priority" in params or var_kw
                                       or self._supports_options)
            self._supports_affinity = ("affinity" in params or var_kw
                                       or self._supports_options)
        except (AttributeError, TypeError, ValueError):
            pass
        if deadline_s is not None and not (
                self._supports_options or self._supports_priority):
            raise ValueError(
                "deadline_s requires a session accepting SubmitOptions "
                "or the deadline_s keyword (a StratumClient target or a "
                "repro_torch.service Session)")
        self._affinity = None
        if shard_affinity and self._supports_affinity:
            # one stable key per search (NOT drawn from agent.rng — that
            # would perturb the deterministic draft sequence): every round
            # of this tree lands on the shard holding its cached prefix
            self._affinity = f"aide-search-{id(self):x}"
        self.draft_priority = (Priority.BATCH if draft_priority is None
                               else draft_priority)
        self.refine_priority = (Priority.INTERACTIVE
                                if refine_priority is None
                                else refine_priority)
        # speculative plan warm-up: after each refinement submission, hand
        # the backend the agent's likely-next structural neighbors via
        # ``session.precompile`` so their programs compile in the
        # background before the mutation is ever drawn.  Pure hint: only
        # active when the session exposes precompile AND the backend runs
        # with compile_async + speculative_depth > 0
        self._speculate = bool(speculate) and callable(
            getattr(session, "precompile", None))
        self.speculative_batches = 0    # precompile hints actually sent
        self.reports: list = []
        self.deadlines_missed = 0   # refinement rounds shed past their SLO
        self.analysis_rejections = 0  # rounds rejected by pre-flight analysis

    def _submit(self, round_idx: int):
        specs = self.agent.propose(self.batch_size)
        names = [f"r{round_idx}_{i}" for i in range(len(specs))]
        batch = PipelineBatch([s.build() for s in specs], names)
        # drafts (nothing scored yet) are bulk exploration; once the agent
        # is mutating its best node, the search is latency-bound on results
        refining = any(n.score is not None for n in self.agent.nodes)
        prio = self.refine_priority if refining else self.draft_priority
        deadline = self.deadline_s if refining else None
        from ..core.analysis import AnalysisError
        try:
            if self._supports_options:
                from ..client import SubmitOptions
                future = self.session.submit(batch, options=SubmitOptions(
                    priority=prio, affinity=self._affinity,
                    deadline_s=deadline))
            else:
                kwargs: dict = {}
                if self._supports_priority:
                    kwargs["priority"] = prio
                    if deadline is not None:
                        kwargs["deadline_s"] = deadline
                if self._affinity is not None:
                    kwargs["affinity"] = self._affinity
                future = self.session.submit(batch, **kwargs)
        except AnalysisError as e:
            # the backend's admission analyzer rejected the round before
            # execution: repair instead of crash — the agent blacklists
            # the specs and the next propose() re-draws around them
            self.analysis_rejections += 1
            self.agent.observe_rejection(specs, e)
            return None
        if self._speculate and refining:
            self._precompile_neighbors()
        return specs, names, future

    def _precompile_neighbors(self) -> None:
        """Fire-and-forget warm-up hint for the next round's likely
        structural mutations; never allowed to fail a search round."""
        try:
            nxt = self.agent.speculate()
            if not nxt:
                return
            batch = PipelineBatch(
                [s.build() for s in nxt],
                [f"speculative_{i}" for i in range(len(nxt))])
            self.session.precompile(batch)
            self.speculative_batches += 1
        except Exception:  # noqa: BLE001 — a guess must never hurt
            pass

    def _harvest(self, specs, names, future) -> None:
        try:
            results, report = future.result()
        except Exception as e:  # noqa: BLE001 — narrow re-raise below
            from ..core.analysis import AnalysisError
            from ..service.queue import DeadlineExceeded
            if isinstance(e, AnalysisError):
                # a shard-side analyzer rejected the round asynchronously
                # (e.g. the out-of-process fabric, where the verdict rides
                # a ResultEnvelope): same repair path as the sync raise
                self.analysis_rejections += 1
                self.agent.observe_rejection(specs, e)
                return
            if not isinstance(e, DeadlineExceeded):
                raise
            # a refinement missed its SLO and was shed: the search simply
            # proceeds without those observations (stale refinements are
            # worth less than the frontier's time)
            self.deadlines_missed += 1
            return
        self.reports.append(report)
        scores = [float(host_array(results[n])) for n in names]
        self.agent.observe(specs, scores)

    def run(self, n_rounds: int = 4) -> Optional[SearchNode]:
        from collections import deque
        inflight: deque = deque()
        for round_idx in range(n_rounds):
            sub = self._submit(round_idx)
            if sub is None:     # round rejected at admission; repaired
                continue
            inflight.append(sub)
            # only block once the pipeline of in-flight work is full, so
            # proposal of the next round overlaps execution of this one
            while len(inflight) >= self.max_inflight:
                self._harvest(*inflight.popleft())
        while inflight:
            self._harvest(*inflight.popleft())
        return self.agent.best()
