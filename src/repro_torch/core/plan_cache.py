"""Compiled-plan cache: structural signature → compiled segment program.

Agentic searches emit thousands of structurally identical DAGs (AIDE
refinements differ only in constants and hyperparameters).  A compiled
segment backend traces a whole backend-homogeneous segment into one
callable with tunable constants hoisted to arguments
(:class:`~repro_torch.core.backends.torch_segment.TorchSegmentBackend`);
this module keeps those callables keyed by
the segment's *structural* signature (``dag.py``), so the second
structurally identical plan — from any tenant of the same service shard —
skips tracing and compilation entirely and pays one dispatch per segment.

One :class:`PlanCache` is shared per service shard (wired through
``service/server.py``); hit rates surface in per-shard service telemetry
and in the fabric's aggregated snapshot, where signature-locality routing
makes compiled-plan locality visible fabric-wide.

Entries are LRU-evicted by count, not bytes: a compiled segment's host
footprint is dominated by the compiled program, which the compiler
dedups through its own cache — this layer only bounds the number of live
python callables.

Async compilation (``compile_async=True``): the cache owns a
:class:`CompileExecutor` — one bounded daemon worker thread that runs
trace+compile jobs off the critical path.  A segment backend that misses the
cache enqueues the compile and dispatches the current round per-op; the
next structurally identical round finds the entry warm.  ``submit`` is
single-flight: a key that is already cached, already inflight, or already
queued is rejected, so N tenants racing on the same new signature trace it
once.  A second, lower-priority lane (``speculative=True``, bounded by
``speculative_depth``) carries predictor-driven warm-up jobs; the normal
lane always drains first and speculative entries dropped for lack of room
are counted, never blocked on.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Hashable, Optional


@dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    compiles: int = 0            # callables built and inserted
    evictions: int = 0
    # async-compile lane (all zero when compile_async is off)
    async_compiles: int = 0      # background jobs that completed a build
    async_failures: int = 0      # background jobs that raised
    inflight: int = 0            # gauge: queued + running background jobs
    speculative_compiles: int = 0  # warm-up builds inserted ahead of demand
    speculative_hits: int = 0    # first demand-hit on a speculative entry
    speculative_dropped: int = 0  # warm-up jobs rejected (lane full)
    uncompilable: int = 0        # gauge: backend's bounded uncompilable set
    compile_time_s: float = 0.0  # cumulative seconds in background builds

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CompileExecutor:
    """Bounded single-worker background compiler with single-flight dedup.

    A deliberate non-use of ``ThreadPoolExecutor``: its workers are
    non-daemon and joined at interpreter exit, which would let an inflight
    compile hold a proc-fabric worker process open past SIGTERM.  Here
    the worker is one daemon thread, started lazily on first submit, and
    ``close()`` wakes it and joins with a timeout — a compile still running
    at that point finishes (or not) on a daemon thread that cannot block
    process exit.

    Two lanes: ``normal`` (demand misses, bounded by ``max_pending``) and
    ``speculative`` (predictor warm-ups, bounded by ``speculative_depth``,
    only drained when the normal lane is empty).  ``_inflight`` holds every
    queued-or-running key for single-flight dedup across both lanes.
    """

    def __init__(self, stats: PlanCacheStats, lock: threading.Lock,
                 contains: Callable[[Hashable], bool],
                 max_pending: int = 32, speculative_depth: int = 0):
        self._stats = stats
        self._stats_lock = lock
        self._contains = contains
        self.max_pending = max(1, int(max_pending))
        self.speculative_depth = max(0, int(speculative_depth))
        self._q: "deque[tuple[Hashable, Callable[[], Any]]]" = deque()
        self._spec_q: "deque[tuple[Hashable, Callable[[], Any]]]" = deque()
        self._inflight: set = set()
        self._mu = threading.Condition(threading.Lock())
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self._idle = threading.Event()
        self._idle.set()

    # -- submission ----------------------------------------------------

    def submit(self, key: Hashable, job: Callable[[], Any],
               speculative: bool = False) -> bool:
        """Enqueue ``job`` (a zero-arg compile closure) under ``key``.

        Returns False without queuing when the key is already cached,
        already inflight, the lane is full, or the executor is closed.
        """
        with self._mu:
            if self._closed or key in self._inflight or self._contains(key):
                return False
            lane = self._spec_q if speculative else self._q
            limit = self.speculative_depth if speculative else self.max_pending
            if len(lane) >= limit:
                if speculative:
                    with self._stats_lock:
                        self._stats.speculative_dropped += 1
                return False
            self._inflight.add(key)
            lane.append((key, job))
            self._idle.clear()
            with self._stats_lock:
                self._stats.inflight = len(self._inflight)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="stratum-compile", daemon=True)
                self._worker.start()
            self._mu.notify()
        return True

    def inflight(self, key: Hashable) -> bool:
        with self._mu:
            return key in self._inflight

    # -- worker --------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._mu:
                while not self._q and not self._spec_q and not self._closed:
                    self._idle.set()
                    self._mu.wait()
                if self._closed and not self._q and not self._spec_q:
                    self._idle.set()
                    return
                key, job = (self._q.popleft() if self._q
                            else self._spec_q.popleft())
            t0 = time.perf_counter()
            try:
                job()
                ok = True
            except Exception:
                ok = False
            dt = time.perf_counter() - t0
            with self._mu:
                self._inflight.discard(key)
                with self._stats_lock:
                    self._stats.inflight = len(self._inflight)
                    self._stats.compile_time_s += dt
                    if ok:
                        self._stats.async_compiles += 1
                    else:
                        self._stats.async_failures += 1
                if not self._q and not self._spec_q:
                    self._idle.set()

    # -- lifecycle -----------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until both lanes are empty and no job is running."""
        return self._idle.wait(timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, drop queued jobs, join the worker.

        Idempotent.  A job mid-compile when the timeout expires keeps
        running on the daemon thread but can no longer publish (the
        inflight set is cleared after it finishes regardless; ``submit``
        refuses everything once closed)."""
        with self._mu:
            if self._closed:
                worker = self._worker
            else:
                self._closed = True
                for key, _ in list(self._q) + list(self._spec_q):
                    self._inflight.discard(key)
                self._q.clear()
                self._spec_q.clear()
                with self._stats_lock:
                    self._stats.inflight = len(self._inflight)
                worker = self._worker
                self._mu.notify_all()
        if worker is not None:
            worker.join(timeout)


class PlanCache:
    """Thread-safe LRU of compiled segment callables.

    Keys are hashable descriptors built by the segment backend — the
    segment's structural signature plus whatever runtime cut the backend
    folds in (e.g. which ops were served from the intermediate cache and
    therefore became segment inputs instead of traced ops).

    With ``compile_async=True`` the cache also owns a
    :class:`CompileExecutor` (``self.executor``); the segment backend uses
    it to move trace+compile off the critical path and to accept speculative
    warm-up jobs (``speculative_depth`` > 0)."""

    def __init__(self, capacity: int = 256, compile_async: bool = False,
                 max_async_pending: int = 32, speculative_depth: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.Lock()
        self.stats = PlanCacheStats()
        self._speculative: set = set()   # guarded-by: _lock
        self.executor: Optional[CompileExecutor] = None
        if compile_async:
            self.executor = CompileExecutor(
                self.stats, self._lock, self.__contains__,
                max_pending=max_async_pending,
                speculative_depth=speculative_depth)

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            if key in self._speculative:
                # first demand-hit on a warm-up entry: the prediction paid
                self._speculative.discard(key)
                self.stats.speculative_hits += 1
            return entry

    def put(self, key: Hashable, compiled: Any,
            speculative: bool = False) -> None:
        with self._lock:
            if key not in self._entries:
                self.stats.compiles += 1
                if speculative:
                    self._speculative.add(key)
                    self.stats.speculative_compiles += 1
            self._entries[key] = compiled
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                old, _ = self._entries.popitem(last=False)
                self._speculative.discard(old)
                self.stats.evictions += 1

    def discard(self, key: Hashable) -> None:
        """Drop ``key``'s entry (a program whose graph at new input avals
        failed to compile: the backend runs that key per-op from now on)."""
        with self._lock:
            if self._entries.pop(key, None) is not None:
                self._speculative.discard(key)

    def note_uncompilable(self, n: int) -> None:
        """Backend gauge: current size of its bounded uncompilable set."""
        with self._lock:
            self.stats.uncompilable = n

    def close(self, timeout: float = 5.0) -> None:
        """Shut down the compile executor (no-op when async is off)."""
        if self.executor is not None:
            self.executor.close(timeout)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def snapshot(self) -> dict:
        """Telemetry view, copied under the lock."""
        with self._lock:
            s = self.stats
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": s.hits,
                "misses": s.misses,
                "compiles": s.compiles,
                "evictions": s.evictions,
                "hit_rate": round(s.hit_rate, 6),
                "async": self.executor is not None,
                "async_compiles": s.async_compiles,
                "async_failures": s.async_failures,
                "inflight": s.inflight,
                "speculative_compiles": s.speculative_compiles,
                "speculative_hits": s.speculative_hits,
                "speculative_dropped": s.speculative_dropped,
                "uncompilable": s.uncompilable,
                "compile_time_s": round(s.compile_time_s, 6),
            }
