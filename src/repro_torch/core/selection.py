"""Operator selection (paper §4.2): tiered logical→physical hierarchy with
cost-based late binding.

The paper's hierarchy is ``abstract class → logical op → physical leaf``
(e.g. ReadOp → ReadPolars/ReadPandas).  Here each logical op name maps to a
set of :class:`PhysicalImpl` entries, one per backend tier:

* ``python``  — naive interpreted implementation (the Pandas/scikit-learn
                analogue: eager NumPy on the host with the usual temporaries
                and copies),
* ``torch``   — torch implementation on the session's device (the "native /
                Rust kernel" analogue; the reference's ``jax`` tier).  Its
                profile keeps the ``jax`` tier's rates, so the cost model
                makes the reference's choices.  No impl registers a hand
                kernel tier (the reference's ``pallas``): no hand kernel lies
                on the tabular path.

Selection minimizes estimated execution time subject to a per-device memory
budget, using metadata collected by metadata.py (paper: "minimize execution
time under memory constraints").  Fidelity annotations (paper §3 co-design)
can force cheaper approximate implementations during early exploration —
e.g. ``svd`` → ``svd_sketch`` (Frequent-Directions-style) when the pipeline
is annotated ``stage=explore``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from .dag import LazyOp, LazyRef, toposort

# ---------------------------------------------------------------------------
# backend profiles: effective rates used by the cost model.  Rates are
# relative (calibrated by benchmarks/micro_selection.py); absolute accuracy is
# not required — only the *ordering* of candidate implementations matters.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BackendProfile:
    name: str
    flops_per_s: float
    bytes_per_s: float
    dispatch_overhead_s: float  # per-op fixed cost (interpreter / launch)
    mem_multiplier: float       # working-set inflation vs metadata estimate


BACKENDS: dict[str, BackendProfile] = {
    # interpreted tier: per-op dispatch dominates small ops; temporaries
    # inflate memory (Pandas-style copies).
    "python": BackendProfile("python", 2e9, 2e9, 50e-6, 3.0),
    # compiled tier: the reference's "jax" profile, rates unchanged.
    "torch": BackendProfile("torch", 50e9, 10e9, 1e-6, 1.5),
}


@dataclass
class PhysicalImpl:
    op_name: str
    backend: str
    fn: Callable[[LazyOp, Sequence[Any]], tuple]
    # override cost terms; default derives from op.meta
    flops_fn: Optional[Callable[[LazyOp], float]] = None
    bytes_fn: Optional[Callable[[LazyOp], float]] = None
    fidelity: str = "exact"      # "exact" | "approx"
    platforms: tuple = ("cpu", "gpu")
    vmappable: bool = False      # homogeneous variants can batch via vmap
    # pure torch function of (tensor inputs, spec): safe to trace into a
    # whole-segment compiled program (TorchSegmentBackend).  False for impls
    # doing IO, host-side numpy, or data-dependent control flow.  The
    # runtime hands a traceable impl float64 host arrays as float32 on the
    # device, as the reference's jnp.asarray does with x64 off; a
    # non-traceable one gets them at their own dtype, as its host code did.
    traceable: bool = False

    def est_time(self, op: LazyOp) -> float:
        prof = BACKENDS[self.backend]
        flops = self.flops_fn(op) if self.flops_fn else (
            op.meta.flops if op.meta else 0.0)
        nbytes = self.bytes_fn(op) if self.bytes_fn else (
            float(op.meta.peak_bytes) if op.meta else 0.0)
        return (flops / prof.flops_per_s + nbytes / prof.bytes_per_s
                + prof.dispatch_overhead_s)

    def est_mem(self, op: LazyOp) -> int:
        prof = BACKENDS[self.backend]
        base = op.meta.peak_bytes if op.meta else 0
        return int(base * prof.mem_multiplier)


_REGISTRY: dict[str, list[PhysicalImpl]] = {}


def register_impl(op_name: str, backend: str, *, flops_fn=None, bytes_fn=None,
                  fidelity: str = "exact", platforms=("cpu", "gpu"),
                  vmappable: bool = False, traceable: bool = False):
    def deco(fn):
        _REGISTRY.setdefault(op_name, []).append(PhysicalImpl(
            op_name=op_name, backend=backend, fn=fn, flops_fn=flops_fn,
            bytes_fn=bytes_fn, fidelity=fidelity, platforms=platforms,
            vmappable=vmappable, traceable=traceable))
        return fn
    return deco


def impls_for(op_name: str) -> list[PhysicalImpl]:
    return _REGISTRY.get(op_name, [])


# ---------------------------------------------------------------------------
# variant batching (beyond-paper, §Perf H3.4): ops in one wave that differ
# only in scalar hyperparameters execute as ONE vmapped program — the MXU/
# SIMD analogue of the paper's inter-operator parallelism for HPO grids.
# ---------------------------------------------------------------------------

_VMAP_GROUPS: dict[str, tuple] = {}   # op_name -> (key_fn, batch_fn)


def register_vmap_group(op_name: str, key_fn, batch_fn) -> None:
    """key_fn(op) -> hashable group key (must include input signatures);
    batch_fn(ops, inputs) -> list of per-op output tuples."""
    _VMAP_GROUPS[op_name] = (key_fn, batch_fn)


def vmap_group_for(op_name: str):
    return _VMAP_GROUPS.get(op_name)


def reference_impl(op_name: str) -> Optional[PhysicalImpl]:
    """The exact 'python'-tier impl — used by Base mode and constant folding."""
    for impl in _REGISTRY.get(op_name, []):
        if impl.backend == "python" and impl.fidelity == "exact":
            return impl
    for impl in _REGISTRY.get(op_name, []):
        if impl.fidelity == "exact":
            return impl
    return None


# ---------------------------------------------------------------------------
# selection pass
# ---------------------------------------------------------------------------


PLATFORMS = ("cpu", "gpu")


def platform_of(device) -> str:
    """The selection platform of a torch device: "gpu" for cuda, "cpu" for
    cpu."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "gpu"
    if kind == "cpu":
        return "cpu"
    raise ValueError(f"no selection platform for device {device!r}")


def check_platform(platform: str) -> None:
    """A forced platform must be one the port runs on ("" = the device's)."""
    if platform and platform not in PLATFORMS:
        raise ValueError(
            f"platform {platform!r} is not one of {PLATFORMS}: the port runs "
            f"on a CUDA device or the CPU, never on a TPU")


@dataclass
class SelectionConfig:
    platform: str = ""                 # default: the session's device's
    memory_budget_bytes: int = 8 << 30
    allowed_backends: tuple = ("python", "torch")
    honor_fidelity_annotations: bool = True
    device: str = "cuda"

    def resolved_platform(self) -> str:
        check_platform(self.platform)
        return self.platform or platform_of(self.device)


def select(sinks: Sequence[LazyRef], config: SelectionConfig
           ) -> dict[str, PhysicalImpl]:
    """Pick one PhysicalImpl per op signature.  Late binding: the decision is
    stored in a side table (signature → impl), not burned into the DAG, so
    re-planning under different budgets/platforms needs no graph rebuild."""
    platform = config.resolved_platform()
    chosen: dict[str, PhysicalImpl] = {}
    for op in toposort(sinks):
        cands = [i for i in _REGISTRY.get(op.op_name, [])
                 if i.backend in config.allowed_backends
                 and platform in i.platforms]
        if not cands:
            continue  # runtime falls back to the op's own callable / error
        want_approx = (config.honor_fidelity_annotations
                       and op.annotations.get("stage") == "explore")
        if not want_approx:
            exact = [i for i in cands if i.fidelity == "exact"]
            cands = exact or cands
        fitting = [i for i in cands
                   if i.est_mem(op) <= config.memory_budget_bytes]
        pool = fitting or cands  # nothing fits: still pick cheapest-mem
        if not fitting:
            pool = sorted(cands, key=lambda i: i.est_mem(op))[:1]
        # under stage=explore, break est-time ties toward approx impls
        best = min(pool, key=lambda i: (i.est_time(op),
                                        0 if (want_approx
                                              and i.fidelity == "approx")
                                        else 1))
        chosen[op.signature] = best
    return chosen
