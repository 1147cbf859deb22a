"""The mesh, its collectives, shards of full tensors, and the rank launcher.

The JAX package is single-controller: one program sees every device of a
``jax.sharding.Mesh`` and writes its per-shard regions with ``shard_map``.
The port is multi-controller: one process per rank, each holding its
shards, talking over ``torch.distributed`` process groups.  This module is
what the two designs share the meaning of:

* :class:`Mesh` — axis names and sizes (all that the policy reads, so it
  can be built with no process at all), and once ranks exist this rank's
  coordinates, its device, one process group per set of axes and a
  ``DeviceMesh`` with the same ``mesh_dim_names``.
* :func:`local_shard` / :func:`gather_full` — a full tensor to this rank's
  shard under a spec and back.  A dim of size n over k shards is cut into
  pieces of ⌈n/k⌉ with the last ones short or empty, as JAX pads the last
  shard (``torch.chunk`` would give fewer than k pieces).
* The collectives on a differentiated path are ``autograd.Function``s whose
  backward is the transpose the reference's autodiff takes (Megatron's
  conjugate pair): :func:`enter_split` (identity forward, all-reduce
  backward) where a replicated value enters a region split over an axis,
  :func:`leave_split` (all-reduce forward, identity backward) where the
  split region's partial results are summed, and :func:`gather_on_use`
  (all-gather forward; backward a reduce-scatter over the axes the batch is
  split on, where each rank's gradient is a partial sum, else the rank's
  slice, where every rank computed the same gradient).
* :func:`spawn` — W ranks under ``torch.multiprocessing``'s spawn, or the
  ranks ``torchrun`` started (:func:`init_from_env`).

On one card several ranks share the device over gloo (NCCL refuses two
ranks on one device).  Gloo takes CUDA tensors for every collective used
here (``all_reduce``, ``all_gather``, ``reduce_scatter_tensor``; see
``python -m repro_torch.distributed.probe`` on a card), so nothing is
staged through host memory by this module.  ``COLLECTIVE_BYTES`` counts the
payload each kind sends from this rank, and ``COLLECTIVE_COUNTS`` its calls.
"""

from __future__ import annotations

import itertools
import math
import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

# bytes each kind of collective sent from this process (this rank)
COLLECTIVE_BYTES: dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                                    "reduce_scatter": 0}
# calls of each kind made by this process (this rank)
COLLECTIVE_COUNTS: dict[str, int] = dict.fromkeys(COLLECTIVE_BYTES, 0)


def reset_collective_bytes() -> None:
    """Both counters to 0."""
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0
        COLLECTIVE_COUNTS[k] = 0


def _sent(kind: str, t: torch.Tensor) -> None:
    COLLECTIVE_BYTES[kind] += t.numel() * t.element_size()
    COLLECTIVE_COUNTS[kind] += 1


def axes_of(entry) -> tuple:
    """A spec entry (None, an axis name, or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class Mesh:
    """Axis names and sizes, row-major over the ranks: rank r sits at
    ``unravel_index(r, sizes)``, as ``jax.make_mesh`` orders a host's
    devices.  Without ranks (``groups`` empty) it serves the policy and the
    spec functions only; :meth:`over_world` adds this rank's place."""

    shape: dict                          # axis name -> size, in mesh order
    device: Optional[torch.device] = None
    coords: dict = field(default_factory=dict)   # axis -> this rank's index
    groups: dict = field(default_factory=dict)   # axes tuple -> group
    device_mesh: Any = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def live(self) -> bool:
        return bool(self.groups)

    def axes_size(self, entry) -> int:
        return math.prod(self.shape[a] for a in axes_of(entry))

    def index(self, entry) -> int:
        """This rank's linear index over the axes of ``entry`` (row-major
        in the order named, as JAX linearises a tuple spec entry)."""
        idx = 0
        for a in axes_of(entry):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, entry):
        axes = tuple(a for a in self.axis_names if a in axes_of(entry))
        if tuple(a for a in axes_of(entry)) != axes:
            raise ValueError(f"axes {axes_of(entry)} are not in mesh order "
                             f"{self.axis_names}")
        return self.groups[axes]

    @classmethod
    def over_world(cls, shape, axes, device=None, *,
                   ranks=None) -> Optional["Mesh"]:
        """The mesh of ``shape`` over ``axes`` on the current process group:
        every rank must call it, in the same order as every other group it
        creates.  Raises unless the world (or ``ranks``, a part of it, in
        mesh order) has exactly prod(shape) ranks; a rank outside
        ``ranks`` gets None.  A mesh over the whole world also gets a
        ``DeviceMesh`` with the same ``mesh_dim_names``."""
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in length")
        if not dist.is_initialized():
            raise RuntimeError("no process group: start the ranks first "
                               "(repro_torch.distributed.spawn, or torchrun)")
        world = dist.get_world_size()
        ranks = list(range(world)) if ranks is None else list(ranks)
        if math.prod(shape) != len(ranks):
            raise ValueError(f"a mesh of {dict(zip(axes, shape))} needs "
                             f"{math.prod(shape)} ranks; "
                             f"{'the world has' if len(ranks) == world else 'given'} "
                             f"{len(ranks)}")
        me = dist.get_rank()
        pos = ranks.index(me) if me in ranks else None
        groups = {}
        # one group per non-empty set of axes (in mesh order): ranks that
        # share every coordinate outside the set.  Every rank creates every
        # group, in the same order, as new_group requires.
        for n in range(1, len(axes) + 1):
            for sub in itertools.combinations(range(len(axes)), n):
                others = [i for i in range(len(axes)) if i not in sub]
                for fixed in itertools.product(*(range(shape[i])
                                                 for i in others)):
                    members = [r for j, r in enumerate(ranks)
                               if all(_unravel(j, shape)[i] == f
                                      for i, f in zip(others, fixed))]
                    g = dist.new_group(members)
                    if me in members:
                        groups[tuple(axes[i] for i in sub)] = g
        device = torch.device(device) if device is not None else \
            torch.device("cpu")
        dm = None
        if len(ranks) == world:                    # every rank builds it
            from torch.distributed.device_mesh import DeviceMesh
            dm = DeviceMesh(device.type,
                            torch.tensor(ranks).reshape(shape),
                            mesh_dim_names=axes)
        if pos is None:
            return None
        return cls(shape=dict(zip(axes, shape)), device=device,
                   coords=dict(zip(axes, _unravel(pos, shape))),
                   groups=groups, device_mesh=dm)


def _unravel(r: int, shape) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def to_placements(spec, mesh: Mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the axis shards tensor dim d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for a in axes_of(entry):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.axis_names)


# ---------------------------------------------------------------------------
# shards of full tensors
# ---------------------------------------------------------------------------


def shard_bounds(n: int, k: int, i: int) -> tuple[int, int]:
    """[lo, hi) of shard i of a dim of n over k shards: pieces of ⌈n/k⌉,
    the last ones short or empty (JAX's padded last shard)."""
    step = -(-n // k)
    lo = min(i * step, n)
    return lo, min(lo + step, n)


def local_shard(full: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec`` (a view)."""
    out = full
    for d, entry in enumerate(spec):
        k = mesh.axes_size(entry)
        if k > 1:
            lo, hi = shard_bounds(full.shape[d], k, mesh.index(entry))
            out = out.narrow(d, lo, hi - lo)
    return out


def shard_shape(full_shape, spec, mesh: Mesh) -> tuple:
    shape = list(full_shape)
    for d, entry in enumerate(spec):
        k = mesh.axes_size(entry)
        if k > 1:
            lo, hi = shard_bounds(full_shape[d], k, mesh.index(entry))
            shape[d] = hi - lo
    return tuple(shape)


def all_gather_dim(t: torch.Tensor, dim: int, entry, mesh: Mesh,
                   n: int) -> torch.Tensor:
    """Concatenate every rank's piece of dim ``dim`` over the axes of
    ``entry`` into the full size ``n`` (pieces padded to ⌈n/k⌉ for the
    collective, the padding dropped)."""
    k = mesh.axes_size(entry)
    step = -(-n // k)
    piece = t.movedim(dim, 0)
    if piece.shape[0] < step:
        pad = piece.new_zeros((step - piece.shape[0],) + piece.shape[1:])
        piece = torch.cat([piece, pad])
    piece = piece.contiguous()
    # the ranks' pieces land side by side in one buffer (no concatenation)
    out = piece.new_empty((k * step,) + piece.shape[1:])
    _sent("all_gather", piece)
    dist.all_gather(list(out.chunk(k)), piece, group=mesh.group(entry))
    return out[:n].movedim(0, dim)


def all_reduce(t: torch.Tensor, entry, mesh: Mesh, op: str = "sum"):
    """All-reduce ``t`` over the axes of ``entry``, returning a new
    tensor.  Floating tensors are summed in fp32 and cast back."""
    if mesh.axes_size(entry) == 1:
        return t.clone()
    buf = (t.float() if t.is_floating_point() else t).clone().contiguous()
    _sent("all_reduce", buf)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group(entry))
    return buf.to(t.dtype)


def reduce_scatter_dim(t: torch.Tensor, dim: int, entry, mesh: Mesh,
                       m: int) -> torch.Tensor:
    """Sum ``t`` over the axes of ``entry`` and keep this rank's piece of
    dim ``dim`` (``m`` long; pieces of ⌈n/k⌉, the last ones short), in
    t's dtype: a parameter's gradient is reduced in the parameter's dtype,
    as each rank's autograd produced it."""
    k = mesh.axes_size(entry)
    n = t.shape[dim]
    step = -(-n // k)
    full = t.movedim(dim, 0)
    if step * k > n:
        pad = full.new_zeros((step * k - n,) + full.shape[1:])
        full = torch.cat([full, pad])
    full = full.contiguous()
    out = full.new_empty((step,) + full.shape[1:])
    _sent("reduce_scatter", full)
    dist.reduce_scatter_tensor(out, full, group=mesh.group(entry))
    return out[:m].movedim(0, dim)


def gather_full(local: torch.Tensor, spec, mesh: Mesh,
                full_shape=None) -> torch.Tensor:
    """The full tensor of which every rank holds its ``local_shard`` under
    ``spec`` (no gradient).  ``full_shape`` defaults to the sizes the
    shards imply when every dim divides evenly."""
    out = local
    for d, entry in enumerate(spec):
        k = mesh.axes_size(entry)
        if k > 1:
            n = full_shape[d] if full_shape is not None else \
                local.shape[d] * k
            out = all_gather_dim(out, d, entry, mesh, n)
    return out


def reshard(local: torch.Tensor, src, dst, mesh: Mesh):
    """``local`` under spec ``src`` → its shard under spec ``dst``: a local
    slice (a view) where ``dst`` only adds axes to dims ``src`` leaves
    whole; a gather of just those dims where it only drops them; else
    through the full tensor."""
    if tuple(src) == tuple(dst):
        return local
    pairs = list(zip(src, dst))
    if all(s is None or s == t for s, t in pairs):
        out = local
        for d, (s, t) in enumerate(pairs):
            if s is None and t is not None and mesh.axes_size(t) > 1:
                lo, hi = shard_bounds(local.shape[d], mesh.axes_size(t),
                                      mesh.index(t))
                out = out.narrow(d, lo, hi - lo)
        return out
    if all(t is None or s == t for s, t in pairs):
        out = local
        for d, (s, t) in enumerate(pairs):
            if t is None and s is not None and mesh.axes_size(s) > 1:
                out = all_gather_dim(out, d, s, mesh,
                                     local.shape[d] * mesh.axes_size(s))
        return out
    return local_shard(gather_full(local, src, mesh), dst, mesh)


# ---------------------------------------------------------------------------
# collectives with gradients
# ---------------------------------------------------------------------------


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, entry, mesh):
        ctx.entry, ctx.mesh = entry, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.entry, ctx.mesh), None, None


class _LeaveSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, entry, mesh):
        return all_reduce(x, entry, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def enter_split(x: torch.Tensor, entry, mesh: Mesh) -> torch.Tensor:
    """``x``, replicated over the axes of ``entry``, enters a region that
    each rank computes a part of: identity forward; the backward sums the
    ranks' partial gradients."""
    if mesh.axes_size(entry) == 1 or not torch.is_grad_enabled():
        return x
    return _EnterSplit.apply(x, entry, mesh)


def leave_split(x: torch.Tensor, entry, mesh: Mesh) -> torch.Tensor:
    """Sum the ranks' partial results over the axes of ``entry`` (fp32,
    cast back); the backward hands every rank the replicated gradient
    (an all-reduce there would count it once per rank)."""
    if mesh.axes_size(entry) == 1:
        return x
    if not torch.is_grad_enabled():
        return all_reduce(x, entry, mesh)
    return _LeaveSplit.apply(x, entry, mesh)


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, entry, mesh, n, reduce):
        ctx.args = (dim, entry, mesh, x.shape[dim], reduce)
        return all_gather_dim(x, dim, entry, mesh, n)

    @staticmethod
    def backward(ctx, g):
        dim, entry, mesh, m, reduce = ctx.args
        if reduce:
            g = reduce_scatter_dim(g, dim, entry, mesh, m)
        else:
            lo, _ = shard_bounds(g.shape[dim], mesh.axes_size(entry),
                                 mesh.index(entry))
            g = g.narrow(dim, lo, m)
        return g, None, None, None, None, None


def gather_on_use(x: torch.Tensor, dim: int, entry, mesh: Mesh, n: int,
                  batch_axes=()) -> torch.Tensor:
    """Gather dim ``dim`` of the parameter shard ``x`` over the axes of
    ``entry`` to its full size ``n``, just before a layer uses it.  The
    backward reduce-scatters over those axes when they split the batch
    (``batch_axes``: each rank's gradient is a partial sum), and keeps the
    rank's slice where every rank computed the same gradient."""
    if mesh.axes_size(entry) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_gather_dim(x, dim, entry, mesh, n)
    reduce = all(a in batch_axes for a in axes_of(entry))
    return _GatherOnUse.apply(x, dim, entry, mesh, n, reduce)


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device: torch.device, world: int) -> str:
    """gloo on the CPU, and for several ranks on one card (NCCL refuses
    two ranks on one device); NCCL where each rank has a card."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cuda":
        return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")
    return torch.device("cpu")


def init_process(rank: int, world: int, port: int,
                 device_type: str) -> torch.device:
    """Join the process group of ``world`` ranks at localhost:``port`` as
    ``rank``; returns this rank's device (made current on a card)."""
    device = rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(device, world),
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return device


def init_from_env(device_type: str) -> torch.device:
    """Join the process group ``torchrun`` set up (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns this rank's device."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    device = rank_device(device_type, int(os.environ.get("LOCAL_RANK",
                                                         rank)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(device, world), world_size=world,
                            rank=rank)
    return device


def _rank_main(rank, world, port, device_type, fn, args, results):
    try:
        device = init_process(rank, world, port, device_type)
        out = fn(rank, world, device, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:                            # reported, then exit
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankFailed(RuntimeError):
    """A spawned rank raised, exited or outlived its time."""


def spawn(fn: Callable, world: int, args: tuple = (), *,
          device_type: str = "cpu", timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    (spawn) joined in one process group on a free localhost port; returns
    each rank's result in rank order.  ``fn`` and its results must pickle:
    ``fn`` by its module's import path.  A rank that raises, dies or runs
    past ``timeout`` seconds fails the call (``RankFailed``, with its
    traceback), and every rank still running is killed."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, device_type, fn, args,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    failures = []
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world and not failures:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    failures.append(f"timed out after {timeout:.0f} s with "
                                    f"ranks {sorted(got)} done")
                for r, p in enumerate(procs):
                    if r not in got and not p.is_alive() and \
                            p.exitcode not in (0, None):
                        failures.append(f"rank {r} exited {p.exitcode}")
                continue
            if ok:
                got[rank] = out
            else:
                failures.append(f"rank {rank} raised:\n{out}")
    finally:
        for p in procs:
            p.join(timeout=10 if not failures else 1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    if failures:
        raise RankFailed("; ".join(failures))
    return [got[r] for r in range(world)]
