"""Multi-pod dry run: count every (architecture × shape × mesh) cell's step
on one rank of a fake 256- or 512-rank world and record its cost,
collectives, memory and roofline (the counterpart of
``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k \
        --mesh single

The reference lowers and compiles each cell on 256 or 512 forced host
devices.  The port has one process a rank, so a cell runs as rank 0 of a
fake process group (the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg``: every collective returns
at once and sends nothing) over the production mesh, with rank 0's shards
of the parameters, optimizer state, batch and decode state as fake tensors
(``FakeTensorMode``) on the CPU device.  Each kernel wrapper then takes its
plain version and launches nothing, as the reference's CPU dry run takes
its jnp backend.  The step (``make_train_step`` with the optimizer state
under ZeRO, ``make_prefill_step`` or ``decode_step``) runs once under
``hlo_cost.analyze``.  The group exists only inside :func:`run_cell`:
importing this module starts nothing.

Records go to ``results/dryrun_torch.jsonl`` by default (the reference
appends to ``results/dryrun.jsonl``, which ``benchmarks/roofline.py``
reads).  A record has the reference's keys, except that the op count's
bytes are ``bytes_op_model`` (the reference's ``bytes_hlo_dot_model``), the
wall of building and counting the cell is ``count_wall_s`` (in
``compile_s``'s place), and ``per_device_mem_bytes`` has no
``generated_code``: there is no compiled program.  ``temp`` is the
counting pass's peak of live bytes the step allocated, and ``alias`` the
bytes of outputs that are the inputs' storage (the step updates the
parameters, optimizer state or decode state in place).  ``kernel_launches``
(no counterpart) is each kernel's launches during the count, read in the
process that counted: 0 for every kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_NAMES, SHAPES, get_config, shape_applicable
from ..distributed.collectives import shard_shape
from ..distributed.context import use_context
from ..distributed.policy import (decode_state_pspecs, input_pspecs,
                                  make_policy, opt_policy, param_pspecs,
                                  tree_leaves_with_path, tree_map_with_path)
from ..kernels.common import launches
from ..models.model import decode_step as model_decode_step
from ..models.model import param_specs
from ..optim import pick_optimizer
from ..serve.step import make_prefill_step
from ..train.step import make_train_step
from .analysis import analytic_memory_bytes, roofline_from_count
from .hlo_cost import analyze, tree_bytes
from .mesh import make_production_mesh
from .specs import (decode_input_specs, prefill_input_specs,
                    train_input_specs)


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks,
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry "
                           "run makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_fakes(tree, specs, mesh):
    """Fake tensors of this rank's shards of ``tree`` (meta tensors, or any
    leaves with a shape and dtype) under the matching spec tree; call under
    ``FakeTensorMode``."""
    by_path = dict(tree_leaves_with_path(specs))
    return tree_map_with_path(
        lambda path, leaf: torch.empty(
            shard_shape(leaf.shape, by_path[path], mesh), dtype=leaf.dtype),
        tree)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               policy_overrides: dict | None = None,
               cfg_overrides: dict | None = None):
    """Build one (arch × shape × mesh) cell on the current (fake) world.
    Returns (step, args, meta): ``step(*args)``, run under
    ``meta["fake_mode"]`` (which holds ``args``), is rank 0's step;
    ``meta`` also holds the cell's names, policy, config and the local
    bytes of its arguments."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    pol = make_policy(cfg, shape, mesh, **(policy_overrides or {}))
    fake_mode = FakeTensorMode()
    with fake_mode:
        step, args, arg_bytes = fake_step(cfg, shape, pol)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "n_chips": 512 if multi_pod else 256,
            "kind": shape.kind, "policy": {
                "tp": pol.tp, "fsdp": pol.fsdp, "sp": pol.sp,
                "ep": pol.ep_axis, "microbatches": pol.microbatches},
            "cfg": cfg, "pol": pol, "argument_bytes": arg_bytes,
            "fake_mode": fake_mode}
    return step, args, meta


def fake_step(cfg, shape, pol=None, *, microbatches: int = 1,
              max_len: int | None = None):
    """(step, its arguments, their bytes) for ``shape``'s kind, the
    arguments fake tensors (call under ``FakeTensorMode``): under ``pol``
    this rank's step on its shards (the policy's microbatches), without
    one the single-device step on ``microbatches`` of the global batch.
    ``max_len`` is the decode state's cache length (``shape.seq_len`` by
    default; a prefill fills ``shape.seq_len`` of it)."""
    max_len = max_len or shape.seq_len
    pstruct = param_specs(cfg)
    if pol is None:
        params = _fakes(pstruct)
    else:
        params = local_fakes(pstruct, param_pspecs(pstruct, pol, cfg),
                             pol.mesh)
    ctx = pol.context() if pol is not None else None
    if shape.kind == "train":
        opt = pick_optimizer(cfg.params_count())
        M = pol.microbatches if pol is not None else microbatches
        mbs = train_input_specs(cfg, shape, M)
        batch = _fakes(mbs)
        if pol is None:
            step = make_train_step(cfg, opt)
            local_batch = batch
        else:
            # ZeRO-1/2: optimizer state and gradient accumulators are
            # always sharded over the batch axes, as in the reference's
            # launcher; the step takes the global batch and keeps its share
            step = make_train_step(cfg, opt, policy=pol,
                                   grad_pspecs=param_pspecs(
                                       pstruct, opt_policy(pol), cfg))
            local_batch = local_fakes(mbs, input_pspecs(mbs, pol, "train"),
                                      pol.mesh)
        opt_state = step.init_opt_state(params)
        return (step, (params, opt_state, batch),
                tree_bytes((params, opt_state, local_batch)))
    if shape.kind == "prefill":
        pf = make_prefill_step(cfg, max_len=max_len)
        inputs = prefill_input_specs(cfg, shape)
        inputs = (_fakes(inputs) if pol is None else local_fakes(
            inputs, input_pspecs(inputs, pol, "prefill"), pol.mesh))

        def prefill_step(params, inputs):
            with torch.no_grad(), use_context(ctx):
                return pf(params, inputs)
        args = (params, inputs)
        return prefill_step, args, tree_bytes(args)
    tok, sstruct = decode_input_specs(
        cfg, dataclasses.replace(shape, seq_len=max_len))
    if pol is None:
        state, tok = _fakes(sstruct), _fakes(tok)
    else:
        state = local_fakes(sstruct, decode_state_pspecs(
            sstruct, pol, shape.global_batch), pol.mesh)
        tok = local_fakes(tok, input_pspecs(tok, pol, "decode"), pol.mesh)

    def decode(params, state, token):
        with torch.no_grad(), use_context(ctx):
            return model_decode_step(params, state, token, cfg)
    args = (params, state, tok)
    return decode, args, tree_bytes(args)


def _fakes(tree):
    """Fake tensors of ``tree``'s shapes and dtypes (meta stand-ins)."""
    return tree_map_with_path(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype), tree)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             policy_overrides: dict | None = None,
             cfg_overrides: dict | None = None) -> dict:
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, why = shape_applicable(get_config(arch), shape_name)
    if not ok:
        record.update(status="skip", reason=why)
        return record
    try:
        with fake_world(512 if multi_pod else 256):
            step, args, meta = lower_cell(
                arch, shape_name, multi_pod=multi_pod,
                policy_overrides=policy_overrides,
                cfg_overrides=cfg_overrides)
            before = launches()
            with meta["fake_mode"]:
                count = analyze(step, *args)
            launched = {k: n - before[k] for k, n in launches().items()}
            out_bytes = tree_bytes(count.out)
            alias = tree_bytes(count.out, shared_with=args)
            del args, step
        cfg, pol = meta["cfg"], meta["pol"]
        roof, colls = roofline_from_count(count, meta["n_chips"])
        # memory term: analytic fused-backend traffic; the op count's
        # bytes (eager, unfused) are recorded beside it as a bracket
        bytes_ops = roof.bytes_accessed
        roof.bytes_accessed = analytic_memory_bytes(cfg, SHAPES[shape_name],
                                                    pol)
        record.update(
            status="ok", policy=meta["policy"], kind=meta["kind"],
            flops=roof.flops, bytes_accessed=roof.bytes_accessed,
            bytes_op_model=bytes_ops,
            collective_bytes=roof.collective_bytes,
            collectives={"bytes": colls.bytes_by_kind,
                         "count": colls.count_by_kind},
            compute_s=roof.compute_s, memory_s=roof.memory_s,
            collective_s=roof.collective_s, dominant=roof.dominant,
            step_time_s=roof.step_time_s,
            per_device_mem_bytes={
                "argument": meta["argument_bytes"],
                "output": out_bytes,
                "temp": count.peak_live_bytes,
                "alias": alias,
            },
            params=cfg.params_count(),
            active_params=cfg.active_params_count(),
            n_ops=count.n_ops,
            kernel_launches=launched,
            count_wall_s=round(time.time() - t0, 1),
        )
    except Exception as e:  # noqa: BLE001 — recorded, run continues
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:],
                      count_wall_s=round(time.time() - t0, 1))
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    args = ap.parse_args()

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_skip = n_err = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, multi_pod=mp)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    tag = rec["status"].upper()
                    n_ok += tag == "OK"
                    n_skip += tag == "SKIP"
                    n_err += tag == "ERROR"
                    print(f"[{tag}] {arch} × {shape} × {rec['mesh']}"
                          + (f" dominant={rec.get('dominant')}"
                             f" step={rec.get('step_time_s', 0):.3f}s"
                             f" wall={rec.get('count_wall_s')}s"
                             if tag == "OK" else
                             f" {rec.get('reason', rec.get('error', ''))}"),
                          flush=True)
    print(f"dry-run complete: {n_ok} ok / {n_skip} skip / {n_err} error")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
