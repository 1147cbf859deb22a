"""Training entry point (the counterpart of ``repro.launch.train``), on one
device or on every rank of a mesh.

    python -m repro_torch.launch.train --arch qwen2-7b --full --layers 4
    python -m repro_torch.launch.train --arch granite-moe-3b-a800m --full
    python -m repro_torch.launch.train --arch zamba2-1.2b --full
    python -m repro_torch.launch.train --arch xlstm-1.3b --full
    python -m repro_torch.launch.train --arch qwen2-7b --device cpu --steps 4
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --mesh debug \
        --device cpu --steps 4

Runs on the CUDA device unless ``device="cpu"`` (``--device cpu``) is given;
with no device and no CUDA it raises.  On the card the kernels take bf16
and the flash backward head dims 64 and 128, which the reduced configs
(fp32, head dim 32) do not have: there, give ``--full`` (and ``--layers
N`` where the state does not fit; or ``overrides=``); ``build_trainer``
raises before it allocates a parameter otherwise, and for a config whose
path has a kernel without a backward (``check_card_config``).

With a mesh (``--mesh debug``: (2, 4) over ("data", "model"); ``prod``:
(16, 16); ``prod-multi``: (2, 16, 16)) every rank runs this under
``torchrun``: the policy picks TP / FSDP / EP and the microbatches, each
rank draws only its shards of the parameters, the optimizer state is
ZeRO-sharded, and the checkpoints gather to rank 0.  On one card several
ranks share it over gloo; with a card a rank, NCCL.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import get_config, reduced as reduce_cfg
from ..data.lm import DataConfig, global_batch_at
from ..distributed.collectives import init_from_env
from ..distributed.policy import (make_policy, opt_policy, param_pspecs,
                                  shard_placer, tree_shardings)
from ..kernels.common import resolve_device
from ..models.config import ShapeConfig
from ..models.model import init_params, param_specs
from ..optim import cosine_schedule, pick_optimizer
from ..train.loop import LoopConfig, TrainLoop
from ..train.step import make_train_step
from . import check_card_config
from .mesh import make_debug_mesh, make_production_mesh

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def build_trainer(arch: str, *, use_reduced: bool = True, seq_len: int = 128,
                  global_batch: int = 8, microbatches: int = 2,
                  mesh=None, ckpt_dir: str = DEFAULT_CKPT_DIR,
                  total_steps: int = 100, ckpt_every: int = 25,
                  lr: float = 3e-4, grad_compress: bool = False,
                  inject_preemption_at=None, seed: int = 0, device=None,
                  overrides: dict | None = None) -> TrainLoop:
    """A :class:`TrainLoop` over synthetic step-indexed data, as the JAX
    package's ``build_trainer`` builds it.  ``overrides`` replace fields of
    the model config (for example ``n_layers``).

    With a ``mesh`` (``launch.mesh``; every rank calls this), the policy
    (``make_policy``) sets TP, FSDP, EP and the microbatch count; each rank
    draws its shards of the parameters one layer at a time
    (``init_params(place=...)``), the optimizer state is ZeRO-sharded, and
    the loop checkpoints and resumes by the shardings.  ``device`` names
    the mesh's device type (the card unless ``"cpu"``, as without a
    mesh); the rank's device is the mesh's."""
    device = resolve_device(device)
    if mesh is not None:
        if not mesh.live:
            raise ValueError("the mesh has no ranks: build it on every rank "
                             "with launch.mesh over a process group")
        if device.type != mesh.device.type or device.index not in (
                None, mesh.device.index):
            raise ValueError(f"device {device} is not the mesh's device "
                             f"{mesh.device}")
        device = mesh.device
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    check_card_config(cfg, device, training=True)

    policy = None
    if mesh is not None:
        shape = ShapeConfig("train_cli", seq_len, global_batch, "train")
        policy = make_policy(cfg, shape, mesh, microbatches=microbatches)
        microbatches = policy.microbatches
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch,
                          microbatches=microbatches, seed=seed)
    opt = pick_optimizer(cfg.params_count(),
                         lr=cosine_schedule(lr, 10, total_steps))
    step_fn = make_train_step(cfg, opt, policy=policy,
                              grad_compress=grad_compress)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shardings = None
    if policy is None:
        params = init_params(cfg, gen, device=device)
        opt_state = step_fn.init_opt_state(params)
    else:
        place = shard_placer(param_pspecs(param_specs(cfg), policy, cfg),
                             mesh)
        params = init_params(cfg, gen, device=device, place=place)
        opt_state = step_fn.init_opt_state(params)
        shardings = (
            tree_shardings(param_pspecs(params, policy, cfg), policy),
            tree_shardings(param_pspecs(opt_state, opt_policy(policy),
                                        cfg), policy))

    def batch_fn(step):
        host = global_batch_at(data_cfg, step)
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    loop = TrainLoop(step_fn, params, opt_state, batch_fn, ckpt_dir,
                     LoopConfig(total_steps=total_steps,
                                ckpt_every=ckpt_every),
                     shardings=shardings,
                     inject_preemption_at=inject_preemption_at)
    return loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published widths.  Training keeps 16 B a "
                    "parameter (bf16 params and grads, fp32 accumulators, "
                    "AdamW's fp32 m and v): qwen2-7b's 28 layers need "
                    "122 GB and fail on one 80 GB card; cut the depth "
                    "with --layers (4 layers: 32.4 GB).  "
                    "granite-moe-3b-a800m's 32 need 63.7 GB and fit, "
                    "zamba2-1.2b's 38 18.7 GB, xlstm-1.3b's 48 22.6 GB")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the number of layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="none", choices=["none", "debug",
                                                       "prod", "prod-multi"],
                    help="none: one device; else every rank of a torchrun "
                    "job (debug: 8 ranks, prod: 256, prod-multi: 512)")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (raises without one)")
    args = ap.parse_args()

    mesh = None
    if args.mesh != "none":
        device = init_from_env(resolve_device(args.device).type)
        mesh = {"debug": make_debug_mesh,
                "prod": make_production_mesh,
                "prod-multi": lambda device: make_production_mesh(
                    multi_pod=True, device=device)}[args.mesh](device=device)
    loop = build_trainer(
        args.arch, use_reduced=args.reduced, seq_len=args.seq,
        global_batch=args.batch, microbatches=args.microbatches,
        mesh=mesh,
        ckpt_dir=args.ckpt_dir, total_steps=args.steps,
        ckpt_every=args.ckpt_every, lr=args.lr,
        grad_compress=args.grad_compress,
        device=args.device if mesh is None else mesh.device,
        overrides={"n_layers": args.layers} if args.layers else None)
    t0 = time.time()
    state = loop.run()
    dt = time.time() - t0
    if mesh is not None and mesh.index(mesh.axis_names) != 0:
        return                                   # rank 0 reports
    print(f"trained {state.step} steps in {dt:.1f}s "
          f"(resumed_from={state.resumed_from})")
    if state.losses:
        print(f"loss: first={state.losses[0]:.4f} "
              f"last={state.losses[-1]:.4f}")
    if state.stragglers:
        print(f"stragglers: {state.stragglers}")


if __name__ == "__main__":
    main()
