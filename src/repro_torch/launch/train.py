"""Training entry point (the counterpart of ``repro.launch.train``), on one
device.

    python -m repro_torch.launch.train --arch qwen2-7b --full --layers 4
    python -m repro_torch.launch.train --arch qwen2-7b --device cpu --steps 4

Runs on the CUDA device unless ``device="cpu"`` (``--device cpu``) is given;
with no device and no CUDA it raises.  On the card the kernels take bf16
and a head dim of 128, which the reduced config (fp32, head dim 32) does
not have: there, give ``--full --layers N`` (or ``overrides=``);
``build_trainer`` raises before it allocates a parameter otherwise
(``check_card_config``).  A mesh
(tensor, FSDP or pod sharding) comes with the distributed slice of the port.
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
from ..kernels.common import resolve_device
from ..models.model import init_params
from ..optim import cosine_schedule, pick_optimizer
from ..train.loop import LoopConfig, TrainLoop
from ..train.step import make_train_step
from . import check_card_config

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def build_trainer(arch: str, *, use_reduced: bool = True, seq_len: int = 128,
                  global_batch: int = 8, microbatches: int = 2,
                  mesh=None, ckpt_dir: str = DEFAULT_CKPT_DIR,
                  total_steps: int = 100, ckpt_every: int = 25,
                  lr: float = 3e-4, grad_compress: bool = False,
                  inject_preemption_at=None, seed: int = 0, device=None,
                  overrides: dict | None = None) -> TrainLoop:
    """A :class:`TrainLoop` over synthetic step-indexed data, as the JAX
    package's ``build_trainer`` builds it on one device.  ``overrides``
    replace fields of the model config (for example ``n_layers``)."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (tensor/FSDP sharding) comes with the distributed "
            "slice of the port (see ROADMAP.md); pass mesh=None")
    device = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    check_card_config(cfg, device, training=True)

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch,
                          microbatches=microbatches, seed=seed)
    opt = pick_optimizer(cfg.params_count(),
                         lr=cosine_schedule(lr, 10, total_steps))
    step_fn = make_train_step(cfg, opt, grad_compress=grad_compress)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=device)
    opt_state = step_fn.init_opt_state(params)

    def batch_fn(step):
        host = global_batch_at(data_cfg, step)
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    loop = TrainLoop(step_fn, params, opt_state, batch_fn, ckpt_dir,
                     LoopConfig(total_steps=total_steps,
                                ckpt_every=ckpt_every),
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
                    "with --layers (4 layers: 32.4 GB)")
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
                    help="only 'none' (one device) is ported")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (raises without one)")
    args = ap.parse_args()

    loop = build_trainer(
        args.arch, use_reduced=args.reduced, seq_len=args.seq,
        global_batch=args.batch, microbatches=args.microbatches,
        mesh=None if args.mesh == "none" else args.mesh,
        ckpt_dir=args.ckpt_dir, total_steps=args.steps,
        ckpt_every=args.ckpt_every, lr=args.lr,
        grad_compress=args.grad_compress, device=args.device,
        overrides={"n_layers": args.layers} if args.layers else None)
    t0 = time.time()
    state = loop.run()
    dt = time.time() - t0
    print(f"trained {state.step} steps in {dt:.1f}s "
          f"(resumed_from={state.resumed_from})")
    if state.losses:
        print(f"loss: first={state.losses[0]:.4f} "
              f"last={state.losses[-1]:.4f}")
    if state.stragglers:
        print(f"stragglers: {state.stragglers}")


if __name__ == "__main__":
    main()
