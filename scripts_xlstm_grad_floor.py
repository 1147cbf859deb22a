"""Why the xlstm gradient check's bf16 floors are large at one segment, on
the CPU (the port's plain versions, no card needed).

``chip_smoke.py``'s train_ssm phase holds the card's bf16 gradients against
the CPU's fp32 ones within twice the CPU's own bf16 run's distance from them
(the floor).  At 8 blocks (one segment of xlstm-1.3b: 7 mLSTM blocks and an
sLSTM block, full width, 2 x 256 tokens) the mLSTM leaves' floors read
~0.3.  This script prints, for each gradient leaf:

* ``floor``: the bf16 run's rel L2 from the fp32 run;
* ``noise``: an fp32 run whose w_q is perturbed by relative N(0, 2^-9)
  noise, about one bf16 rounding, against the fp32 run: whether the
  gradient itself moves that much under a perturbation of that size;
* ``smooth noise``: the same two fp32 runs with the mLSTM's normalizer
  max(|q·n|, 1) replaced by the smooth sqrt(1 + (q·n)^2), which has no
  kink, and their rel L2 from each other;
* ``fault``: a bf16 run whose SSD backward returns dx without its w∘(B G)
  term (each 64-row chunk alone), against the fp32 run, and whether twice
  the floor rejects it.

at 8 blocks and at 2 blocks (the segment cut to 1 mLSTM block and its sLSTM
block, ``slstm_period`` 2).  Run with

    PYTHONPATH=src python scripts_xlstm_grad_floor.py [--layers 8 2]

(about a minute and ~6 GB of host memory at 8 blocks).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch

import repro_torch.kernels.ssd.ops as ssd_ops
import repro_torch.models.xlstm as xlstm
from repro_torch.configs import get_config
from repro_torch.data.lm import DataConfig, global_batch_at
from repro_torch.distributed.policy import tree_leaves_with_path
from repro_torch.kernels.common import rel_l2
from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref
from repro_torch.models import init_params, loss_fn
from repro_torch.optim.optimizers import tree_leaves, tree_map


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def smooth_normalized(y_aug, dh: int):
    """y / sqrt(1 + n^2): ``xlstm._normalized`` without its kinks."""
    y, n = y_aug[..., :dh], y_aug[..., dh:]
    return y / torch.sqrt(1 + n * n)


def chunk_local_bwd(c, b, x, log_a, gate, dy, ds_final=None):
    """The plain SSD backward with dx computed on each 64-row chunk alone
    (no state carried in): dx without its w∘(B G) term."""
    real = ssd_chunked_bwd_ref
    out = list(real(c, b, x, log_a, gate, dy, ds_final))
    S = x.shape[2]
    out[2] = torch.cat([real(*[t[:, :, i:i + 64]
                               for t in (c, b, x, log_a, gate)],
                             dy[:, :, i:i + 64])[2]
                        for i in range(0, S, 64)], dim=2)
    return tuple(out)


def grads(params, inputs, cfg):
    params = tree_map(lambda t: t.detach().clone(), params)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = loss_fn(params, inputs, cfg)
    return [g.float() for g in torch.autograd.grad(loss, leaves)]


def probe(layers: int, seq: int, batch: int) -> None:
    base = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(base, n_layers=layers, remat=False,
                              slstm_period=min(layers, base.slstm_period))
    fp32 = dataclasses.replace(cfg, dtype="float32")
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      microbatches=1, seed=1)
    inputs = {k: torch.from_numpy(v[0])
              for k, v in global_batch_at(data, 0).items()}
    p16 = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    p32 = tree_map(lambda t: t.float(), p16)
    names = [path for path, _ in tree_leaves_with_path(p16)]
    gen = torch.Generator().manual_seed(7)
    noisy = dict(p32)
    noisy["mlstm"] = dict(p32["mlstm"])
    w_q = p32["mlstm"]["w_q"]
    noisy["mlstm"]["w_q"] = w_q * (1 + 2.0 ** -9 * torch.randn(
        w_q.shape, generator=gen))

    want = grads(p32, inputs, fp32)
    runs = {"floor": grads(p16, inputs, cfg),
            "noise": grads(noisy, inputs, fp32)}
    with patched(xlstm, "_normalized", smooth_normalized):
        smooth = grads(p32, inputs, fp32)
        smooth_noise = grads(noisy, inputs, fp32)
    with patched(ssd_ops, "ssd_chunked_bwd_ref", chunk_local_bwd):
        runs["fault"] = grads(p16, inputs, cfg)
    segments = layers // cfg.slstm_period
    print(f"{layers} blocks ({segments} segment of "
          f"{cfg.slstm_period - 1} mLSTM + 1 sLSTM), d_model "
          f"{cfg.d_model}, {batch} x {seq} tokens")
    print(f"  {'leaf':16s} {'floor':>9s} {'noise':>9s} "
          f"{'smooth noise':>12s} {'fault':>9s}  fault > 2 x floor")
    for i, name in enumerate(names):
        floor = rel_l2(runs["floor"][i], want[i])
        fault = rel_l2(runs["fault"][i], want[i])
        print(f"  {name:16s} {floor:9.3e} "
              f"{rel_l2(runs['noise'][i], want[i]):9.3e} "
              f"{rel_l2(smooth_noise[i], smooth[i]):12.3e} {fault:9.3e}  "
              f"{fault > 2 * floor}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 2])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    for layers in args.layers:
        probe(layers, args.seq, args.batch)


if __name__ == "__main__":
    main()
