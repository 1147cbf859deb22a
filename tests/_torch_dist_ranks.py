"""The port's side of ``tests/test_torch_distributed.py``: what each of 8
gloo ranks on the CPU computes, on a (2, 4) mesh over ("data", "model"),
from the inputs and weights the JAX side wrote.  Spawned ranks import this
module by name (it is on their ``sys.path`` through the parent's); it
imports torch and the port only, and each rank reports whether jax or
repro got loaded anyway.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

DEC_STEPS = 3


def tree_from(npz, prefix: str) -> dict:
    """The nested dict of the arrays stored under ``prefix/<a>/<b>...``."""
    tree: dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return tree


def configs():
    """The reduced configs of tests/test_distributed.py, and qwen2's with
    4 kv heads, whose attention splits over 4 model ranks by heads."""
    from repro_torch.configs import get_config, reduced
    q = dataclasses.replace(reduced(get_config("qwen2-7b")), d_model=128,
                            n_heads=4, n_kv_heads=2, vocab=512,
                            dtype="float32")
    return {
        "q2": q,
        "q4": dataclasses.replace(q, n_kv_heads=4),
        "g": dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")),
                                 d_model=64, n_heads=4, n_kv_heads=2,
                                 n_experts=8, top_k=2, d_ff_expert=32,
                                 dtype="float32"),
        "g128": reduced(get_config("granite-moe-3b-a800m")),
    }


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def run(rank, world, device, inputs: str, ckpt_dir: str):
    """Every check's port side; rank 0 returns the numbers, the others
    whether they loaded jax or repro."""
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.collectives import gather_full, local_shard
    from repro_torch.distributed.context import ShardingContext, use_context
    from repro_torch.distributed.policy import (make_policy, opt_policy,
                                                param_pspecs, shard_tree,
                                                tree_leaves_with_path,
                                                tree_shardings)
    from repro_torch.distributed.vocab_ce import vocab_parallel_ce
    from repro_torch.models import params_from_numpy
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import decode_step, param_specs, prefill
    from repro_torch.models.moe import moe_ffn
    from repro_torch.optim import adamw, compressed_all_reduce
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.step import make_train_step

    npz = np.load(inputs)
    cfgs = configs()
    mesh = Mesh.over_world((2, 4), ("data", "model"), device)
    out: dict = {}

    # -- the collectives' counters: one call of each kind ----------------
    from repro_torch.distributed import collectives
    collectives.reset_collective_bytes()
    seen = []
    for call in (lambda: collectives.all_reduce(torch.ones(4), "model",
                                                mesh),
                 lambda: collectives.all_gather_dim(torch.ones(4), 0,
                                                    "model", mesh, 16),
                 lambda: collectives.reduce_scatter_dim(torch.ones(16), 0,
                                                        "model", mesh, 4)):
        call()
        seen.append((dict(collectives.COLLECTIVE_COUNTS),
                     dict(collectives.COLLECTIVE_BYTES)))
    collectives.reset_collective_bytes()
    seen.append((dict(collectives.COLLECTIVE_COUNTS),
                 dict(collectives.COLLECTIVE_BYTES)))
    out["counters"] = seen

    # -- vocab-parallel CE: loss and dx ----------------------------------
    x = _t(npz["vce/x"]).requires_grad_(True)
    w = _t(npz["vce/w"])
    lab = _t(npz["vce/lab"])
    val = torch.ones(lab.shape, dtype=torch.bool)
    w_loc = local_shard(w, (None, "model"), mesh)
    with use_context(ShardingContext(mesh=mesh, rules={})):
        loss = vocab_parallel_ce(x, w_loc, lab, val, n_valid=500)
        (dx,) = torch.autograd.grad(loss, x)
    out["vce/loss"] = float(loss)
    out["vce/dx"] = dx.numpy()

    # -- MoE: EP, and DP without EP --------------------------------------
    cfg = cfgs["g"]
    lp = {k: _t(v) for k, v in tree_from(npz, "moe/p").items()}
    xm = _t(npz["moe/x"])
    with torch.no_grad():
        ep_lp = dict(lp)
        for k in ("w_gate", "w_up", "w_down"):
            ep_lp[k] = local_shard(lp[k], ("model", None, None), mesh)
        with use_context(ShardingContext(mesh=mesh, rules={},
                                         ep_axis="model")):
            out["moe/y_ep"] = moe_ffn(ep_lp, xm, cfg).numpy()
        with use_context(ShardingContext(mesh=mesh, rules={},
                                         dp_axes=("data",))):
            out["moe/y_dp"] = moe_ffn(lp, xm, cfg).numpy()

    # -- shards of uneven size round-trip --------------------------------
    odd = torch.arange(49155 * 2, dtype=torch.float32).reshape(49155, 2)
    out["uneven"] = all(
        torch.equal(gather_full(local_shard(odd, spec, mesh), spec, mesh,
                                full_shape=odd.shape), odd)
        for spec in (("model", None), (("data", "model"), None),
                     ("data", None)))

    # -- the compressed reduction ----------------------------------------
    g = _t(npz["cmp/g"])[rank]
    out["cmp/row"] = (compressed_all_reduce(g, ("data", "model"), mesh)
                      / 8).numpy()

    # -- sequence-sharded decode through prefill and decode_step ---------
    for name in ("q2", "q4", "g128"):
        cfg = cfgs[name]
        full = params_from_numpy(tree_from(npz, f"params/{name}"), cfg,
                                 device="cpu")
        toks = _t(npz[f"dec/{name}/toks"])
        B, S, MAX = toks.shape[0], int(npz["dec/S"]), int(npz["dec/MAX"])
        pol = make_policy(cfg, ShapeConfig("dec", MAX, B, "decode"), mesh,
                          tp=True)
        local = shard_tree(full, param_pspecs(param_specs(cfg), pol, cfg),
                           mesh)
        tl = local_shard(toks, (pol.batch_dp, None), mesh)
        got = []
        with torch.no_grad(), use_context(pol.context()):
            logits, st = prefill(local, {"tokens": tl[:, :S]}, cfg, MAX)
            got.append(logits)
            for i in range(DEC_STEPS):
                logits, st = decode_step(local, st, tl[:, S + i:S + i + 1],
                                         cfg)
                got.append(logits)
        for i, lg in enumerate(got):
            out[f"dec/{name}/logits{i}"] = gather_full(
                lg, (pol.batch_dp, None), mesh).numpy()
    # the reference test's own case: prompt 12 of a 16 cache, one step
    cfg = cfgs["q2"]
    full = params_from_numpy(tree_from(npz, "params/q2"), cfg, device="cpu")
    toks = _t(npz["dec12/toks"])
    pol = make_policy(cfg, ShapeConfig("dec", 16, 8, "decode"), mesh, tp=True)
    local = shard_tree(full, param_pspecs(param_specs(cfg), pol, cfg), mesh)
    tl = local_shard(toks, (pol.batch_dp, None), mesh)
    with torch.no_grad(), use_context(pol.context()):
        _, st = prefill(local, {"tokens": tl[:, :12]}, cfg, 16)
        logits, _ = decode_step(local, st, tl[:, 12:13], cfg)
    out["dec12/logits"] = gather_full(logits, (pol.batch_dp, None),
                                      mesh).numpy()

    # -- the sharded train step (tp, fsdp, 2 microbatches) ---------------
    cfg = cfgs["q2"]
    batch = {"tokens": _t(npz["tr/tokens"]), "labels": _t(npz["tr/labels"])}
    pol = make_policy(cfg, ShapeConfig("t", 64, 8, "train"), mesh, tp=True,
                      fsdp=True, microbatches=2)
    pspecs = param_pspecs(param_specs(cfg), pol, cfg)
    # tr2: tp alone, the gradients reduced into the ZeRO shards each
    # microbatch (grad_pspecs = the optimizer state's placement)
    pol2 = make_policy(cfg, ShapeConfig("t", 64, 8, "train"), mesh, tp=True,
                       fsdp=False, microbatches=2)
    for tag, compress, p_ in (("tr", False, pol), ("trc", True, pol),
                              ("tr2", False, pol2)):
        full = params_from_numpy(tree_from(npz, "params/q2"), cfg,
                                 device="cpu")
        pspecs = param_pspecs(param_specs(cfg), p_, cfg)
        params = shard_tree(full, pspecs, mesh)
        gspecs = (param_pspecs(params, opt_policy(p_), cfg)
                  if tag == "tr2" else None)
        step = make_train_step(cfg, adamw(lr=1e-3), policy=p_,
                               grad_compress=compress, grad_pspecs=gspecs)
        opt = step.init_opt_state(params)
        params, opt, m = step(params, opt, batch)
        out[f"{tag}/loss"] = float(m["loss"])
        out[f"{tag}/gnorm"] = float(m["grad_norm"])
        specs = dict(tree_leaves_with_path(pspecs))
        after = {p: gather_full(t.detach(), specs[p], mesh).numpy()
                 for p, t in tree_leaves_with_path(params)}
        out[f"{tag}/after"] = after

    # -- Adafactor under ZeRO (tp, fsdp, 2 microbatches), 2 steps --------
    from repro_torch.optim import adafactor
    pspecs = param_pspecs(param_specs(cfg), pol, cfg)
    params = shard_tree(params_from_numpy(tree_from(npz, "params/q2"), cfg,
                                          device="cpu"), pspecs, mesh)
    step = make_train_step(cfg, adafactor(lr=1e-3), policy=pol)
    opt = step.init_opt_state(params)
    losses, norms = [], []
    for _ in range(2):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["ada/loss"], out["ada/gnorm"] = losses, norms
    specs = dict(tree_leaves_with_path(pspecs))
    out["ada/after"] = {p: gather_full(t.detach(), specs[p], mesh).numpy()
                        for p, t in tree_leaves_with_path(params)}
    out["ada/state"] = {p: t.numpy()
                        for p, t in tree_leaves_with_path(opt["s"])}

    # -- checkpoint on (2, 4), restore on (1, 4): an elastic restart -----
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    pspecs = param_pspecs(param_specs(cfg), pol, cfg)
    full = params_from_numpy(tree_from(npz, "params/q2"), cfg, device="cpu")
    params = shard_tree(full, pspecs, mesh)
    save_checkpoint(ckpt_dir, 1, params,
                    shardings=tree_shardings(pspecs, pol)).wait()
    small = Mesh.over_world((1, 4), ("data", "model"), device,
                            ranks=range(4))
    if small is not None:
        pol4 = make_policy(cfg, ShapeConfig("t", 32, 8, "train"), small,
                           tp=True, fsdp=True)
        specs4 = param_pspecs(param_specs(cfg), pol4, cfg)
        tree, _ = load_checkpoint(ckpt_dir, 1, param_specs(cfg),
                                  shardings=tree_shardings(specs4, pol4))
        specs = dict(tree_leaves_with_path(specs4))
        restored = {p: gather_full(t, specs[p], small).numpy()
                    for p, t in tree_leaves_with_path(tree)}
        out["el/restored"] = restored
        # ZeRO: the optimizer state's placement shards every leaf over data
        out["el/opt_specs_fsdp"] = all(
            s == s2 for s, s2 in zip(
                tree_leaves(param_pspecs(param_specs(cfg),
                                         opt_policy(pol4), cfg)),
                tree_leaves(specs4)))

    # -- build_trainer on the mesh: a TrainLoop preempted and resumed -----
    from repro_torch.launch.train import build_trainer
    from repro_torch.train import PreemptionError
    kw = dict(seq_len=32, global_batch=8, microbatches=2, total_steps=4,
              ckpt_every=2, device="cpu")
    out["loop/sharded"] = build_trainer(
        "qwen2-7b", mesh=mesh, ckpt_dir=os.path.join(ckpt_dir, "whole"),
        **kw).run().losses
    first = build_trainer("qwen2-7b", mesh=mesh, inject_preemption_at=2,
                          ckpt_dir=os.path.join(ckpt_dir, "cut"), **kw)
    try:
        first.run()
    except PreemptionError:
        pass
    resumed = build_trainer("qwen2-7b", mesh=mesh,
                            ckpt_dir=os.path.join(ckpt_dir, "cut"), **kw)
    out["loop/resumed"] = first.state.losses + resumed.run().losses
    out["loop/resumed_from"] = resumed.state.resumed_from
    if rank == 0:
        out["loop/single"] = build_trainer(
            "qwen2-7b", ckpt_dir=os.path.join(ckpt_dir, "single"),
            **kw).run().losses
    out["loaded"] = sorted(m for m in ("jax", "repro") if m in sys.modules)
    return out if rank == 0 else {"loaded": out["loaded"]}


def mesh_size_mismatch(rank, world, device):
    """A mesh whose size is not the world's raises on every rank."""
    from repro_torch.distributed import Mesh
    try:
        Mesh.over_world((2, 2), ("data", "model"), device)
    except ValueError as e:
        return str(e)
    return None


def scratch_dir() -> str:
    return tempfile.mkdtemp(prefix="repro_torch_dist_",
                            dir=os.environ.get("TMPDIR"))
