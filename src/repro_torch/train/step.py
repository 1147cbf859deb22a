"""Microbatched, policy-aware training step (the counterpart of
``repro.train.step``).

* gradient accumulation over the leading microbatch dim — one microbatch's
  activations live at a time (with per-layer remat inside the model trunk),
* fp32 gradient accumulators regardless of the parameters' dtype.  The
  trouble spot: ``loss.backward()`` once per microbatch would sum into
  bf16 ``.grad`` tensors.  The JAX package sums ``g.astype(f32)``
  (``repro/train/step.py:78-79``); here each microbatch's gradients come
  from ``torch.autograd.grad``, in each parameter's dtype, and are added
  into explicit fp32 accumulators,
* then divided by the microbatch count and handed to ``optimizer.update``,
  which updates the parameters and its state in place,
* with ``grad_compress``, int8 + error feedback on the gradients before the
  optimizer (``optim/compress.py``).

Under a ``policy`` the step runs on every rank of its mesh, the rank's
parameter shards in, as GSPMD runs the reference's jitted step:

* each rank takes its share of every microbatch over the batch axes
  (``input_pspecs``) and computes its share of the global-batch mean loss:
  its tokens' NLL sum over the global count of valid tokens;
* the loss is ``vocab_parallel_ce`` under TP, else the fused CE on the
  whole LM head;
* the layers gather what they compute whole (FSDP dims, ``gather_on_use``:
  its backward is the reduce-scatter over the batch axes); every other
  gradient is summed over the batch axes its parameter is not sharded on,
  once after the microbatches (per microbatch, into ``grad_pspecs``'
  placement, where given: ZeRO-2), through ``compressed_all_reduce`` with
  ``grad_compress`` (the explicit-DP reduction);
* the optimizer state lies as ``param_pspecs`` places its tree under the
  ZeRO policy (``opt_policy``): AdamW's moments sharded over the batch axes
  like the parameters, Adafactor's factored moments whole on every rank;
  each rank updates its shard of each parameter with the global gradient
  norm (Adafactor's means summed across the shards: ``optim.adafactor``),
  and the shards are gathered back where the parameter's placement
  replicates them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributed.collectives import (all_reduce, axes_of, local_shard,
                                       reshard, shard_shape)
from ..distributed.context import use_context
from ..distributed.policy import (Policy, input_pspecs, opt_policy,
                                  param_pspecs, tree_leaves_with_path,
                                  tree_map_with_path)
from ..distributed.vocab_ce import vocab_parallel_ce
from ..kernels import fused_cross_entropy
from ..models.config import ModelConfig
from ..models.model import forward, lm_head, loss_fn, param_specs
from ..optim.compress import compressed_all_reduce, make_error_feedback
from ..optim.optimizers import Optimizer, Shards, tree_leaves, tree_map


def _loss(params, mb: dict, cfg: ModelConfig, policy: Policy):
    """This rank's share of the microbatch's global mean NLL."""
    hidden, _ = forward(params, mb, cfg)
    labels = mb["labels"]
    valid = labels >= 0
    labels = labels.clamp_min(0)
    D = hidden.shape[-1]
    if policy.tp:
        loss = vocab_parallel_ce(hidden.reshape(-1, D), lm_head(params, cfg),
                                 labels.reshape(-1), valid.reshape(-1),
                                 n_valid=cfg.vocab,
                                 vocab_size=cfg.vocab_padded)
    else:
        loss = fused_cross_entropy(hidden, lm_head(params, cfg, False),
                                   labels, valid=valid, n_valid=cfg.vocab)
    n_local = valid.sum().float()
    n_global = all_reduce(n_local, policy.dp_axes, policy.mesh)
    return loss * n_local / n_global.clamp_min(1.0)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    policy: Optional[Policy] = None,
                    grad_compress: bool = False,
                    grad_pspecs=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` leaves have leading dim M (microbatches); under a
    policy they are the global batch, of which each rank takes its share.
    The parameters and the optimizer state are updated in place and
    returned; ``metrics`` holds 0-d tensors ``loss`` (the global mean) and
    ``grad_norm`` (no host sync without a policy).

    ``grad_pspecs``: with a policy, the spec tree (matching the
    parameters) of the fp32 gradient accumulators; each microbatch's
    gradients are reduced into it (ZeRO-2)."""
    if grad_compress:
        ef_init, ef_apply = make_error_feedback()
    # the parameters' full shapes by path (meta tensors: no allocation)
    full = (dict(tree_leaves_with_path(param_specs(cfg)))
            if policy is not None else None)

    def whole(params):
        """``params``' tree of meta stand-ins at their full shapes."""
        return tree_map_with_path(lambda path, _: full[path], params)

    def reduce_dp(g, spec):
        """Sum ``g`` over the batch axes its parameter is not sharded on."""
        axes = tuple(a for a in policy.mesh.axis_names
                     if a in policy.dp_axes and
                     a not in {x for e in spec for x in axes_of(e)})
        if not axes or policy.mesh.axes_size(axes) == 1:
            return g
        if grad_compress:
            return compressed_all_reduce(g, axes, policy.mesh)
        return all_reduce(g, axes, policy.mesh)

    def specs(params):
        return (param_pspecs(params, policy, cfg),
                param_pspecs(params, opt_policy(policy), cfg))

    def single_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        M = next(iter(batch.values())).shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(M):
            mb = {k: v[i] for k, v in batch.items()}
            loss = loss_fn(params, mb, cfg)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g)                  # fp32 += g in its own dtype
                loss_sum += loss.detach()
            del loss, grads
        with torch.no_grad():
            for a in acc:
                a.div_(M)
        it = iter(acc)
        grads_tree = tree_map(lambda _: next(it), params)
        if grad_compress:
            grads_tree, opt_state["ef"] = ef_apply(grads_tree,
                                                   opt_state["ef"])
            inner = opt_state["opt"]
        else:
            inner = opt_state
        params, _, gnorm = optimizer.update(grads_tree, inner, params)
        metrics = {"loss": loss_sum / M, "grad_norm": gnorm}
        return params, opt_state, metrics

    def sharded_step(params, opt_state, batch):
        mesh = policy.mesh
        pspecs, ospecs = specs(params)
        leaves = tree_leaves(params)
        p_sp, o_sp = tree_leaves(pspecs), tree_leaves(ospecs)
        g_sp = tree_leaves(grad_pspecs) if grad_pspecs is not None else p_sp
        for p in leaves:
            p.requires_grad_(True)
        acc = [torch.zeros(reshard(p.detach(), ps, gs, mesh).shape,
                           dtype=torch.float32, device=p.device)
               for p, ps, gs in zip(leaves, p_sp, g_sp)]
        bspec = input_pspecs(batch, policy, "train")
        local = {k: local_shard(v, bspec[k], mesh) for k, v in batch.items()}
        M = next(iter(local.values())).shape[0]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
        for i in range(M):
            mb = {k: v[i] for k, v in local.items()}
            loss = _loss(params, mb, cfg, policy)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for a, g, ps, gs in zip(acc, grads, p_sp, g_sp):
                    if gs != ps:      # ZeRO-2: reduced into the shard
                        g = reshard(reduce_dp(g.float(), ps), ps, gs, mesh)
                    a.add_(g)
                loss_sum += loss.detach()
            del loss, grads
        with torch.no_grad():
            g_opt = []
            for a, ps, gs, os_ in zip(acc, p_sp, g_sp, o_sp):
                a.div_(M)
                if gs == ps:
                    a = reduce_dp(a, ps)
                g_opt.append(reshard(a, gs, os_, mesh))
            it = iter(g_opt)
            grads_tree = tree_map(lambda _: next(it), params)
            if grad_compress:
                grads_tree, opt_state["ef"] = ef_apply(grads_tree,
                                                       opt_state["ef"])
                inner = opt_state["opt"]
            else:
                inner = opt_state
            # the global norm: each element once, however many ranks hold it
            sq = sum(torch.sum(torch.square(g.float())) *
                     (mesh.axes_size(tuple(x for e in os_ for x in axes_of(e)))
                      / mesh.size)
                     for g, os_ in zip(tree_leaves(grads_tree), o_sp))
            norm = torch.sqrt(all_reduce(sq, mesh.axis_names, mesh))
            views = [reshard(p, ps, os_, mesh)
                     for p, ps, os_ in zip(leaves, p_sp, o_sp)]
            it = iter(views)
            optimizer.update(grads_tree, inner,
                             tree_map(lambda _: next(it), params), norm=norm,
                             shards=Shards(mesh, o_sp, [
                                 tuple(t.shape) for t in
                                 tree_leaves(whole(params))]))
            for p, v, ps, os_ in zip(leaves, views, p_sp, o_sp):
                if ps != os_:        # the updated shards, where p holds more
                    p.copy_(reshard(v, os_, ps, mesh))
            loss = all_reduce(loss_sum, policy.dp_axes, mesh) / M
        return params, opt_state, {"loss": loss, "grad_norm": norm}

    def train_step(params, opt_state, batch):
        if policy is None:
            return single_step(params, opt_state, batch)
        with use_context(policy.context()):
            return sharded_step(params, opt_state, batch)

    def init_opt_state(params):
        """The optimizer's state (and the error-feedback residuals) for
        ``params``; under a policy, this rank's part of it: each leaf of
        the state tree under its spec from ``param_pspecs`` at the ZeRO
        policy (every state of both optimizers starts at zero)."""
        if policy is None:
            inner = optimizer.init(params)
        else:
            struct = optimizer.init(whole(params))    # meta: shapes only
            sspecs = param_pspecs(struct, opt_policy(policy), cfg)
            device = tree_leaves(params)[0].device
            inner = tree_map(
                lambda t, spec: torch.zeros(
                    shard_shape(t.shape, spec, policy.mesh), dtype=t.dtype,
                    device=device), struct, sspecs)
            pspecs, ospecs = specs(params)
            views = [reshard(p.detach(), ps, os_, policy.mesh)
                     for p, ps, os_ in zip(tree_leaves(params),
                                           tree_leaves(pspecs),
                                           tree_leaves(ospecs))]
            it = iter(views)
            params = tree_map(lambda _: next(it), params)
        if grad_compress:
            return {"opt": inner, "ef": ef_init(params)}
        return inner

    train_step.init_opt_state = init_opt_state
    return train_step
