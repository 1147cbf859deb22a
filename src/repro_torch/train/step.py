"""Microbatched training step (the counterpart of ``repro.train.step``).

* gradient accumulation over the leading microbatch dim — one microbatch's
  activations live at a time (with per-layer remat inside the model trunk);
  the loss is ``models.model.loss_fn`` (JAX's ``_loss`` differs from it only
  by the tensor-parallel branch, which waits for the distributed slice),
* fp32 gradient accumulators regardless of the parameters' dtype.  The
  trouble spot: ``loss.backward()`` once per microbatch would sum into
  bf16 ``.grad`` tensors.  The JAX package sums ``g.astype(f32)``
  (``repro/train/step.py:78-79``); here each microbatch's gradients come
  from ``torch.autograd.grad``, in each parameter's dtype, and are added
  into explicit fp32 accumulators,
* then divided by the microbatch count and handed to ``optimizer.update``,
  which updates the parameters and its state in place.

Tensor/ZeRO sharding (``policy``, ``grad_pspecs``) and int8 gradient
compression (``grad_compress``) come with the distributed slice of the port
(ROADMAP.md) and raise here.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.model import loss_fn
from ..optim.optimizers import Optimizer, tree_leaves, tree_map

_LATER = "the distributed slice of the port (see ROADMAP.md)"


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, policy=None,
                    grad_compress: bool = False, grad_pspecs=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` leaves have leading dim M (microbatches).  The
    parameters and the optimizer state are updated in place and returned;
    ``metrics`` holds 0-d tensors ``loss`` and ``grad_norm`` (no host
    sync)."""
    if policy is not None or grad_pspecs is not None:
        raise NotImplementedError(
            f"tensor/ZeRO sharding of the train step comes with {_LATER}")
    if grad_compress:
        raise NotImplementedError(
            f"int8 gradient compression comes with {_LATER}")

    def train_step(params, opt_state, batch):
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
        params, opt_state, gnorm = optimizer.update(grads_tree, opt_state,
                                                    params)
        metrics = {"loss": loss_sum / M, "grad_norm": gnorm}
        return params, opt_state, metrics

    def init_opt_state(params):
        return optimizer.init(params)

    train_step.init_opt_state = init_opt_state
    return train_step
