"""Carry parameters across from the JAX package.

``params_from_numpy(jax.tree.map(np.asarray, params), cfg, device)`` turns
the JAX parameter tree (layers stacked on axis 0, weights in the (in, out)
layout) into the port's tree of tensors, in the same layout: nothing is
transposed, so ``x @ w`` means the same in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.common import resolve_device
from .config import ModelConfig
from .model import hybrid_layout, ssm_layout


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: no numpy ↔ torch
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Numpy (or array-like) parameter tree → the same tree of tensors on
    ``device``, dtypes kept.  Checks the layer axes against ``cfg``: L for
    the dense and moe families' ``layers``, and E_padded for the moe
    family's expert axis; (G, per) for the hybrid family's ``groups`` and T
    for its ``tail`` (:func:`hybrid_layout`); (n_seg, period - 1) for the
    ssm family's ``mlstm`` and n_seg for its ``slstm``
    (:func:`ssm_layout`); and an ``embed`` table exactly where
    ``cfg.frontend`` is "none" (the vlm and audio families take precomputed
    embeddings and have none)."""
    device = resolve_device(device)
    if ("embed" in tree) != (cfg.frontend == "none"):
        raise ValueError(f"{cfg.name} (frontend {cfg.frontend!r}) "
                         f"{'has' if cfg.frontend == 'none' else 'has no'} "
                         f"embedding table; the tree "
                         f"{'lacks' if 'embed' not in tree else 'has'} one")
    layers = tree.get("layers")
    if layers is not None:
        n = np.asarray(layers["attn"]["wq"]).shape[0]
        if n != cfg.n_layers:
            raise ValueError(f"tree has {n} stacked layers, {cfg.name} has "
                             f"{cfg.n_layers}")
    if cfg.family == "moe":
        got = np.shape(tree["layers"]["moe"]["w_gate"])[:2]
        if got != (cfg.n_layers, cfg.n_experts_padded):
            raise ValueError(f"tree has (layers, experts) {got}, {cfg.name} "
                             f"has ({cfg.n_layers}, "
                             f"{cfg.n_experts_padded})")
    if cfg.family == "hybrid":
        n_groups, per, tail = hybrid_layout(cfg)
        got = np.shape(tree["groups"]["w_in"])[:2]
        if got != (n_groups, per):
            raise ValueError(f"tree has Mamba groups {got}, {cfg.name} has "
                             f"({n_groups}, {per})")
        got_t = np.shape(tree["tail"]["w_in"])[0] if "tail" in tree else 0
        if got_t != tail:
            raise ValueError(f"tree has {got_t} tail Mamba layers, "
                             f"{cfg.name} has {tail}")

    if cfg.family == "ssm":
        n_seg, per = ssm_layout(cfg)
        got = np.shape(tree["mlstm"]["w_up"])[:2]
        if got != (n_seg, per):
            raise ValueError(f"tree has mLSTM blocks {got} (segments, per "
                             f"segment), {cfg.name} has ({n_seg}, {per})")
        got_s = np.shape(tree["slstm"]["w_x"])[0]
        if got_s != n_seg:
            raise ValueError(f"tree has {got_s} sLSTM blocks, {cfg.name} "
                             f"has {n_seg}")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, device)

    return conv(tree)
