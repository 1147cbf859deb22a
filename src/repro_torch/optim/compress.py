"""Gradient compression: blockwise int8 quantization with error feedback
(the counterpart of ``repro.optim.compress``).

Before the data-parallel gradient reduction, gradients are quantized to
int8 with a per-block fp32 scale (256-element blocks over the flattened
leaf), cutting the reduction's bytes 4× against fp32 on the wire.  The
quantization residual is carried in an error-feedback buffer and added back
next step (Karimireddy et al.).

``compressed_all_reduce`` is the explicit-DP reduction over a mesh's axes:
the ranks first agree a per-block scale (an fp32 max), then sum int8
payloads on int32 accumulators, so Σᵢ qᵢ·s == (Σᵢ qᵢ)·s holds exactly.
Rounding is half to even, as ``jnp.round``: the round trip and the error
feedback give the reference's values bit for bit.
"""

from __future__ import annotations

import torch

from ..distributed.collectives import all_reduce
from .optimizers import tree_map

BLOCK = 256


def _blocks(g: torch.Tensor):
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, BLOCK), pad


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)


def _unblock(values: torch.Tensor, pad: int, shape) -> torch.Tensor:
    flat = values.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def int8_compress_decompress(g: torch.Tensor):
    """Round-trip a gradient leaf through int8 (what the wire would carry).
    Returns (g_hat, residual), both fp32."""
    blocks, pad = _blocks(g)
    scale = (blocks.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    g_hat = _unblock(_quantize(blocks, scale).float() * scale, pad, g.shape)
    return g_hat, g.float() - g_hat


def make_error_feedback():
    """Stateful EF transform over gradient trees: (init, apply)."""

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def apply(grads, ef_state):
        """(the compressed gradients in their dtypes, the new residuals)."""
        def leaf(g, e):
            gh, resid = int8_compress_decompress(g.float() + e)
            return gh.to(g.dtype), resid
        pairs = tree_map(leaf, grads, ef_state)
        return _pick(pairs, 0), _pick(pairs, 1)

    return init, apply


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def compressed_all_reduce(g: torch.Tensor, entry, mesh) -> torch.Tensor:
    """Sum ``g`` over the mesh axes of ``entry`` through int8 (the
    counterpart of ``compressed_psum``): a max agrees each block's scale,
    then the int8 payloads are summed on int32.  Returns fp32 of g's
    shape."""
    blocks, pad = _blocks(g)
    local_scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = all_reduce(local_scale, entry, mesh, op="max").clamp_min(1e-12)
    q_sum = all_reduce(_quantize(blocks, scale).to(torch.int32), entry, mesh)
    return _unblock(q_sum.float() * scale, pad, g.shape)
