"""Meta-tensor stand-ins for every model input (the counterpart of
``repro.launch.specs``, whose ShapeDtypeStructs these are): shapes and
dtypes, no allocation.
"""

from __future__ import annotations

import torch

from ..configs import get_config
from ..models import init_decode_state
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..models.model import param_specs

I32 = torch.int32
BF16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                      microbatches: int) -> dict:
    """Microbatched layout (M, B/M, S): the data pipeline emits
    microbatches directly, so accumulation never reshapes the batch dim."""
    M = microbatches
    B = shape.global_batch
    if B % M:
        raise ValueError(f"global batch {B} does not split into {M} "
                         f"microbatches")
    mb = B // M
    S = shape.seq_len
    specs = {"labels": _meta((M, mb, S), I32)}
    if cfg.frontend == "none":
        specs["tokens"] = _meta((M, mb, S), I32)
    else:
        specs["embeds"] = _meta((M, mb, S, cfg.d_model), BF16)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "none":
        return {"tokens": _meta((B, S), I32)}
    return {"embeds": _meta((B, S, cfg.d_model), BF16)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(token_or_embed spec, decode-state spec tree) for one decode step
    with a cache of length shape.seq_len."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "none":
        tok = _meta((B, 1), I32)
    else:
        tok = _meta((B, 1, cfg.d_model), BF16)
    return tok, init_decode_state(cfg, B, S, device="meta")


def model_param_specs(cfg: ModelConfig):
    return param_specs(cfg)


def input_specs(arch: str, shape_name: str, microbatches: int = 1):
    """Meta stand-ins for every model input of (arch × shape)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape, microbatches)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    tok, state = decode_input_specs(cfg, shape)
    return {"token": tok, "state": state}
