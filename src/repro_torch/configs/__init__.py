"""repro_torch.configs — a copy of ``repro.configs``: one module per
assigned architecture + registry.

``get_config(name)`` returns the exact published configuration;
``reduced(cfg)`` shrinks it family-preservingly for CPU smoke tests
(the full configs are exercised only via the dry-run's ShapeDtypeStructs).
"""

from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, SHAPES, ShapeConfig, shape_applicable

from .llama3_405b import CONFIG as llama3_405b
from .qwen2_7b import CONFIG as qwen2_7b
from .nemotron_4_340b import CONFIG as nemotron_4_340b
from .starcoder2_15b import CONFIG as starcoder2_15b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .arctic_480b import CONFIG as arctic_480b
from .internvl2_76b import CONFIG as internvl2_76b
from .zamba2_1_2b import CONFIG as zamba2_1_2b
from .xlstm_1_3b import CONFIG as xlstm_1_3b
from .musicgen_medium import CONFIG as musicgen_medium

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [
        llama3_405b, qwen2_7b, nemotron_4_340b, starcoder2_15b,
        granite_moe_3b_a800m, arctic_480b, internvl2_76b, zamba2_1_2b,
        xlstm_1_3b, musicgen_medium,
    ]
}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests."""
    common = dict(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, remat=False, dtype="float32",
    )
    if cfg.family == "moe":
        common.update(n_experts=8, top_k=2, d_ff_expert=64)
    if cfg.family == "hybrid":
        common.update(n_layers=5, attn_every=2, n_kv_heads=4,
                      ssm_state=16, ssm_head_dim=32)
    if cfg.family == "ssm":
        common.update(n_layers=4, slstm_period=2, n_kv_heads=4)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **common)


__all__ = ["REGISTRY", "ARCH_NAMES", "get_config", "reduced", "SHAPES",
           "ShapeConfig", "shape_applicable"]
