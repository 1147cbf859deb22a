"""internvl2-76b [vlm] — InternViT + InternLM2 backbone
[arXiv:2404.16821; unverified].

Backbone only (assignment): the ViT frontend is a STUB; input_specs()
provides precomputed patch embeddings (B, S, d_model)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    act="swiglu", rope_theta=1_000_000.0,
    frontend="patch_embed",
)
