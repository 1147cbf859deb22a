"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

38 mamba layers; ONE shared attention+MLP block (same weights) applied after
every 6th mamba layer (6 applications + 2 tail mamba layers)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    act="swiglu", rope_theta=10_000.0,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    attn_every=6,
)
