"""starcoder2-15b [dense] — GQA, RoPE, biased projections
[arXiv:2402.19173; hf]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    act="gelu", qkv_bias=True, rope_theta=100_000.0,
)
