"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

Backbone only (assignment): the EnCodec frontend is a STUB; input_specs()
provides precomputed frame embeddings.  RoPE replaces the reference's
sinusoidal embeddings (positional scheme deviation, DESIGN.md §8)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    act="gelu", rope_theta=10_000.0,
    frontend="audio_tokens",
)
