"""granite-moe-3b-a800m [moe] — 40 experts top-8, 512-wide expert FFNs
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf].

40 experts are padded to 48 so expert parallelism divides the 16-way model
axis (router never selects padding — see ModelConfig.n_experts_padded)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    act="swiglu", rope_theta=10_000.0,
    n_experts=40, top_k=8, d_ff_expert=512,
)
