"""xlstm-1.3b [ssm] — alternating mLSTM/sLSTM blocks
[arXiv:2405.04517; unverified].

48 blocks in 6 segments of (7 mLSTM + 1 sLSTM); d_ff=0 per the assignment —
xLSTM blocks carry their own up/down projections, no standalone MLP."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_period=8,
)
