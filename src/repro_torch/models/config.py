"""Model configuration covering all assigned architecture families (a copy
of ``repro.models.config``)."""

from __future__ import annotations

from dataclasses import dataclass


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    act: str = "swiglu"            # swiglu | gelu | relu2
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN alongside MoE

    # SSM / hybrid / xLSTM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0            # zamba2: shared attn block every k layers
    slstm_period: int = 0          # xlstm: 1 sLSTM per this many blocks

    # modality frontend (STUB per assignment: precomputed embeddings)
    frontend: str = "none"         # none | patch_embed | audio_tokens

    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save dot outputs)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """LM head padded to an MXU-friendly multiple of 128 (and hence
        evenly shardable over 16-way TP); logits beyond ``vocab`` are masked
        at the loss."""
        return pad_to(self.vocab, 128)

    @property
    def n_experts_padded(self) -> int:
        """Experts padded so EP over a 16-way axis divides evenly (granite's
        40 → 48; router never selects the padding)."""
        if self.n_experts == 0:
            return 0
        return pad_to(self.n_experts, 16)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def uses_attention(self) -> bool:
        return self.family in ("dense", "moe", "vlm", "audio") or \
            (self.family == "hybrid" and self.attn_every > 0)

    @property
    def pure_full_attention(self) -> bool:
        """True → long_500k is skipped (see DESIGN.md §4)."""
        return self.family in ("dense", "moe", "vlm", "audio")

    def params_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        D, V = self.d_model, self.vocab
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.frontend != "none":
            emb = V * D  # lm head only; frontend embeddings are stubbed
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            dh = self.d_head
            attn = D * (self.n_heads * dh) * 2 \
                + D * (self.n_kv_heads * dh) * 2
            if self.family == "moe":
                ff = self.n_experts * 3 * D * self.d_ff_expert
                if self.moe_dense_residual:
                    ff += 3 * D * self.d_ff
                ff += D * self.n_experts  # router
            else:
                mults = 3 if self.act == "swiglu" else 2
                ff = mults * D * self.d_ff
            per_layer = attn + ff + 2 * D
            total = emb + self.n_layers * per_layer + D
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            mamba = D * (2 * di + 2 * N + H) + di * D + self.conv_kernel * di \
                + 2 * H + 2 * D
            dh = self.d_head
            shared_attn = D * (self.n_heads * dh) * 2 \
                + D * (self.n_kv_heads * dh) * 2 + 3 * D * self.d_ff + 2 * D
            total = emb + self.n_layers * mamba + shared_attn + D
        else:  # ssm (xlstm)
            mlstm = D * 2 * D + 3 * D * D + D * D + 2 * D
            slstm = 4 * D * D + 4 * self.n_heads * self.d_head ** 2 \
                + 4 * D + 2 * D
            period = max(self.slstm_period, 1)
            n_s = self.n_layers // period if self.slstm_period else 0
            total = emb + (self.n_layers - n_s) * mlstm + n_s * slstm + D
        return int(total)

    def active_params_count(self) -> int:
        """MoE: only top_k experts are active per token."""
        if self.family != "moe":
            return self.params_count()
        D = self.d_model
        inactive = (self.n_experts - self.top_k) * 3 * D * self.d_ff_expert
        return int(self.params_count() - self.n_layers * inactive)


# ---------------------------------------------------------------------------
# input shapes assigned to the LM family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the 40-cell matrix with documented skips."""
    if shape == "long_500k" and cfg.pure_full_attention:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (DESIGN.md §4)")
    return True, ""
