"""Serving steps: prefill (prompt → cache) and decode (one token a step)."""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.model import decode_step as _decode_step
from ..models.model import prefill as _prefill


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, inputs):
        return _prefill(params, inputs, cfg, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, sample: str = "greedy"):
    """Greedy decode step: (next tokens (B, 1) int32, logits, state).  It
    takes the (B, 1) tokens, or for the vlm and audio families a (B, 1, D)
    embedding, passed through to ``decode_step`` unchanged.  ``sample`` is
    accepted and ignored, as the reference ignores it: decoding is greedy."""
    def decode(params, state, token_or_embed):
        logits, state = _decode_step(params, state, token_or_embed, cfg)
        # mask padded vocab columns before sampling
        if cfg.vocab_padded > cfg.vocab:
            logits = logits.masked_fill(
                torch.arange(cfg.vocab_padded,
                             device=logits.device)[None, :] >= cfg.vocab,
                float("-inf"))
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token[:, None], logits, state
    return decode
