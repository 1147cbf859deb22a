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


def make_decode_step(cfg: ModelConfig):
    """Greedy decode step: (next tokens (B, 1) int32, logits, state)."""
    def decode(params, state, tokens):
        logits, state = _decode_step(params, state, tokens, cfg)
        # mask padded vocab columns before sampling
        if cfg.vocab_padded > cfg.vocab:
            logits = logits.masked_fill(
                torch.arange(cfg.vocab_padded,
                             device=logits.device)[None, :] >= cfg.vocab,
                float("-inf"))
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token[:, None], logits, state
    return decode
