"""repro_torch.serve — batched serving: prefill/decode steps + request
batcher."""

from .step import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
