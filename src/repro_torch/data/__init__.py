"""repro_torch.data — the step-indexed LM token loader (a copy of
``repro.data.lm``) and the synthetic tabular lake (``tabular``, a copy of
``repro.data.tabular``)."""

from .lm import DataConfig, Prefetcher, global_batch_at, shard_batch_at

__all__ = ["DataConfig", "global_batch_at", "shard_batch_at", "Prefetcher"]
