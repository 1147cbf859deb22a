"""LM token data pipeline (a copy of ``repro.data.lm``: numpy only, so the
port gives the same tokens bit for bit without importing the JAX package).

Production shape (scaled down for this container): a deterministic,
*step-indexed* sharded loader — batch content is a pure function of
(seed, step, shard), so

* restarts resume mid-epoch with zero duplicated/skipped samples
  (fault-tolerance requirement),
* stragglers/elastic re-meshes never skew data order: a re-assigned shard
  re-derives exactly its slice,
* no coordination state lives outside the checkpointed step counter.

The corpus is synthetic (seeded Zipf over the vocab with Markov structure so
models have something to learn); a real deployment swaps `_tokens_for` with
an indexed tokenized store, keeping the addressing scheme.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    microbatches: int = 1
    seed: int = 0
    pad_id: int = -100


def _rng_for(cfg: DataConfig, step: int, sample: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, sample]))


def _tokens_for(cfg: DataConfig, step: int, sample: int) -> np.ndarray:
    """One (seq_len+1,) document — Zipf unigrams + order-1 Markov bias."""
    rng = _rng_for(cfg, step, sample)
    n = cfg.seq_len + 1
    v = cfg.vocab
    base = rng.zipf(1.3, size=n).astype(np.int64) % v
    # order-1 structure: with p=0.5, t[i] = f(t[i-1]) (learnable pattern)
    follow = (base * 31 + 7) % v
    use = rng.random(n) < 0.5
    toks = np.where(use, np.roll(follow, 1), base)
    return toks


def global_batch_at(cfg: DataConfig, step: int) -> dict:
    """Full (M, mb, S) tokens/labels for ``step`` (single-host path)."""
    M = cfg.microbatches
    mb = cfg.global_batch // M
    toks = np.stack([
        np.stack([_tokens_for(cfg, step, m * mb + b) for b in range(mb)])
        for m in range(M)])                      # (M, mb, S+1)
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32)}


def shard_batch_at(cfg: DataConfig, step: int, shard: int,
                   n_shards: int) -> dict:
    """The slice of ``global_batch_at`` owned by data shard ``shard`` —
    derived independently per host (no scatter from a coordinator)."""
    M = cfg.microbatches
    mb = cfg.global_batch // M
    assert mb % n_shards == 0
    local = mb // n_shards
    toks = np.stack([
        np.stack([_tokens_for(cfg, step, m * mb + shard * local + b)
                  for b in range(local)])
        for m in range(M)])
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32)}


class Prefetcher:
    """Overlaps host-side batch synthesis with device compute (depth-2)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        import queue
        import threading
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = global_batch_at(cfg, step)
                self._q.put((step, batch))
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
