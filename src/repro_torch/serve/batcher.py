"""Continuous-batching request scheduler for serving (a copy of
``repro.serve.batcher``; numpy only).

Slot-based continuous batching (vLLM-style, TPU-static shapes): a fixed
number of batch lanes; finished sequences free their lane, waiting requests
are prefilled into free lanes while decode continues for the rest.  All
shapes are static (lane count, max_len) so one compiled decode step serves
the whole lifetime — the TPU-idiomatic version of dynamic batching.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    generated: list = field(default_factory=list)
    done: bool = False


class Batcher:
    def __init__(self, n_lanes: int, max_len: int, eos_id: int = -1):
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: collections.deque = collections.deque()
        self.lanes: list[Optional[Request]] = [None] * n_lanes
        self.finished: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def admit(self) -> list[tuple[int, Request]]:
        """Fill free lanes from the queue; returns (lane, request) pairs
        needing prefill."""
        new = []
        for i in range(self.n_lanes):
            if self.lanes[i] is None and self.queue:
                req = self.queue.popleft()
                self.lanes[i] = req
                new.append((i, req))
        return new

    def active_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self.lanes) if r is not None]

    def record_tokens(self, tokens: np.ndarray) -> None:
        """tokens: (n_lanes,) next token per lane; retires finished lanes."""
        for i, r in enumerate(self.lanes):
            if r is None:
                continue
            t = int(tokens[i])
            r.generated.append(t)
            if (len(r.generated) >= r.max_new_tokens
                    or (self.eos_id >= 0 and t == self.eos_id)):
                r.done = True
                self.finished.append(r)
                self.lanes[i] = None

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.lanes)
