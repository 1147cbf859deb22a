"""Consistent-hash ring over the pipeline-signature space.

The fabric places jobs on shards by hashing each job's *routing key* (a
digest of its pipeline signatures — see ``envelope.routing_key_for``) onto
the same ring the shards live on, and walking clockwise to the first shard.
Two properties make this the right structure for a sharded execution
service:

* **signature locality** — routing is a pure function of the key, so
  identical sub-DAGs submitted by different agents always land on the same
  shard, which keeps cross-agent CSE and the shared intermediate cache
  effective *per shard* (the whole point of the service);
* **minimal movement** — adding or removing a shard only remaps the keys
  that fall into the arcs the shard gained or lost: with ``V`` virtual
  nodes per shard, an expected ``K/N`` of ``K`` keys move when the ``N``-th
  shard joins, and on a shard's departure its keys scatter to the ring
  successors while every other key stays put (the failover path relies on
  this — only the dead shard's work is requeued).

Hashing uses ``blake2b``, not Python's salted ``hash()``, so placement is
deterministic across processes and restarts — a prerequisite for the
process-isolation transport this ring will eventually front.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Iterator, Optional


def _hash64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class ConsistentHashRing:
    """Deterministic consistent-hash ring with virtual nodes.

    Not thread-safe on its own; the :class:`~.router.ShardRouter` serializes
    membership changes and lookups under its lock.
    """

    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: list[int] = []      # sorted vnode positions
        self._owner: dict[int, str] = {}  # position -> node
        self._nodes: set[str] = set()
        for node in nodes:
            self.add(node)

    # -- membership --------------------------------------------------------
    def add(self, node: str) -> None:
        if node in self._nodes:
            raise ValueError(f"node {node!r} already on the ring")
        self._nodes.add(node)
        for i in range(self.vnodes):
            pos = _hash64(f"{node}\x00{i}")
            # astronomically unlikely 64-bit collision; skip rather than
            # silently stealing another node's point
            if pos in self._owner:
                continue
            self._owner[pos] = node
            bisect.insort(self._points, pos)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            raise KeyError(f"node {node!r} not on the ring")
        self._nodes.discard(node)
        self._points = [p for p in self._points if self._owner[p] != node]
        self._owner = {p: n for p, n in self._owner.items() if n != node}

    def nodes(self) -> list[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    # -- lookup ------------------------------------------------------------
    def route(self, key: str) -> str:
        """The node owning ``key``: first vnode clockwise of its position."""
        if not self._points:
            raise LookupError("ring is empty")
        pos = _hash64(key)
        i = bisect.bisect_right(self._points, pos) % len(self._points)
        return self._owner[self._points[i]]

    def successors(self, key: str,
                   exclude: Optional[set] = None) -> Iterator[str]:
        """Distinct nodes in clockwise ring order from ``key``'s position,
        skipping ``exclude`` — the failover order for a job whose shard
        died (first yielded node = where the job goes next)."""
        if not self._points:
            return
        exclude = exclude or set()
        pos = _hash64(key)
        start = bisect.bisect_right(self._points, pos)
        seen: set[str] = set()
        for off in range(len(self._points)):
            p = self._points[(start + off) % len(self._points)]
            node = self._owner[p]
            if node in seen or node in exclude:
                continue
            seen.add(node)
            yield node
