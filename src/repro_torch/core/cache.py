"""Reuse of intermediates (paper §4.3), shared across tenants.

A hash map from operator signatures (content hash of input hashes + op spec +
seed) to materialized outputs, with

* a fixed memory fraction for in-RAM entries (paper default: 10%),
* LRU eviction to an on-disk spill directory (paper uses Parquet; we use
  pickled host arrays since outputs are arrays/array-trees; a CUDA tensor
  is copied to the host first),
* lazy reload on hit across agent iterations (paper: "the hash map is
  reloaded and intermediates are fetched lazily"),
* speculative cache-candidate marking by the optimizer (expensive
  preprocessing ops), so cheap ops don't pollute the budget,
* **cross-tenant arbitration** — when the cache is shared by a multi-tenant
  service, each entry is *charged* to the tenant whose job materialized it.
  With ``arbitration="quota"`` every tenant gets a soft quota
  (``tenant_quota_fraction × budget``); under RAM pressure the victim is the
  least-recently-used entry of an *over-quota* tenant, and an under-quota
  tenant's entries are evicted only when no over-quota victim exists.  Hits
  on an entry charged to a different tenant are counted as
  ``cross_tenant_hits`` (the work-sharing win the service exists for).

Non-deterministic, unseeded ops are excluded (``LazyOp.cacheable``).

An entry stays where its impl produced it: a CUDA tensor stays in device
memory and counts against the budget with its ``nbytes``.
"""

from __future__ import annotations

import os
import pickle
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from .dag import LazyOp, LazyRef, host_array, toposort


def _nbytes(value: Any) -> int:
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    if isinstance(value, dict):
        return sum(_nbytes(v) for v in value.values())
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    return 64


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    disk_hits: int = 0
    evictions: int = 0
    inserted: int = 0
    bytes_in_ram: int = 0
    # cross-tenant attribution (only populated when callers pass tenant=)
    cross_tenant_hits: int = 0
    hits_by_tenant: dict = field(default_factory=dict)
    evictions_by_tenant: dict = field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class IntermediateCache:
    """Thread-safe signature→outputs cache with RAM budget + disk spill.

    ``arbitration`` selects the RAM-pressure victim policy:

    * ``"lru"`` — global least-recently-used (single-tenant behaviour);
    * ``"quota"`` — per-tenant soft quotas: evict the LRU entry of a tenant
      charged more than ``tenant_quota_fraction × budget_bytes`` first, and
      fall back to global LRU only when nobody is over quota.  Entries with
      no tenant (``tenant=None``) are treated as a tenant of their own.
    """

    def __init__(self, budget_bytes: int, spill_dir: Optional[str] = None,
                 arbitration: str = "lru",
                 tenant_quota_fraction: float = 0.5):
        if arbitration not in ("lru", "quota"):
            raise ValueError(f"unknown arbitration policy {arbitration!r}")
        self.budget_bytes = int(budget_bytes)
        self.spill_dir = spill_dir
        self.arbitration = arbitration
        self.tenant_quota_fraction = float(tenant_quota_fraction)
        self._ram: OrderedDict[str, tuple] = OrderedDict()
        self._sizes: dict[str, int] = {}
        self._owner: dict[str, Optional[str]] = {}   # sig -> charged tenant
        # sig -> first materializer; survives eviction so a disk-hit reload
        # keeps both the quota charge and the cross-tenant hit attribution
        # with the tenant whose job originally produced the value
        self._origin: dict[str, Optional[str]] = {}
        self._tenant_bytes: dict[Optional[str], int] = {}
        self._on_disk: set[str] = set()
        self._lock = threading.Lock()
        self.stats = CacheStats()
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._load_disk_index()

    # -- index persistence across agent iterations / process restarts -------
    def _disk_path(self, sig: str) -> str:
        assert self.spill_dir is not None
        return os.path.join(self.spill_dir, f"{sig}.pkl")

    def _load_disk_index(self) -> None:
        for name in os.listdir(self.spill_dir):
            if name.endswith(".pkl"):
                self._on_disk.add(name[:-4])

    # -- core protocol -------------------------------------------------------
    def _record_hit_locked(self, sig: str, tenant: Optional[str]) -> None:
        self.stats.hits += 1
        if tenant is not None:
            self.stats.hits_by_tenant[tenant] = \
                self.stats.hits_by_tenant.get(tenant, 0) + 1
            origin = self._origin.get(sig)
            if origin is not None and origin != tenant:
                self.stats.cross_tenant_hits += 1

    def get(self, sig: str, tenant: Optional[str] = None) -> Optional[tuple]:
        with self._lock:
            if sig in self._ram:
                self._ram.move_to_end(sig)
                self._record_hit_locked(sig, tenant)
                return self._ram[sig]
        if self.spill_dir and sig in self._on_disk:
            try:
                with open(self._disk_path(sig), "rb") as f:
                    value = pickle.load(f)
            except Exception:
                with self._lock:
                    self._on_disk.discard(sig)
                    self.stats.misses += 1
                return None
            with self._lock:
                self._record_hit_locked(sig, tenant)
                self.stats.disk_hits += 1
            self._insert_ram(sig, value, tenant)
            return value
        with self._lock:
            self.stats.misses += 1
        return None

    def put(self, sig: str, outputs: tuple, spill: bool = True,
            tenant: Optional[str] = None) -> None:
        self._insert_ram(sig, outputs, tenant)
        with self._lock:
            self.stats.inserted += 1
        if spill and self.spill_dir:
            self._spill(sig, outputs)

    # -- charge accounting + victim selection --------------------------------
    def _charge_locked(self, sig: str, tenant: Optional[str],
                       size: int) -> None:
        if sig not in self._origin and tenant is not None:
            self._origin[sig] = tenant     # first materializer, forever
        if sig in self._sizes:
            # entry already in RAM: drop the previous byte charge first
            owner = self._owner.get(sig)
            self._tenant_bytes[owner] = \
                self._tenant_bytes.get(owner, 0) - self._sizes[sig]
            if self._tenant_bytes[owner] <= 0:
                del self._tenant_bytes[owner]
        # the charge stays with the first materializer even when another
        # tenant re-inserts (repeat put) or reloads it from disk — their
        # access was a hit, not a burden
        owner = self._origin.get(sig, tenant)
        self._owner[sig] = owner
        self._tenant_bytes[owner] = self._tenant_bytes.get(owner, 0) + size

    def _uncharge_locked(self, sig: str, size: int) -> Optional[str]:
        owner = self._owner.pop(sig, None)
        self._tenant_bytes[owner] = self._tenant_bytes.get(owner, 0) - size
        if self._tenant_bytes[owner] <= 0:
            del self._tenant_bytes[owner]
        return owner

    def _pick_victim_locked(self) -> str:
        """The signature to evict next under RAM pressure."""
        if self.arbitration == "quota":
            quota = self.tenant_quota_fraction * self.budget_bytes
            over = {t for t, b in self._tenant_bytes.items() if b > quota}
            if over:
                for sig in self._ram:          # LRU → MRU order
                    if self._owner.get(sig) in over:
                        return sig
        return next(iter(self._ram))           # global LRU

    def _insert_ram(self, sig: str, outputs: tuple,
                    tenant: Optional[str] = None) -> None:
        size = _nbytes(outputs)
        if size > self.budget_bytes:
            return  # larger than the whole budget: disk-only
        with self._lock:
            self._ram[sig] = outputs
            self._ram.move_to_end(sig)
            self._charge_locked(sig, tenant, size)
            self._sizes[sig] = size
            self.stats.bytes_in_ram = sum(self._sizes[s] for s in self._ram)
            while self.stats.bytes_in_ram > self.budget_bytes \
                    and len(self._ram) > 1:
                victim = self._pick_victim_locked()
                if victim == sig and len(self._ram) > 1:
                    # never evict the entry being inserted while an
                    # alternative exists (it would thrash immediately)
                    it = iter(self._ram)
                    victim = next(it)
                    if victim == sig:
                        victim = next(it)
                old_val = self._ram.pop(victim)
                vsize = self._sizes.pop(victim)
                self.stats.bytes_in_ram -= vsize
                self.stats.evictions += 1
                owner = self._uncharge_locked(victim, vsize)
                if owner is not None:
                    self.stats.evictions_by_tenant[owner] = \
                        self.stats.evictions_by_tenant.get(owner, 0) + 1
                if self.spill_dir and victim not in self._on_disk:
                    self._spill(victim, old_val)

    def _spill(self, sig: str, outputs: tuple) -> None:
        tmp = self._disk_path(sig) + f".tmp{os.getpid()}"
        try:
            host = tuple(host_array(o) if hasattr(o, "shape") else o
                         for o in outputs)
            with open(tmp, "wb") as f:
                pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self._disk_path(sig))  # atomic
            with self._lock:
                self._on_disk.add(sig)
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)

    # -- warm hand-off (elastic fabric: draining shard → ring successor) -----
    def export_hot_entries(self, max_entries: int = 64
                           ) -> list[tuple[str, bytes]]:
        """The hottest RAM entries as ``(sig, spill_bytes)`` pairs, most
        recently used first.  ``spill_bytes`` is exactly what ``_spill``
        writes to disk (a pickled host-array tuple), so the receiving side
        ingests them with the same code path that reloads a spill file —
        this is the wire form of a draining shard's warm cache hand-off."""
        with self._lock:
            sigs = list(self._ram)[-max_entries:][::-1]   # MRU first
            values = [self._ram[s] for s in sigs]
        out: list[tuple[str, bytes]] = []
        for sig, outputs in zip(sigs, values):
            host = tuple(host_array(o) if hasattr(o, "shape") else o
                         for o in outputs)
            try:
                out.append((sig, pickle.dumps(
                    host, protocol=pickle.HIGHEST_PROTOCOL)))
            except Exception:  # noqa: BLE001 — skip unpicklable payloads
                continue
        return out

    def import_spilled(self, entries) -> int:
        """Ingest ``(sig, spill_bytes)`` pairs produced by
        :meth:`export_hot_entries` (or read from spill files).  Corrupt
        entries are skipped; returns how many were inserted."""
        n = 0
        for sig, blob in entries:
            try:
                outputs = pickle.loads(blob)
            except Exception:  # noqa: BLE001 — corrupt hand-off entry
                continue
            self.put(sig, outputs, spill=False)
            n += 1
        return n

    # -- introspection -------------------------------------------------------
    def tenant_bytes(self) -> dict:
        """Bytes currently charged per tenant (RAM entries only)."""
        with self._lock:
            return dict(self._tenant_bytes)

    def owners(self) -> dict:
        with self._lock:
            return dict(self._owner)

    def arbitration_snapshot(self) -> dict:
        """Cross-tenant arbitration state, copied under the lock (the live
        stats dicts mutate concurrently with evictions — iterating them
        unlocked can raise mid-iteration)."""
        with self._lock:
            return {
                "cross_tenant_hits": self.stats.cross_tenant_hits,
                "bytes_by_tenant": dict(self._tenant_bytes),
                "evictions_by_tenant": dict(self.stats.evictions_by_tenant),
            }

    def clear_ram(self) -> None:
        """Simulate an agent-iteration boundary / process restart."""
        with self._lock:
            self._ram.clear()
            self._sizes.clear()
            self._owner.clear()
            self._origin.clear()   # not persisted: a restart loses it too
            self._tenant_bytes.clear()
            self.stats.bytes_in_ram = 0

    def __contains__(self, sig: str) -> bool:
        with self._lock:
            if sig in self._ram:
                return True
        return bool(self.spill_dir) and sig in self._on_disk


# ---------------------------------------------------------------------------
# speculative cache-candidate marking (paper: "the optimizer speculatively
# marks selected operators (e.g. expensive preprocessing) as cache candidates")
# ---------------------------------------------------------------------------

def mark_cache_candidates(sinks: Sequence[LazyRef],
                          min_cost_s: float = 1e-4,
                          min_consumers: int = 1) -> set[str]:
    """Signatures worth materializing: deterministic-or-seeded ops whose
    estimated recompute cost exceeds ``min_cost_s`` (based on collected
    metadata), preferring ops with fanout (shared across pipelines)."""
    from .dag import consumers as _consumers
    order = toposort(sinks)
    fanout = _consumers(order)
    marked: set[str] = set()
    for op in order:
        if not op.cacheable or op.meta is None:
            continue
        est = op.meta.flops / 2e9 + op.meta.out_bytes / 2e9
        if est >= min_cost_s and len(fanout.get(op.uid, ())) >= min_consumers:
            marked.add(op.signature)
    return marked
