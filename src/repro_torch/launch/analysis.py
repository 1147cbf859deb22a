"""Per-device cost of one step and its roofline (the counterpart of
``repro.launch.analysis``).

The reference reads FLOPs, bytes and collectives from a compiled
artifact's optimized HLO.  The port has no HLO: ``hlo_cost.analyze`` counts
the aten ops of one call on fake tensors, and the collectives through
``distributed.collectives``' counters.  :func:`roofline_from_count` forms
the roofline from that count, as ``roofline_from_compiled`` does from an
artifact.

The memory term is analytic (:func:`analytic_memory_bytes`, the
reference's arithmetic over config × shape × policy): the HBM traffic of a
fused backend, which neither the reference's CPU HLO nor the port's eager
op count can show.  The op count's bytes are recorded beside it as a
bracket.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM5 80GB datasheet peaks (dense), not measurements: bf16
# tensor cores and HBM3, the figures chip_smoke.py states its kernels'
# bounds against.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
# The collective term's per-GPU link: one 400 Gb/s NDR InfiniBand port a
# GPU (the DGX H100 layout, 8 ConnectX-7 ports a node), because every 16-wide
# mesh axis spans two 8-GPU nodes.  Within a node NVLink 4 gives 450 GB/s a
# direction (900 GB/s bidirectional), which only 8-wide groups could use.
LINK_BW = 50e9                    # B/s per GPU


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


# ---------------------------------------------------------------------------
# analytic per-device HBM traffic model (the reference's, unchanged)
# ---------------------------------------------------------------------------

def analytic_memory_bytes(cfg, shape, pol) -> float:
    """Per-device HBM bytes for one step under a fused backend."""
    mesh_shape = dict(pol.mesh.shape)
    tp = mesh_shape["model"] if pol.tp else 1
    dp = 1
    for a in pol.dp_axes:
        dp *= mesh_shape[a]
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v

    P_bytes = 2.0 * cfg.params_count()            # bf16 weights, global
    dh = cfg.d_head
    D = cfg.d_model

    if shape.kind == "train":
        tokens_dev = shape.seq_len * shape.global_batch / dp
        sp = mesh_shape["model"] if pol.sp else 1
        act_tok = tokens_dev / sp                  # residual-stream tokens
        # weights: fwd + remat recompute + bwd grads-wrt-weights read;
        # each device reads its TP shard per use (replicated across dp)
        w_traffic = 3.0 * P_bytes / tp
        # optimizer: read+write fp32 state + grads + params (ZeRO-sharded)
        opt_traffic = (12.0 if cfg.params_count() < 100e9 else 6.0) \
            * cfg.params_count() / n_chips
        # activations: residual stream r/w per block boundary (~8 accesses),
        # plus attention/ssd Q,K,V,O streams (×3 for fwd/recompute/bwd)
        act_traffic = 8.0 * cfg.n_layers * act_tok * D * 2.0
        if cfg.uses_attention:
            hkv = cfg.n_kv_heads
            qkvo = (2 * cfg.n_heads + 2 * hkv) * dh
            act_traffic += 3.0 * cfg.n_layers * (tokens_dev / sp) * qkvo * 2.0
        # lm head / CE: logits never materialized (fused CE) — read hidden +
        # head shard, write per-token scalars
        ce = 2.0 * tokens_dev * D * 2.0 + 2.0 * D * cfg.vocab_padded / tp * 2.0
        return w_traffic + opt_traffic + act_traffic + ce

    if shape.kind == "prefill":
        tokens_dev = shape.seq_len * shape.global_batch / dp
        w_traffic = P_bytes / tp
        act_traffic = 6.0 * cfg.n_layers * tokens_dev * D * 2.0
        # cache write (seq-sharded over model)
        n_kv_layers = (cfg.n_layers if cfg.family in
                       ("dense", "moe", "vlm", "audio")
                       else cfg.n_layers // max(cfg.attn_every, 1)
                       if cfg.family == "hybrid" else 0)
        cache = (2.0 * n_kv_layers * tokens_dev / mesh_shape["model"]
                 * cfg.n_kv_heads * dh * 2.0)
        return w_traffic + act_traffic + cache

    # decode: weights once + KV cache read (both sharded) dominate
    batch_dev = max(1.0, shape.global_batch / dp)
    if cfg.family == "moe":
        # only active experts' weights stream per token batch
        w_traffic = 2.0 * cfg.active_params_count() / tp
    else:
        w_traffic = P_bytes / tp
    n_kv_layers = (cfg.n_layers if cfg.family in
                   ("dense", "moe", "vlm", "audio")
                   else cfg.n_layers // max(cfg.attn_every, 1)
                   if cfg.family == "hybrid" else 0)
    cache = (2.0 * n_kv_layers * batch_dev
             * shape.seq_len / mesh_shape["model"]
             * cfg.n_kv_heads * dh * 2.0)
    # recurrent states (ssm/hybrid/xlstm): read+write whole state
    state = 0.0
    if cfg.family in ("hybrid", "ssm"):
        if cfg.family == "hybrid":
            state = (2.0 * cfg.n_layers * batch_dev * cfg.ssm_heads
                     * cfg.ssm_state * cfg.ssm_head_dim * 4.0)
        else:
            dh_m = D // cfg.n_heads
            state = (2.0 * cfg.n_layers * batch_dev * cfg.n_heads
                     * dh_m * (dh_m + 1) * 4.0)
    act = 12.0 * cfg.n_layers * batch_dev * D * 2.0
    return w_traffic + cache + state + act


@dataclass
class Roofline:
    """The three per-device terms of one step on an H100 SXM5 80GB, from
    its datasheet peaks (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``LINK_BW``): a
    bound, not a measurement.  ``flops``, ``bytes_accessed`` and
    ``collective_bytes`` are per device (rank 0's count); ``n_chips`` gives
    the global FLOPs."""

    flops: float                   # per-device
    bytes_accessed: float          # per-device
    collective_bytes: float        # per-device
    n_chips: int

    @property
    def global_flops(self) -> float:
        return self.flops * self.n_chips

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_from_count(count, n_chips: int) -> tuple:
    """(Roofline, CollectiveStats) from an ``hlo_cost.analyze`` count.  The
    collective bytes are what the port sends: its all-reduces upcast
    floats to fp32 (``collectives.all_reduce``), where the reference's
    ``collective_bytes_bf16eq`` halves fp32 traffic to bf16."""
    colls = CollectiveStats(
        bytes_by_kind=dict(count.collective_by_kind),
        count_by_kind=dict(count.collective_count_by_kind))
    return (Roofline(flops=count.flops, bytes_accessed=count.bytes,
                     collective_bytes=colls.total_bytes, n_chips=n_chips),
            colls)
