"""Sharding policy (the counterpart of ``repro.distributed.policy``): maps
(ModelConfig, ShapeConfig, Mesh) to parameter specs, activation rules and
runtime knobs, by the reference's rules and constants.

* TP: matmul dims sharded over ``model`` when d_model ≥ TP_MIN_DMODEL;
* FSDP: parameters *additionally* sharded over ``data`` when the model has
  ≥ FSDP_MIN_PARAMS parameters;
* EP: MoE experts sharded over ``model`` (off under ``dp_over_model``);
* SP: recorded for training shapes (the port keeps the residual stream
  replicated over ``model`` in compute: ROADMAP.md A3);
* KV cache: batch over ``data``, sequence over ``model``;
* microbatching: the reference's gradient-accumulation counts.

A spec is a :class:`PartitionSpec`, a tuple with one entry per tensor dim:
None, a mesh axis name, or a tuple of names.  The policy reads only
``mesh.shape``, so every function here runs without a process.
:func:`tree_shardings` pairs each spec with the mesh
(:class:`NamedSharding`), which the checkpoint and the ranks read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

from .collectives import to_placements
from .context import ShardingContext

if TYPE_CHECKING:      # models imports this module: no import cycle
    from ..models.config import ModelConfig, ShapeConfig

TP_MIN_DMODEL = 3584
FSDP_MIN_PARAMS = 10e9
SP_MIN_DMODEL = 6144


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each shard of a tensor lives."""
    mesh: object
    spec: PartitionSpec

    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


@dataclass
class Policy:
    mesh: object
    dp_axes: tuple                 # batch axes, e.g. ("data",) or ("pod","data")
    tp: bool
    fsdp: bool
    sp: bool
    ep_axis: Optional[str]
    microbatches: int
    rules: dict = field(default_factory=dict)
    # dp spec for THIS shape's batch dim (None when batch < dp, e.g. B=1)
    batch_dp: object = None
    cfg: Optional[ModelConfig] = None   # for the parameter specs of context()

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    def context(self) -> ShardingContext:
        specs = None
        if self.cfg is not None:
            from ..models.model import param_specs
            specs = param_pspecs(param_specs(self.cfg), self, self.cfg)
        return ShardingContext(mesh=self.mesh, rules=self.rules,
                               ep_axis=self.ep_axis, dp_axes=self.dp_axes,
                               param_specs=specs)

    def named(self, spec) -> NamedSharding:
        return NamedSharding(self.mesh, spec)


def make_policy(cfg: ModelConfig, shape: ShapeConfig, mesh,
                *, tp: Optional[bool] = None, fsdp: Optional[bool] = None,
                sp: Optional[bool] = None,
                microbatches: Optional[int] = None,
                dp_over_model: bool = False) -> Policy:
    n_params = cfg.params_count()
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if dp_over_model:
        # small-model remesh: fold the model axis into the batch axes (pure
        # DP over all chips, ZeRO over all chips)
        dp_axes = dp_axes + ("model",)
        tp = False
        sp = False if sp is None else sp
    dp_size = 1
    for a in dp_axes:
        dp_size *= mesh.shape[a]

    tp = tp if tp is not None else cfg.d_model >= TP_MIN_DMODEL
    fsdp = fsdp if fsdp is not None else n_params >= FSDP_MIN_PARAMS
    sp = sp if sp is not None else shape.kind == "train"
    ep_axis = ("model" if cfg.family == "moe" and not dp_over_model
               else None)

    if microbatches is None:
        if shape.kind == "train":
            # ≤ 1 sequence a shard a microbatch for ≥30B models, ≤ 2 below
            per_shard = max(1, shape.global_batch // dp_size)
            microbatches = per_shard if n_params >= 30e9 else \
                max(1, per_shard // 2)
        else:
            microbatches = 1

    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    batch_dp = dp
    if shape.kind == "decode" and shape.global_batch < dp_size:
        batch_dp = None              # batch 1: nothing to shard

    model_if_tp = "model" if tp else None
    seq_model = "model" if sp else None
    # prefill emits per-layer K/V destined for a seq-sharded cache
    kv_seq = "model" if shape.kind in ("prefill", "decode") else None

    rules = {
        "act_btd": P(batch_dp, seq_model, None),
        "act_bshd": P(batch_dp, None, model_if_tp, None),
        "act_bskd": P(batch_dp, kv_seq, None, None),
        "act_bshd_flat": P(batch_dp, None, model_if_tp),
        "act_btf": P(batch_dp, None, model_if_tp),
        "act_btd_inner": P(batch_dp, None, model_if_tp),
        "kv_cache": P(batch_dp, "model", None, None),
        "kv_cache_stacked": P(None, batch_dp, "model", None, None),
    }

    return Policy(mesh=mesh, dp_axes=dp_axes, tp=tp, fsdp=fsdp, sp=sp,
                  ep_axis=ep_axis, microbatches=microbatches, rules=rules,
                  batch_dp=batch_dp, cfg=cfg)


# ---------------------------------------------------------------------------
# trees with paths
# ---------------------------------------------------------------------------


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists; paths are
    '/'-joined keys and indices, as the reference's ``_path_str``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def tree_leaves_with_path(tree) -> list:
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


# ---------------------------------------------------------------------------
# parameter specs by tree path
# ---------------------------------------------------------------------------


def _param_spec(path: str, leaf, pol: Policy, cfg: ModelConfig) -> P:
    """path: '/'-joined dict keys, e.g. 'layers/attn/wq'."""
    ndim = len(leaf.shape)
    lead = ndim - 2                 # stacked layer/group dims
    if pol.fsdp:
        fsdp = (pol.dp if "model" in pol.dp_axes else pol.dp_axes[-1])
    else:
        fsdp = None
    tp = "model" if pol.tp else None
    name = path.split("/")[-1]

    def spec(*dims):
        return P(*([None] * lead + list(dims)))

    # vocab-parallel embedding/head, unless `model` is already a dp axis
    vocab_tp = None if (isinstance(fsdp, tuple) and "model" in fsdp) \
        else "model"
    if name in ("w",) or "norm" in path:                 # norm scales
        return P(*([None] * ndim))
    if name == "tok":
        return P(vocab_tp, fsdp)
    if name == "lm_head":
        return P(fsdp, vocab_tp)
    if name == "router":
        return spec(None, None)
    if ("/moe/" in path or path.startswith("moe/")) and "dense" not in path:
        ep = pol.ep_axis
        if name in ("w_gate", "w_up"):                   # (E, D, Fe)
            return P(*([None] * (ndim - 3) + [ep, None, fsdp]))
        if name == "w_down":                             # (E, Fe, D)
            return P(*([None] * (ndim - 3) + [ep, fsdp, None]))
    if name in ("wq", "wk", "wv"):                       # (D, H·dh)
        return spec(fsdp, tp)
    if name == "wo":                                     # (H·dh, D)
        return spec(tp, fsdp)
    if name in ("bq", "bk", "bv"):
        return P(*([None] * (ndim - 1) + [tp]))
    if name in ("w_gate", "w_up"):                       # mlp (D, F)
        return spec(fsdp, tp)
    if name == "w_down":                                 # (F, D)
        return spec(tp, fsdp)
    # mamba / xlstm projections
    if name == "w_in":                                   # (D, 2di+2N+H)
        return spec(fsdp, tp)
    if name == "w_out":                                  # (di, D) / (D, D)
        return spec(tp, fsdp)
    if name in ("w_q", "w_k", "w_v"):                    # (di, di)
        return spec(fsdp, tp)
    if name == "w_x":                                    # (D, 4D)
        return spec(fsdp, tp)
    if name == "w_gates":
        return spec(None, None)
    if name == "r":                                      # (H, dh, 4dh)
        return P(*([None] * ndim))
    if name == "w_conv":                                 # (k, di)
        return P(*([None] * (ndim - 1) + [tp]))
    # small vectors (dt_bias, a_log, d_skip, b, b_gates, ...)
    return P(*([None] * ndim))


def param_pspecs(params_tree, pol: Policy, cfg: ModelConfig):
    """Spec tree matching ``params_tree`` (tensors, meta tensors or any
    leaves with ``.shape``)."""
    return tree_map_with_path(
        lambda path, leaf: _param_spec(path, leaf, pol, cfg), params_tree)


def param_shardings(params_tree, pol: Policy, cfg: ModelConfig):
    return tree_shardings(param_pspecs(params_tree, pol, cfg), pol)


def opt_policy(pol: Policy) -> Policy:
    """The optimizer state's policy: always ZeRO-sharded over the batch
    axes, as the reference's launcher places it."""
    return dataclasses.replace(pol, fsdp=True)


# ---------------------------------------------------------------------------
# input / decode-state specs
# ---------------------------------------------------------------------------


def input_pspecs(input_tree, pol: Policy, kind: str):
    """Batch dims over DP axes.  train leaves: (M, mb, S[, D]);
    prefill: (B, S[, D]); decode token: (B, 1[, D])."""
    bdp = pol.dp if kind == "train" else pol.batch_dp
    if kind == "train":
        rule = lambda leaf: P(*([None, bdp] + [None] * (len(leaf.shape) - 2)))
    else:
        rule = lambda leaf: P(*([bdp] + [None] * (len(leaf.shape) - 1)))
    return tree_map_with_path(lambda _, leaf: rule(leaf), input_tree)


def decode_state_pspecs(state_tree, pol: Policy, batch: int):
    """Decode-state sharding: KV caches (n, B, S, Hkv, dh) batch→data,
    seq→model; recurrent states batch→data; scalars replicated."""
    dp_size = 1
    for a in pol.dp_axes:
        dp_size *= pol.mesh.shape[a]
    bdp = pol.dp if batch >= dp_size else None

    def rule(ps, leaf):
        nd = len(leaf.shape)
        if "/kv/" in ps or ps.startswith("kv/"):
            return P(None, bdp, "model", None, None)
        if ps == "len":
            return P(bdp)
        if ps.startswith("conv") or ps.startswith("ssd"):
            return P(*([None, bdp] + [None] * (nd - 2)))
        if ps.startswith("mlstm"):
            return P(*([None, None, bdp] + [None] * (nd - 3)))
        if ps.startswith("slstm"):
            return P(*([None, bdp] + [None] * (nd - 2)))
        return P(*([None] * nd))

    return tree_map_with_path(rule, state_tree)


def tree_shardings(pspec_tree, pol: Policy):
    return tree_map_with_path(lambda _, spec: pol.named(spec), pspec_tree)


# ---------------------------------------------------------------------------
# parameters on the ranks
# ---------------------------------------------------------------------------


def _spec_at(spec_tree, path: str):
    node = spec_tree
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, (tuple, list)) and \
            not isinstance(node, PartitionSpec) else node[k]
    return node


def _check_even(path: str, shape, spec, mesh) -> None:
    for d, entry in enumerate(spec):
        k = mesh.axes_size(entry)
        if shape[d] % k:
            raise ValueError(f"{path}: dim {d} of {tuple(shape)} does not "
                             f"divide over {entry} ({k} shards); the "
                             f"layers gather parameter shards of equal size")


def shard_tree(full_tree, spec_tree, mesh):
    """Each leaf of ``full_tree`` cut to this rank's shard (a copy)."""
    place = shard_placer(spec_tree, mesh)
    return tree_map_with_path(lambda path, t: place(path, 0, t), full_tree)


def shard_placer(spec_tree, mesh):
    """``place`` for ``models.model.init_params``: keeps this rank's shard
    of each drawn layer (a copy), by the spec of the stacked leaf."""
    from .collectives import local_shard

    def place(path, lead, t):
        spec = PartitionSpec(*_spec_at(spec_tree, path)[lead:])
        _check_even(path, t.shape, spec, mesh)
        return local_shard(t, spec, mesh).clone()
    return place


def strip_lead(spec_tree, lead: int):
    """The specs of one layer of a stacked tree (``lead`` layer dims)."""
    return tree_map_with_path(lambda _, s: PartitionSpec(*s[lead:]),
                              spec_tree)


def _computes_split(path: str, cfg: ModelConfig, mesh,
                    keep_vocab: bool) -> bool:
    """Whether the layer that reads the parameter at ``path`` computes
    with its ``model``-sharded dim as it is: the attention projections
    (by heads, where ``model`` divides the q and kv heads), the MLP's (by
    F), the experts (EP, where ``model`` divides them), the embedding and
    the LM head (by vocab; the head only where ``keep_vocab``)."""
    name = path.split("/")[-1]
    tp = mesh.axes_size("model")
    if name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        return cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    if name in ("w_gate", "w_up", "w_down"):
        if path.startswith("moe/") and "dense" not in path:
            return cfg.n_experts_padded % tp == 0
        return True
    if name == "lm_head":
        return keep_vocab
    return name == "tok"


def params_for_use(tree, spec_tree, cfg: ModelConfig, *,
                   keep_vocab: bool = True):
    """The parameters a layer computes with: each dim the policy shards
    over other axes than the one the layer splits its work on is gathered
    here, just before use (``collectives.gather_on_use``: the FSDP dims,
    and the ``model`` dims of projections computed whole, such as Mamba2's
    and xLSTM's).  ``spec_tree`` matches ``tree``.  With no context, or no
    specs, the tree as it is."""
    from .collectives import gather_on_use
    from .context import current_context
    ctx = current_context()
    if ctx is None or spec_tree is None:
        return tree
    mesh = ctx.mesh

    def use(path, t):
        spec = _spec_at(spec_tree, path)
        keep = "model" if _computes_split(path, cfg, mesh, keep_vocab) \
            else None
        for d, entry in enumerate(spec):
            k = mesh.axes_size(entry)
            if k > 1 and entry != keep:
                t = gather_on_use(t, d, entry, mesh, t.shape[d] * k,
                                  ctx.dp_axes)
        return t
    return tree_map_with_path(use, tree)
