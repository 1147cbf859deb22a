"""The port's sharding policy against the JAX package's, with no process:
``repro_torch.distributed.policy`` reads only ``mesh.shape``, so every
(arch × shape) cell is held to the reference at the production mesh shapes
(16, 16) and (2, 16, 16), spec for spec: the derived flags and microbatch
counts, the activation rules, ``param_pspecs`` over ``param_specs(cfg)``,
``input_pspecs`` and ``decode_state_pspecs``; and ``launch/specs.py``'s
stand-ins, shape for shape and dtype for dtype.  Each cell's specs also
pass the reference's structural check (every spec divides its dim and
never repeats a mesh axis).  The counterparts of ``tests/test_policy.py``.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_NAMES, get_config
from repro.distributed.policy import (decode_state_pspecs as ref_state_specs,
                                      input_pspecs as ref_input_specs,
                                      make_policy as ref_make_policy,
                                      param_pspecs as ref_param_pspecs)
from repro.launch.specs import input_specs as ref_input_specs_of
from repro.models.config import SHAPES, shape_applicable
from repro.models.model import param_specs as ref_param_specs
from repro_torch.configs import get_config as port_get_config
from repro_torch.distributed.collectives import Mesh, shard_bounds
from repro_torch.distributed.policy import (FSDP_MIN_PARAMS, SP_MIN_DMODEL,
                                            TP_MIN_DMODEL, PartitionSpec,
                                            decode_state_pspecs, input_pspecs,
                                            make_policy, param_pspecs,
                                            tree_leaves_with_path)
from repro_torch.launch.specs import input_specs
from repro_torch.models.config import SHAPES as PORT_SHAPES
from repro_torch.models.model import param_specs

AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


class ProdMesh:
    """Duck-typed mesh carrying production axis sizes (the reference's
    policy reads only .shape)."""
    def __init__(self, multi_pod=False):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})


def _port_mesh(multi_pod=False) -> Mesh:
    return Mesh(shape=dict(ProdMesh(multi_pod).shape))


def _ref_by_path(tree, specs) -> dict:
    """{path: spec tuple} of a reference spec tree (dicts flatten sorted in
    JAX, so compare by path, not by order)."""
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    for path, spec in leaves:
        parts = [str(k.key) if hasattr(k, "key") else str(k.idx)
                 for k in path]
        out["/".join(parts)] = tuple(spec)
    return out


def _port_by_path(specs) -> dict:
    return {p: tuple(s) for p, s in tree_leaves_with_path(specs)}


def _check_structure(tree, specs, where):
    """The reference's structural check on the port's specs."""
    shapes = dict(tree_leaves_with_path(tree))
    for path, spec in tree_leaves_with_path(specs):
        assert isinstance(spec, PartitionSpec), (where, path, spec)
        used = []
        for dim, entry in zip(shapes[path].shape, spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            shards = 1
            for a in axes:
                assert a not in used, f"{where}/{path}: duplicate {a}"
                used.append(a)
                shards *= AXIS_SIZES[a]
            assert dim % shards == 0, f"{where}/{path}: {dim} % {shards}"


def _policies(arch, shape_name, multi_pod, **kw):
    cfg_r, cfg_p = get_config(arch), port_get_config(arch)
    ref = ref_make_policy(cfg_r, SHAPES[shape_name], ProdMesh(multi_pod),
                          **kw)
    port = make_policy(cfg_p, PORT_SHAPES[shape_name], _port_mesh(multi_pod),
                       **kw)
    return cfg_r, cfg_p, ref, port


def _same_policy(ref, port):
    assert (port.dp_axes, port.tp, port.fsdp, port.sp, port.ep_axis,
            port.microbatches, port.batch_dp) == \
        (ref.dp_axes, ref.tp, ref.fsdp, ref.sp, ref.ep_axis,
         ref.microbatches, ref.batch_dp)
    assert {k: tuple(v) for k, v in port.rules.items()} == \
        {k: tuple(v) for k, v in ref.rules.items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_every_cell_policy_equals_the_reference(arch, shape_name, multi_pod):
    """Flags, microbatches, rules and every parameter, input and
    decode-state spec of the cell equal the reference's; the port's specs
    pass its structural check where the cell runs."""
    cfg_r, cfg_p, ref, port = _policies(arch, shape_name, multi_pod)
    _same_policy(ref, port)
    shape = SHAPES[shape_name]
    runs, _ = shape_applicable(cfg_r, shape_name)

    pstruct = param_specs(cfg_p)
    got = param_pspecs(pstruct, port, cfg_p)
    rstruct = ref_param_specs(cfg_r)
    assert _port_by_path(got) == _ref_by_path(
        rstruct, ref_param_pspecs(rstruct, ref, cfg_r))
    if runs:
        _check_structure(pstruct, got, f"{arch}/{shape_name}/params")

    mb = port.microbatches
    p_in = input_specs(arch, shape_name, microbatches=mb)
    r_in = ref_input_specs_of(arch, shape_name, microbatches=mb)
    if shape.kind == "decode":
        p_tok, r_tok = {"token": p_in["token"]}, {"token": r_in["token"]}
        assert _port_by_path(input_pspecs(p_tok, port, "decode")) == \
            _ref_by_path(r_tok, ref_input_specs(r_tok, ref, "decode"))
        got_s = decode_state_pspecs(p_in["state"], port, shape.global_batch)
        assert _port_by_path(got_s) == _ref_by_path(
            r_in["state"], ref_state_specs(r_in["state"], ref,
                                           shape.global_batch))
        if runs:
            _check_structure(p_in["state"], got_s,
                             f"{arch}/{shape_name}/state")
    else:
        assert _port_by_path(input_pspecs(p_in, port, shape.kind)) == \
            _ref_by_path(r_in, ref_input_specs(r_in, ref, shape.kind))


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_input_specs_equal_the_references(arch, shape_name):
    """``launch/specs.py``'s meta stand-ins have the reference's
    ShapeDtypeStructs' shapes and dtypes, leaf for leaf (the decode state
    included), and allocate nothing."""
    mb = ref_make_policy(get_config(arch), SHAPES[shape_name],
                         ProdMesh()).microbatches
    got = dict(tree_leaves_with_path(input_specs(arch, shape_name, mb)))
    want = jax.tree_util.tree_leaves_with_path(
        ref_input_specs_of(arch, shape_name, mb))
    want = {"/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                     for k in p): v for p, v in want}
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "musicgen-medium",
                                  "zamba2-1.2b", "xlstm-1.3b"])
def test_dp_over_model_policies_equal_the_references(arch):
    """The small-model remesh: no EP, the model axis folded into the batch
    axes; flags, rules and parameter specs the reference's, and valid."""
    cfg_r, cfg_p, ref, port = _policies(arch, "train_4k", False,
                                        dp_over_model=True)
    _same_policy(ref, port)
    assert port.ep_axis is None
    pstruct = param_specs(cfg_p)
    got = param_pspecs(pstruct, port, cfg_p)
    rstruct = ref_param_specs(cfg_r)
    assert _port_by_path(got) == _ref_by_path(
        rstruct, ref_param_pspecs(rstruct, ref, cfg_r))
    _check_structure(pstruct, got, f"{arch}/remesh/params")


def test_policy_flags_follow_scale():
    big = make_policy(port_get_config("llama3-405b"), PORT_SHAPES["train_4k"],
                      _port_mesh())
    small = make_policy(port_get_config("musicgen-medium"),
                        PORT_SHAPES["train_4k"], _port_mesh())
    assert big.tp and big.fsdp and big.sp
    assert not small.tp and not small.fsdp
    assert make_policy(port_get_config("granite-moe-3b-a800m"),
                       PORT_SHAPES["train_4k"], _port_mesh()).ep_axis == \
        "model"
    lp = make_policy(port_get_config("xlstm-1.3b"), PORT_SHAPES["long_500k"],
                     _port_mesh())
    assert lp.batch_dp is None


def test_policy_constants_are_the_references():
    from repro.distributed import policy as ref
    assert (TP_MIN_DMODEL, FSDP_MIN_PARAMS, SP_MIN_DMODEL) == \
        (ref.TP_MIN_DMODEL, ref.FSDP_MIN_PARAMS, ref.SP_MIN_DMODEL)


@pytest.mark.parametrize("n,k", [(49155, 4), (512, 4), (5, 4), (3, 8),
                                 (48, 16), (1, 2)])
def test_shards_round_trip_and_pad_as_jax(n, k):
    """``local_shard`` cuts pieces of ⌈n/k⌉ with the last ones short or
    empty (JAX's padded shards; ``torch.chunk`` would give fewer pieces),
    and the pieces concatenate back to the tensor."""
    from repro_torch.distributed.collectives import local_shard
    full = torch.arange(n * 3).reshape(n, 3)
    pieces = []
    for i in range(k):
        mesh = Mesh(shape={"data": 1, "model": k},
                    coords={"data": 0, "model": i})
        piece = local_shard(full, PartitionSpec("model", None), mesh)
        lo, hi = shard_bounds(n, k, i)
        step = -(-n // k)
        assert piece.shape[0] == hi - lo == max(0, min(step, n - i * step))
        pieces.append(piece)
    assert torch.equal(torch.cat(pieces), full)


def test_placements_follow_the_spec():
    """``to_placements``: Shard(d) on the mesh dims the spec names, else
    Replicate, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.collectives import to_placements
    mesh = Mesh(shape={"pod": 2, "data": 2, "model": 4})
    assert to_placements(PartitionSpec(None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    assert to_placements(PartitionSpec(("pod", "data"), None, "model"),
                         mesh) == (Shard(0), Shard(0), Shard(2))


def test_param_specs_are_meta_with_init_params_shapes():
    """``param_specs`` allocates nothing and has ``init_params``' tree,
    shapes and dtypes (the reduced qwen2, drawn on the CPU)."""
    from repro_torch.configs import reduced
    from repro_torch.models.model import init_params
    cfg = reduced(port_get_config("qwen2-7b"))
    meta = dict(tree_leaves_with_path(param_specs(cfg)))
    real = dict(tree_leaves_with_path(init_params(cfg, device="cpu")))
    assert set(meta) == set(real)
    for p, t in meta.items():
        assert t.device.type == "meta"
        assert (t.shape, t.dtype) == (real[p].shape, real[p].dtype)
