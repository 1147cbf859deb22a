"""The port's multi-pod dry run (``repro_torch.launch.{analysis,hlo_cost,
dryrun}``) against the JAX package's, on the CPU.

* ``analytic_memory_bytes`` equals the reference's in each of the 64
  runnable (arch × shape × mesh) cells, at relative 1e-12, each side with
  its own policy at the production mesh shapes (no process).
* The counting pass sees every iteration of a Python loop: 7 products of
  256³ count 7·2·256³, a 3 × 4 nest of 128³ counts 12·2·128³, an all-reduce
  in a 5-step loop counts 5 (``tests/test_analysis.py``'s checks of the
  reference's trip counts), and an L-layer train step counts exactly one
  layer's FLOPs more for each layer.
* On reduced configs over a (2, 4) mesh, the port's per-device FLOPs (rank
  0 of 8 fake ranks) against the reference's ``hlo_cost.analyze`` of the
  compiled step (8 forced host devices, one subprocess).  Decode, and
  prefill under TP, are equal exactly.  A train step's count is the
  reference's plus exactly the products the port's backward recomputes and
  XLA's CSE merges with the forward's: each layer's attention scores
  (``attention_bwd_ref``, the flash backward's design) and, without TP,
  the CE head's logits (the chunked CE backward); the configs have remat
  off, so nothing else is recomputed.  Left out: prefill without TP, where
  the reference's ``act_bskd`` rule splits the K/V projections by sequence
  over ``model`` and the port computes them whole on every ``model`` rank
  (the port does not split compute by sequence: ROADMAP.md A3).
  Collectives: the all-reduce bytes of the decode cells are equal (the
  configs are fp32, so the port's fp32 all-reduce and the reference's
  bytes agree; on a bf16 config the port's all-reduce sends twice the
  reference's ``collective_bytes_bf16eq``).  The all-gathers are left out:
  XLA re-partitions the reference's step with collective-permutes and
  all-to-alls that the port's explicit collectives do not have.
* The roofline's terms over the H100 peaks.

``run_cell`` on production cells is in ``tests/test_torch_dryrun_cells.py``
(its llama3-405b ``train_4k`` cell alone counts for ~2 min on the CPU, so
xdist runs it beside this file).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_NAMES
from repro.distributed.policy import make_policy as ref_make_policy
from repro.launch.analysis import analytic_memory_bytes as ref_bytes
from repro.models.config import SHAPES, shape_applicable
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.collectives import Mesh, all_reduce
from repro_torch.distributed.policy import make_policy
from repro_torch.launch.analysis import Roofline, analytic_memory_bytes
from repro_torch.launch.dryrun import fake_step, fake_world
from repro_torch.launch.hlo_cost import analyze
from repro_torch.models.config import ShapeConfig

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
AXES = {False: {"data": 16, "model": 16},
        True: {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s, mp) for a in ARCH_NAMES for s in SHAPES for mp in (False, True)
         if shape_applicable(get_config(a), s)[0]]


class _ShapeOnly:
    """The reference's policy reads only ``mesh.shape``."""
    def __init__(self, shape):
        self.shape = dict(shape)


def test_the_matrix_has_64_runnable_cells():
    assert len(CELLS) == 64


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_analytic_memory_bytes_equal_the_references(arch, shape, multi_pod):
    from repro.configs import get_config as ref_get_config
    ref_pol = ref_make_policy(ref_get_config(arch), SHAPES[shape],
                              _ShapeOnly(AXES[multi_pod]))
    want = ref_bytes(ref_get_config(arch), SHAPES[shape], ref_pol)
    pol = make_policy(get_config(arch), SHAPES[shape],
                      Mesh(shape=dict(AXES[multi_pod])))
    got = analytic_memory_bytes(get_config(arch), SHAPES[shape], pol)
    assert abs(got - want) <= 1e-12 * abs(want), (got, want)


# ---------------------------------------------------------------------------
# the counting pass sees every iteration
# ---------------------------------------------------------------------------

def test_loop_flops_are_the_unrolled_count():
    x = torch.randn(256, 256)

    def loop(x):
        for _ in range(7):
            x = x @ x
        return x
    assert analyze(loop, x).flops == 7 * 2 * 256 ** 3


def test_nested_loop_multiplicity():
    x = torch.randn(128, 128)

    def nested(x):
        for _ in range(3):
            for _ in range(4):
                x = x @ x
        return x
    assert analyze(nested, x).flops == 12 * 2 * 128 ** 3


def test_collective_counted_once_per_iteration():
    """An all-reduce inside a 5-step loop, on rank 0 of 4 fake ranks."""
    with fake_world(4):
        mesh = Mesh.over_world((1, 4), ("data", "model"))

        def body(x):
            for _ in range(5):
                x = all_reduce(x, "model", mesh) * 0.5 + x
            return x
        with FakeTensorMode():
            cost = analyze(body, torch.empty(64, 64))
    assert cost.collective_count_by_kind == {"all_reduce": 5}
    assert cost.collective_by_kind == {"all_reduce": 5 * 64 * 64 * 4}
    assert not dist.is_initialized()


def _train_flops(cfg, layers):
    cfg = dataclasses.replace(cfg, n_layers=layers)
    with FakeTensorMode():
        step, args, _ = fake_step(cfg, ShapeConfig("t", 64, 4, "train"),
                                  microbatches=2)
        return analyze(step, *args)


@pytest.mark.parametrize("remat", [False, True])
def test_layer_stack_is_L_times_one_layer(remat):
    """A train step (2 microbatches, forward and backward, with and without
    the remat recompute) counts one layer's FLOPs and op bytes once per
    layer, exactly."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-7b")), remat=remat)
    f1, f2, f4 = (_train_flops(cfg, n) for n in (1, 2, 4))
    layer = f2.flops - f1.flops
    assert layer > 0
    assert f4.flops == f1.flops + 3 * layer
    assert f4.bytes == f1.bytes + 3 * (f2.bytes - f1.bytes)


def test_peak_live_bytes_follow_saved_tensors():
    """A temporary freed at once leaves the peak; a tensor autograd saves
    stays live until the backward frees it."""
    with FakeTensorMode():
        x = torch.empty(1000, 1000, requires_grad=True)

        def step(x):
            y = torch.exp(x)                  # saved for the backward
            z = (y * 2).sum()                 # y * 2: a temporary
            del y
            return torch.autograd.grad(z, x)[0]
        cost = analyze(step, x)
    # at most three 4 MB tensors at once (exp's output, a gradient and the
    # next), and the few bytes of 0-d ones
    assert 12e6 <= cost.peak_live_bytes < 12e6 + 64


# ---------------------------------------------------------------------------
# per-device FLOPs against the reference's hlo_cost on a (2, 4) mesh
# ---------------------------------------------------------------------------

# name -> (arch, reduced-config overrides, ShapeConfig args, policy flags)
PARITY = {
    "train": ("qwen2-7b", {}, ("t", 64, 8, "train"), {}),
    "train_tp_fsdp": ("qwen2-7b", {"n_kv_heads": 4}, ("t", 64, 8, "train"),
                      {"tp": True, "fsdp": True}),
    "prefill_tp": ("qwen2-7b", {"n_kv_heads": 4}, ("p", 64, 8, "prefill"),
                   {"tp": True}),
    "decode": ("qwen2-7b", {}, ("d", 64, 8, "decode"), {}),
    "decode_tp": ("qwen2-7b", {"n_kv_heads": 4}, ("d", 64, 8, "decode"),
                  {"tp": True}),
}

REFERENCE = textwrap.dedent("""
import dataclasses, json, sys
import jax
from repro.configs import get_config, reduced
from repro.models.config import ShapeConfig
from repro.distributed.context import use_context
from repro.distributed.policy import (decode_state_pspecs, input_pspecs,
                                      make_policy, param_pspecs,
                                      tree_shardings)
from repro.models.model import decode_step, init_decode_state, param_specs
from repro.optim import pick_optimizer
from repro.serve.step import make_prefill_step
from repro.train.step import make_train_step
from repro.launch import hlo_cost
from repro.launch.mesh import make_debug_mesh
from repro.launch.specs import (decode_input_specs, prefill_input_specs,
                                train_input_specs)
mesh = make_debug_mesh((2, 4), ("data", "model"))
out = {}
# the reference's lower_cell (launch/dryrun.py) on the debug mesh
for name, (arch, over, shp, flags) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    shape = ShapeConfig(*shp)
    pol = make_policy(cfg, shape, mesh, **flags)
    with use_context(pol.context()):
        pstruct = param_specs(cfg)
        pshard = tree_shardings(param_pspecs(pstruct, pol, cfg), pol)
        if shape.kind == "train":
            opt = pick_optimizer(cfg.params_count())
            pol_opt = dataclasses.replace(pol, fsdp=True)
            step = make_train_step(cfg, opt, policy=pol,
                                   grad_pspecs=param_pspecs(pstruct, pol_opt,
                                                            cfg))
            ostruct = jax.eval_shape(opt.init, pstruct)
            oshard = tree_shardings(param_pspecs(ostruct, pol_opt, cfg), pol)
            batch = train_input_specs(cfg, shape, pol.microbatches)
            bshard = tree_shardings(input_pspecs(batch, pol, "train"), pol)
            low = jax.jit(step, in_shardings=(pshard, oshard, bshard),
                          out_shardings=(pshard, oshard, None),
                          donate_argnums=(0, 1)).lower(pstruct, ostruct,
                                                       batch)
        elif shape.kind == "prefill":
            pf = make_prefill_step(cfg, max_len=shape.seq_len)
            inputs = prefill_input_specs(cfg, shape)
            ishard = tree_shardings(input_pspecs(inputs, pol, "prefill"),
                                    pol)
            sstruct = jax.eval_shape(lambda: init_decode_state(
                cfg, shape.global_batch, shape.seq_len))
            sshard = tree_shardings(decode_state_pspecs(
                sstruct, pol, shape.global_batch), pol)
            low = jax.jit(pf, in_shardings=(pshard, ishard),
                          out_shardings=(None, sshard)).lower(pstruct,
                                                              inputs)
        else:
            tok, sstruct = decode_input_specs(cfg, shape)
            sshard = tree_shardings(decode_state_pspecs(
                sstruct, pol, shape.global_batch), pol)
            tshard = tree_shardings(input_pspecs(tok, pol, "decode"), pol)
            dec = lambda p, s, t: decode_step(p, s, t, cfg)
            low = jax.jit(dec, in_shardings=(pshard, sshard, tshard),
                          out_shardings=(None, sshard),
                          donate_argnums=(1,)).lower(pstruct, sstruct, tok)
    hc = hlo_cost.analyze(low.compile().as_text())
    out[name] = {"flops": hc.flops, "bytes": hc.collective_by_kind,
                 "unknown": hc.unknown_trip_loops}
print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_counts():
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    done = subprocess.run([sys.executable, "-c", REFERENCE,
                           json.dumps(PARITY)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_counts():
    out = {}
    with fake_world(8):
        mesh = Mesh.over_world((2, 4), ("data", "model"))
        for name, (arch, over, shp, flags) in PARITY.items():
            cfg = dataclasses.replace(reduced(get_config(arch)), **over)
            shape = ShapeConfig(*shp)
            pol = make_policy(cfg, shape, mesh, **flags)
            with FakeTensorMode():
                step, args, _ = fake_step(cfg, shape, pol)
                cost = analyze(step, *args)
            out[name] = (cost, cfg, shape, pol)
    return out


def _recomputed(cfg, shape, pol) -> float:
    """FLOPs of the products the port's backward recomputes on rank 0: each
    layer's scores q·kᵀ (its rank's heads) in every microbatch, and
    without TP the CE head's logits."""
    mesh = pol.mesh.shape
    dp = mesh["data"]
    tp = mesh["model"] if pol.tp else 1
    seqs = shape.global_batch // dp             # this rank's sequences
    S, dh = shape.seq_len, cfg.d_head
    scores = 2.0 * seqs * (cfg.n_heads // tp) * S * S * dh * cfg.n_layers
    logits = 0.0 if pol.tp else \
        2.0 * seqs * S * cfg.d_model * cfg.vocab_padded
    return scores + logits


@pytest.mark.parametrize("name", list(PARITY))
def test_flops_equal_the_references_hlo_cost(name, ref_counts, port_counts):
    cost, cfg, shape, pol = port_counts[name]
    want = ref_counts[name]["flops"]
    assert ref_counts[name]["unknown"] == 0
    extra = _recomputed(cfg, shape, pol) if shape.kind == "train" else 0.0
    assert cost.flops == want + extra, (cost.flops, want, extra)


@pytest.mark.parametrize("name", ["decode", "decode_tp"])
def test_all_reduce_bytes_equal_the_references(name, ref_counts,
                                               port_counts):
    cost = port_counts[name][0]
    assert cost.collective_by_kind["all_reduce"] == \
        ref_counts[name]["bytes"]["all-reduce"]


def test_roofline_terms_use_the_h100_peaks():
    roof = Roofline(flops=989e12, bytes_accessed=3.35e12,
                    collective_bytes=100e9, n_chips=256)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == \
        (1.0, 1.0, 2.0)
    assert roof.dominant == "collective" and roof.step_time_s == 2.0
    assert roof.global_flops == 256 * 989e12
