"""The port's distributed paths against the JAX package's, on the CPU.

The reference side runs once, in one subprocess with a forced 8-device
host platform (the main process keeps one device), and writes its inputs,
weights and results to an npz.  The port side runs once, in one spawn of 8
gloo ranks (``repro_torch.distributed.spawn``) on a (2, 4) mesh over
("data", "model"), from those weights (``tests/_torch_dist_ranks.py``).
The tests compare, at ``tests/test_distributed.py``'s tolerances or
tighter:

* ``vocab_parallel_ce`` loss and dx against the fused CE (1e-4);
* ``moe_ffn``'s EP branch against the local one (2e-4), and its DP branch
  against the reference's DP branch;
* ``compressed_all_reduce`` against ``compressed_psum``;
* the sequence-sharded decode through ``prefill`` and ``decode_step``
  (2e-3) against the reference's single-device logits: the reference
  test's case, and a prompt of 6 in a cache of 16 over 4 shards, decoded 3
  steps, which leaves the last shards empty; qwen2 with 2 kv heads
  (attention gathered on use), with 4 (split by heads), and granite (EP);
* the sharded train step (tp, fsdp, 2 microbatches) against the
  reference's single-device step: loss 2e-4, params 2e-3; the same with
  ``grad_compress``; 2 Adafactor steps under ZeRO against the reference's
  single-device ``adafactor`` (losses, parameters, and the moments whole
  on every rank);
* the elastic restore of a (2, 4) checkpoint onto (1, 4) (1e-5).

The int8 round trip and the error feedback are compared in this process,
bit for bit.  These are the counterparts of ``tests/test_distributed.py``
and of ``tests/test_optim.py``'s compression tests.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compress import int8_compress_decompress as ref_roundtrip
from repro.optim.compress import make_error_feedback as ref_error_feedback
from repro_torch.optim import int8_compress_decompress, make_error_feedback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)
import _torch_dist_ranks as ranks  # noqa: E402

REFERENCE = textwrap.dedent("""
import dataclasses, sys
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, reduced
from repro.models.config import ShapeConfig
from repro.models.model import (init_params, param_specs, prefill,
                                decode_step)
from repro.distributed.policy import (make_policy, param_pspecs,
                                      tree_shardings)
from repro.distributed.context import use_context, ShardingContext
from repro.distributed.compat import shard_map
from repro.launch.mesh import make_debug_mesh
out = {}
mesh = make_debug_mesh((2, 4), ("data", "model"))
q2 = dataclasses.replace(reduced(get_config("qwen2-7b")), d_model=128,
                         n_heads=4, n_kv_heads=2, vocab=512, dtype="float32")
cfgs = {"q2": q2, "q4": dataclasses.replace(q2, n_kv_heads=4),
        "g128": reduced(get_config("granite-moe-3b-a800m"))}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(k.key) for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)

# vocab-parallel CE
from repro.distributed.vocab_ce import vocab_parallel_ce
from repro.kernels import fused_cross_entropy
rng = np.random.default_rng(1)
T, D, V = 64, 32, 512
x = jnp.asarray(rng.normal(size=(T, D)), jnp.float32)
w = jnp.asarray(rng.normal(size=(D, V)) * 0.1, jnp.float32)
lab = jnp.asarray(rng.integers(0, 500, T), jnp.int32)
val = jnp.ones((T,), bool)
out["vce/x"], out["vce/w"], out["vce/lab"] = map(np.asarray, (x, w, lab))
out["vce/ref"] = np.asarray(fused_cross_entropy(x, w, lab, valid=val,
                                                 n_valid=500))
out["vce/g_ref"] = np.asarray(jax.grad(lambda x: fused_cross_entropy(
    x, w, lab, valid=val, n_valid=500))(x))
with use_context(ShardingContext(mesh=mesh, rules={})):
    out["vce/got"] = np.asarray(vocab_parallel_ce(x, w, lab, val,
                                                  n_valid=500))
    out["vce/g_got"] = np.asarray(jax.grad(lambda x: vocab_parallel_ce(
        x, w, lab, val, n_valid=500))(x))

# MoE: local, EP, DP
from repro.models.moe import moe_ffn
g = dataclasses.replace(reduced(get_config("granite-moe-3b-a800m")),
                        d_model=64, n_heads=4, n_kv_heads=2, n_experts=8,
                        top_k=2, d_ff_expert=32, dtype="float32")
lp = jax.tree.map(lambda a: a[0], init_params(g, jax.random.PRNGKey(0))
                  ["layers"])["moe"]
put("moe/p", lp)
rng = np.random.default_rng(2)
xm = jnp.asarray(rng.normal(size=(2, 16, 64)), jnp.float32)
out["moe/x"] = np.asarray(xm)
out["moe/y_local"] = np.asarray(moe_ffn(lp, xm, g))
with use_context(ShardingContext(mesh=mesh, rules={}, ep_axis="model")):
    out["moe/y_ep"] = np.asarray(jax.jit(lambda p, x: moe_ffn(p, x, g))(
        lp, xm))
with use_context(ShardingContext(mesh=mesh, rules={}, dp_axes=("data",))):
    out["moe/y_dp"] = np.asarray(jax.jit(lambda p, x: moe_ffn(p, x, g))(
        lp, xm))

# compressed psum
from repro.optim.compress import compressed_psum
rng = np.random.default_rng(3)
gg = jnp.asarray(rng.normal(size=(8, 512)), jnp.float32)
out["cmp/g"] = np.asarray(gg)
for name, red in (("exact", lambda g: jax.lax.psum(g, ("data", "model"))),
                  ("compressed",
                   lambda g: compressed_psum(g, ("data", "model")))):
    f = shard_map(lambda g, red=red: red(g) / 8 + 0 * g, mesh=mesh,
                  in_specs=P(("data", "model")),
                  out_specs=P(("data", "model")), check_vma=False)
    out[f"cmp/{name}"] = np.asarray(f(gg))

# single-device decode: prompt S of a MAX cache, then DEC_STEPS steps
S, MAX, B, STEPS = 6, 16, 8, int(sys.argv[2])
out["dec/S"], out["dec/MAX"] = np.int32(S), np.int32(MAX)
for name, cfg in cfgs.items():
    params = init_params(cfg, jax.random.PRNGKey(0))
    put(f"params/{name}", params)
    rng = np.random.default_rng(0)
    toks = jnp.asarray(rng.integers(0, cfg.vocab, (B, S + STEPS)), jnp.int32)
    out[f"dec/{name}/toks"] = np.asarray(toks)
    logits, st = prefill(params, {"tokens": toks[:, :S]}, cfg, max_len=MAX)
    out[f"dec/{name}/logits0"] = np.asarray(logits)
    for i in range(STEPS):
        logits, st = decode_step(params, st, toks[:, S + i:S + i + 1], cfg)
        out[f"dec/{name}/logits{i + 1}"] = np.asarray(logits)
# the reference test's case: prompt 12, cache 16, one step
params = init_params(q2, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
toks = jnp.asarray(rng.integers(0, q2.vocab, (B, 13)), jnp.int32)
out["dec12/toks"] = np.asarray(toks)
_, st = prefill(params, {"tokens": toks[:, :12]}, q2, max_len=16)
out["dec12/ref"] = np.asarray(decode_step(params, st, toks[:, 12:13], q2)[0])

# single-device train steps (the reference test's batch)
from repro.train.step import make_train_step
from repro.optim import adamw
rng = np.random.default_rng(0)
batch = {"tokens": jnp.asarray(rng.integers(0, 512, (2, 4, 64)), jnp.int32),
         "labels": jnp.asarray(rng.integers(0, 512, (2, 4, 64)), jnp.int32)}
out["tr/tokens"], out["tr/labels"] = (np.asarray(batch["tokens"]),
                                      np.asarray(batch["labels"]))
for tag, compress in (("tr", False), ("trc", True)):
    step = make_train_step(q2, adamw(lr=1e-3), grad_compress=compress)
    p, _, m = jax.jit(step)(params, step.init_opt_state(params), batch)
    out[f"{tag}/loss"] = np.asarray(m["loss"])
    out[f"{tag}/gnorm"] = np.asarray(m["grad_norm"])
    put(f"{tag}/after", p)

# Adafactor: 2 single-device steps on the same batch
from repro.optim import adafactor
step = make_train_step(q2, adafactor(lr=1e-3))
p, o = params, step.init_opt_state(params)
jstep = jax.jit(step)
for i in range(2):
    p, o, m = jstep(p, o, batch)
    out[f"ada/loss{i}"] = np.asarray(m["loss"])
    out[f"ada/gnorm{i}"] = np.asarray(m["grad_norm"])
put("ada/after", p)
put("ada/state", o["s"])

# elastic restore: save from (2, 4), load onto (1, 4)
from repro.ckpt import save_checkpoint, load_checkpoint
pol = make_policy(q2, ShapeConfig("t", 32, 8, "train"), mesh, tp=True,
                  fsdp=True)
sharded = jax.device_put(params, tree_shardings(param_pspecs(params, pol,
                                                             q2), pol))
save_checkpoint(sys.argv[3], 1, sharded)
small = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                          ("data", "model"))
pol4 = make_policy(q2, ShapeConfig("t", 32, 8, "train"), small, tp=True,
                   fsdp=True)
pstruct = param_specs(q2)
tree, _ = load_checkpoint(sys.argv[3], 1, pstruct, shardings=tree_shardings(
    param_pspecs(pstruct, pol4, q2), pol4))
out["el/sum_saved"] = np.float64(sum(float(jnp.sum(jnp.abs(l)))
                                     for l in jax.tree.leaves(sharded)))
out["el/sum_restored"] = np.float64(sum(float(jnp.sum(jnp.abs(l)))
                                        for l in jax.tree.leaves(tree)))
np.savez(sys.argv[1], **out)
print("ok")
""")


@pytest.fixture(scope="module")
def work():
    return ranks.scratch_dir()


@pytest.fixture(scope="module")
def ref(work):
    """The reference's inputs, weights and results (one JAX process)."""
    path = os.path.join(work, "reference.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC
    done = subprocess.run(
        [sys.executable, "-c", REFERENCE, path, str(ranks.DEC_STEPS),
         os.path.join(work, "jax_ckpt")],
        env=env, capture_output=True, text=True, timeout=480)
    assert done.returncode == 0, done.stderr[-3000:]
    return dict(np.load(path)), path


@pytest.fixture(scope="module")
def port(ref, work):
    """The port's results: rank 0's, and every rank's loaded modules."""
    from repro_torch.distributed import spawn
    out = spawn(ranks.run, 8, (ref[1], os.path.join(work, "port_ckpt")),
                timeout=420)
    return out[0], [r["loaded"] for r in out]


def test_ranks_load_neither_jax_nor_repro(port):
    assert port[1] == [[]] * 8


def test_vocab_parallel_ce_matches_fused(ref, port):
    r, p = ref[0], port[0]
    assert abs(p["vce/loss"] - float(r["vce/ref"])) < 1e-4
    assert abs(p["vce/loss"] - float(r["vce/got"])) < 1e-4
    assert np.abs(p["vce/dx"] - r["vce/g_ref"]).max() < 1e-4
    assert np.abs(p["vce/dx"] - r["vce/g_got"]).max() < 1e-4


def test_moe_ep_matches_local(ref, port):
    r, p = ref[0], port[0]
    assert np.abs(p["moe/y_ep"] - r["moe/y_local"]).max() < 2e-4
    assert np.abs(p["moe/y_ep"] - r["moe/y_ep"]).max() < 2e-4


def test_moe_dp_matches_the_references_dp_branch(ref, port):
    """Each data rank routes its own 16 tokens with its own capacity, so
    the drops follow the shard: the reference's DP branch, not its local
    path."""
    r, p = ref[0], port[0]
    assert np.abs(p["moe/y_dp"] - r["moe/y_dp"]).max() < 2e-4


def test_compressed_psum_matches_psum(ref, port):
    r, p = ref[0], port[0]
    exact, comp = r["cmp/exact"][0], r["cmp/compressed"][0]
    rel = np.abs(exact - p["cmp/row"]).max() / (np.abs(exact).max() + 1e-9)
    assert rel < 0.02
    # the shared-scale protocol is exact arithmetic: the reference's values
    assert np.array_equal(p["cmp/row"], comp)


@pytest.mark.parametrize("name", ["q2", "q4", "g128"])
def test_seq_sharded_flash_decode_matches_single_device(ref, port, name):
    """Prefill 6 of a 16-token cache over 4 sequence shards, then 3 decode
    steps: shards 2 and 3 hold no valid key at first (their local lengths
    are 0, merged with weight 0)."""
    r, p = ref[0], port[0]
    for i in range(ranks.DEC_STEPS + 1):
        key = f"dec/{name}/logits{i}"
        assert np.abs(p[key] - r[key]).max() < 2e-3, key


def test_seq_sharded_decode_reference_case(ref, port):
    assert np.abs(port[0]["dec12/logits"] - ref[0]["dec12/ref"]).max() < 2e-3


@pytest.mark.parametrize("tag", ["tr", "trc", "tr2"])
def test_sharded_train_matches_single_device(ref, port, tag):
    """tp and fsdp on (2, 4), 2 microbatches: the loss within 2e-4 and every
    parameter after the AdamW step within 2e-3 of the single-device step;
    ``trc`` with ``grad_compress`` on both sides; ``tr2`` tp alone with
    ``grad_pspecs`` (each microbatch's gradients reduced into the ZeRO
    shards) against the plain single-device step."""
    r, p = ref[0], port[0]
    rtag = "tr" if tag == "tr2" else tag
    assert abs(p[f"{tag}/loss"] - float(r[f"{rtag}/loss"])) < 2e-4
    assert abs(p[f"{tag}/gnorm"] - float(r[f"{rtag}/gnorm"])) < 1e-3 * \
        float(r[f"{rtag}/gnorm"])
    worst = max(np.abs(v - r[f"{rtag}/after/{k}"]).max()
                for k, v in p[f"{tag}/after"].items())
    assert worst < 2e-3


def test_sharded_adafactor_losses_match_single_device(ref, port):
    """Adafactor under ZeRO (tp and fsdp on (2, 4), 2 microbatches): each
    of 2 steps' loss within 2e-4 and grad norm within 1e-3 relative of the
    reference's single-device ``adafactor``."""
    r, p = ref[0], port[0]
    for i in range(2):
        assert abs(p["ada/loss"][i] - float(r[f"ada/loss{i}"])) < 2e-4
        want = float(r[f"ada/gnorm{i}"])
        assert abs(p["ada/gnorm"][i] - want) < 1e-3 * want


@pytest.mark.parametrize("leaf", ["layers/attn/wq", "layers/attn/wo",
                                  "embed/tok", "lm_head", "final_norm/w"])
def test_sharded_adafactor_matches_single_device(ref, port, leaf):
    """After 2 sharded Adafactor steps, the parameter (gathered) within
    2e-3 of the reference's single-device step, and its moments (whole on
    every rank, as ``param_pspecs`` places Adafactor's state) within 1e-4
    relative: wq's rows split over data (fsdp) and its columns over model
    (tp), wo's the other way round, the embedding's rows over model and
    its columns over data, the LM head's the other way round; final_norm/w
    is unfactored (its v) and replicated."""
    r, p = ref[0], port[0]
    assert np.abs(p["ada/after"][leaf] - r[f"ada/after/{leaf}"]).max() < 2e-3
    moments = ("v",) if leaf == "final_norm/w" else ("vr", "vc")
    for name in moments:
        got = p["ada/state"][f"{leaf}/{name}"]
        want = r[f"ada/state/{leaf}/{name}"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_collective_counts_one_call_of_each_kind(port):
    """``COLLECTIVE_COUNTS`` adds one a call to its kind beside the bytes
    ``COLLECTIVE_BYTES`` adds (fp32: 4 floats reduced, 4 gathered, 16
    reduce-scattered), and ``reset_collective_bytes`` clears both."""
    seen = port[0]["counters"]
    counts = [c for c, _ in seen]
    sent = [b for _, b in seen]
    kinds = ("all_reduce", "all_gather", "reduce_scatter")
    assert counts[:3] == [dict(zip(kinds, n)) for n in
                          ((1, 0, 0), (1, 1, 0), (1, 1, 1))]
    assert sent[2] == {"all_reduce": 16, "all_gather": 16,
                       "reduce_scatter": 64}
    assert counts[3] == sent[3] == dict.fromkeys(kinds, 0)


def test_uneven_shards_round_trip_through_the_ranks(port):
    """A dim of 49,155 (granite's vocab, unpadded) over 4, 8 and 2 shards:
    ``local_shard`` then ``gather_full`` gives the tensor back."""
    assert port[0]["uneven"]


def test_elastic_restart_across_meshes(ref, port):
    """Saved from (2, 4) by rank 0 after a gather, restored onto (1, 4):
    every leaf the saved parameters, and the sums the reference's."""
    r, p = ref[0], port[0]
    total = 0.0
    for k, v in p["el/restored"].items():
        assert np.array_equal(v, r[f"params/q2/{k}"]), k
        total += float(np.abs(v.astype(np.float64)).sum())
    assert abs(total - float(r["el/sum_saved"])) / total < 1e-5
    assert abs(total - float(r["el/sum_restored"])) / total < 1e-5
    assert p["el/opt_specs_fsdp"]


def test_build_trainer_on_a_mesh_resumes_and_matches_one_device(port):
    """``build_trainer(mesh=...)`` on the (2, 4) mesh (the reduced qwen2:
    no TP or FSDP by the policy's rules, the optimizer state ZeRO-sharded
    over data): its losses are the single-device loop's, and a loop
    preempted at step 2 resumes from the sharded checkpoint to the same
    losses, bit for bit."""
    p = port[0]
    assert p["loop/resumed_from"] == 2
    assert p["loop/resumed"] == p["loop/sharded"]
    assert np.allclose(p["loop/sharded"], p["loop/single"], rtol=1e-5,
                       atol=0)


def test_mesh_size_must_be_the_worlds():
    from repro_torch.distributed import spawn
    msgs = spawn(ranks.mesh_size_mismatch, 2, timeout=120)
    assert all(m is not None and "needs 4 ranks" in m for m in msgs)


def test_build_trainer_with_a_mesh_needs_a_card_or_cpu(monkeypatch):
    from repro_torch.distributed import Mesh
    from repro_torch.launch.train import build_trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = Mesh(shape={"data": 1, "model": 1}, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_trainer("qwen2-7b", mesh=mesh)


def test_int8_roundtrip_equals_the_references():
    rng = np.random.default_rng(0)
    for shape in [(1000,), (3, 257), (16, 16), (7,)]:
        g = (rng.normal(size=shape) * rng.uniform(1e-3, 10)).astype(
            np.float32)
        want_hat, want_res = map(np.asarray, ref_roundtrip(jnp.asarray(g)))
        got_hat, got_res = int8_compress_decompress(torch.from_numpy(g))
        assert np.array_equal(got_hat.numpy(), want_hat), shape
        assert np.array_equal(got_res.numpy(), want_res), shape


def test_error_feedback_three_steps_equals_the_references():
    rng = np.random.default_rng(1)
    shapes = {"a": (300,), "b": {"c": (4, 130)}}
    leaves = lambda t: [t["a"], t["b"]["c"]]
    r_init, r_apply = ref_error_feedback()
    p_init, p_apply = make_error_feedback()
    zeros = {"a": np.zeros(300, np.float32),
             "b": {"c": np.zeros((4, 130), np.float32)}}
    r_ef = r_init(jax.tree.map(jnp.asarray, zeros))
    p_ef = p_init({"a": torch.zeros(300), "b": {"c": torch.zeros(4, 130)}})
    for _ in range(3):
        g = {"a": rng.normal(size=shapes["a"]).astype(np.float32),
             "b": {"c": rng.normal(size=shapes["b"]["c"]).astype(
                 np.float32)}}
        r_hat, r_ef = r_apply(jax.tree.map(jnp.asarray, g), r_ef)
        p_hat, p_ef = p_apply({"a": torch.from_numpy(g["a"]),
                               "b": {"c": torch.from_numpy(g["b"]["c"])}},
                              p_ef)
        for x, y in zip(leaves(p_hat), leaves(r_hat)):
            assert np.array_equal(x.numpy(), np.asarray(y))
        for x, y in zip(leaves(p_ef), leaves(r_ef)):
            assert np.array_equal(x.numpy(), np.asarray(y))


def test_decode_plain_version_at_zero_length():
    """The plain decode gives, for a lane of length 0, what the kernel
    gives: out 0, m = -1e30, l = 0; the other lanes are untouched."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 4, 64, generator=g)
    k = torch.randn(3, 8, 2, 64, generator=g)
    v = torch.randn(3, 8, 2, 64, generator=g)
    lengths = torch.tensor([0, 5, 8], dtype=torch.int32)
    out, m, l = decode_attention_ref(q, k, v, lengths, return_lse=True)
    assert torch.all(out[0] == 0) and torch.all(m[0] == -1e30) and \
        torch.all(l[0] == 0)
    assert torch.isfinite(out).all()
    alone, m1, l1 = decode_attention_ref(q[1:], k[1:], v[1:], lengths[1:],
                                         return_lse=True)
    assert torch.equal(out[1:], alone) and torch.equal(m[1:], m1) and \
        torch.equal(l[1:], l1)


def test_decode_plain_version_equals_jax_where_every_length_is_positive():
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as jax_ref
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 32)).astype(np.float32)
    lengths = np.array([1, 9], np.int32)
    want = np.asarray(jax_ref(*map(jnp.asarray, (q, k, v, lengths))))
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v, lengths)))
    assert np.abs(got.numpy() - want).max() < 1e-6


def test_collective_spec_json_round_trip():
    """Specs print and compare as tuples (what the JSON reports hold)."""
    from repro_torch.distributed.policy import PartitionSpec
    spec = PartitionSpec(None, ("data", "model"))
    assert json.loads(json.dumps(spec)) == [None, ["data", "model"]]
    assert spec == (None, ("data", "model"))
