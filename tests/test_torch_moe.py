"""The port's MoE family (granite, arctic: the routed expert FFN on the
``moe_gmm`` grouped matmul) against the JAX package's, on the CPU, with
JAX's parameters carried across by ``params_from_numpy``.

* ``moe_gmm``'s plain version against ``moe_gmm_pallas(interpret=True)``,
  ``moe_gmm_ref`` and the equal-groups einsum, at the JAX sweep's shapes
  (ragged and empty experts included), fp32 and bf16.
* ``moe_ffn`` against JAX's at the reduced granite (8 experts padded to 16,
  top-2, d_model 128), with and without dropped assignments, and at the
  reduced arctic (the dense residual branch).  A routing guard asserts that
  the k-th and (k+1)-th router logits of every token differ by more than
  the two packages' logits do, so a top-k flip cannot pass or fail a
  comparison by luck.
* The reduced granite model: forward, prefill and decode steps (logits and
  caches), its parameter tree, and greedy serving.

Tolerances are ``TOLERANCES["moe_gmm/…"]`` and ``TOLERANCES["moe/…"]`` in
``repro_torch.kernels.common``, each with its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.common import force_backend
from repro.kernels.moe_gmm.kernel import moe_gmm_pallas
from repro.kernels.moe_gmm.ops import moe_gmm as jax_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_decode_state as jax_init_decode_state
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import moe_gmm
from repro_torch.kernels.common import TOLERANCES, launches
from repro_torch.kernels.moe_gmm.kernel import (gmm_design, gmm_launch_args,
                                                moe_gmm_cuda)
from repro_torch.launch.serve import serve_demo, serve_requests
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, moe, params_from_numpy, prefill)
from repro_torch.serve.batcher import Request
from test_torch_hybrid import _jax_greedy

ARCH = "granite-moe-3b-a800m"
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, key):
    atol, rtol = TOLERANCES[key]
    got, want = (a.float().numpy() if isinstance(a, torch.Tensor) else a
                 for a in (got, want))
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _t(a):
    """numpy (or JAX) array → torch tensor, bf16 kept."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _cfgs(arch=ARCH, **over):
    jcfg = dataclasses.replace(reduced(get_config(arch)), **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _tree(jcfg, seed=0):
    """JAX's params with random norm weights, as a numpy tree."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    for node in (tree["layers"]["attn_norm"], tree["layers"]["mlp_norm"],
                 tree["final_norm"]):
        node["w"] = (1 + 0.1 * rng.normal(size=node["w"].shape)).astype(
            np.float32)
    return tree


# ---------------------------------------------------------------------------
# the grouped matmul
# ---------------------------------------------------------------------------

# tests/test_kernels.py's sweep (T, D, E, F, Pallas block_t, block_f), the
# sizes drawn the same way, and its empty-experts case
GMM_CASES = [
    (512, 64, 8, 128, 128, 64, None), (256, 32, 4, 64, 64, 64, None),
    (130, 32, 5, 48, 64, 48, None),                       # ragged sizes
    (128, 32, 4, 64, 64, 64, [0, 100, 0, 28]),            # empty experts
]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("T,D,E,F,bt,bf,sizes", GMM_CASES)
def test_moe_gmm_matches_pallas_and_ref(T, D, E, F, bt, bf, sizes, dtype):
    rng = np.random.default_rng(T + E)
    jdt, tdt = DTYPES[dtype]
    if sizes is None:
        sizes = rng.multinomial(T, [1 / E] * E)
    sizes = np.asarray(sizes, np.int32)
    x = jnp.asarray(rng.normal(size=(T, D)).astype(np.float32), jdt)
    w = jnp.asarray(rng.normal(size=(E, D, F)).astype(np.float32), jdt)
    want_pallas = moe_gmm_pallas(x, w, jnp.asarray(sizes), interpret=True,
                                 block_t=bt, block_f=bf)
    want_ref = jax_moe_gmm_ref(x, w, jnp.asarray(sizes))
    before = launches()
    got = moe_gmm(_t(x), _t(w), torch.from_numpy(sizes))
    assert launches() == before              # the plain version: no launch
    assert got.dtype == tdt and got.shape == (T, F)
    key = f"moe_gmm/cpu_{dtype}"
    _close(got, want_pallas, key)
    _close(got, want_ref, key)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_gmm_equal_groups_matches_jax(dtype):
    rng = np.random.default_rng(3)
    jdt, _ = DTYPES[dtype]
    E, C, D, F = 6, 5, 32, 48
    x = jnp.asarray(rng.normal(size=(E * C, D)).astype(np.float32), jdt)
    w = jnp.asarray(rng.normal(size=(E, D, F)).astype(np.float32), jdt)
    sizes = np.full((E,), C, np.int32)
    force_backend("reference")
    try:
        want = jax_moe_gmm(x, w, jnp.asarray(sizes), equal_groups=C)
    finally:
        force_backend(None)
    got = moe_gmm(_t(x), _t(w), torch.from_numpy(sizes), equal_groups=C)
    _close(got, want, f"moe_gmm/cpu_{dtype}")
    # the batched path and the loop over the experts' rows agree
    _close(got, moe_gmm(_t(x), _t(w), torch.from_numpy(sizes)),
           f"moe_gmm/cpu_{dtype}")


def test_moe_gmm_rows_past_the_groups_are_zero_as_in_the_tpu_kernel():
    """sum(group_sizes) < T: the TPU kernel leaves those rows zero (its
    output tile is zeroed at expert 0); JAX's ``moe_gmm_ref`` gives them the
    last expert's product instead.  The port follows the kernel."""
    rng = np.random.default_rng(4)
    T, D, E, F = 100, 32, 3, 64
    sizes = np.array([30, 0, 40], np.int32)              # 70 of 100 rows
    x = rng.normal(size=(T, D)).astype(np.float32)
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    want = moe_gmm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
                          interpret=True, block_t=64, block_f=64)
    got = moe_gmm(_t(x), _t(w), torch.from_numpy(sizes))
    _close(got, want, "moe_gmm/cpu_fp32")
    assert not got[70:].any()
    assert np.asarray(jax_moe_gmm_ref(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(sizes)))[70:].any()


@pytest.mark.parametrize("bad", ["fp32", "sizes_dtype", "n_sizes", "depth",
                                 "width", "strided", "experts", "empty"])
def test_gmm_launch_args_refuse_what_the_kernel_does_not_take(bad):
    T, D, E, F = 96, 64, 48, 128
    x = torch.zeros(T, D, dtype=torch.bfloat16)
    w = torch.zeros(E, D, F, dtype=torch.bfloat16)
    sizes = torch.full((E,), 2, dtype=torch.int32)
    out = torch.empty(T, F, dtype=torch.bfloat16)
    assert gmm_launch_args(x, w, sizes, out) == (T, D, F, E)
    if bad == "fp32":
        x = x.float()
    elif bad == "sizes_dtype":
        sizes = sizes.long()
    elif bad == "n_sizes":
        sizes = sizes[:-1]
    elif bad == "depth":
        w = w[:, :-4]
    elif bad == "width":
        w, out = w[..., :-4].contiguous(), out[:, :-4]
    elif bad == "strided":
        x = torch.zeros(D, T, dtype=torch.bfloat16).t()
    elif bad == "experts":
        w = torch.zeros(513, D, 8, dtype=torch.bfloat16)
        sizes = torch.zeros(513, dtype=torch.int32)
        out = torch.empty(T, 8, dtype=torch.bfloat16)
    else:
        x, out = x[:0], out[:0]
    with pytest.raises((ValueError, TypeError)):
        gmm_launch_args(x, w, sizes, out)


@pytest.mark.parametrize("T, E, design", [
    (48 * 2048, 48, "prefill"),      # granite's prefill wave (C 2048)
    (48 * 2, 48, "decode"),          # granite's decode step (C 2)
    (16 * 48, 48, "decode"),         # the boundary: 16 rows an expert
    (16 * 48 + 1, 48, "prefill"),
    (700, 48, "decode"),             # one expert may hold 300 of them
    (1, 1, "decode"),
    (17, 1, "prefill")])
def test_moe_gmm_design_is_picked_from_the_shapes(T, E, design):
    """The kernel's design follows from (T, E), which the host knows; the
    group sizes stay on the device and never enter the pick."""
    assert gmm_design(T, E) == design


def test_moe_gmm_cuda_refuses_an_unknown_design_before_building():
    T, D, E, F = 96, 64, 48, 128
    x = torch.zeros(T, D, dtype=torch.bfloat16)
    w = torch.zeros(E, D, F, dtype=torch.bfloat16)
    sizes = torch.full((E,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="design"):
        moe_gmm_cuda(x, w, sizes, design="wide")


def test_moe_gmm_raises_off_cpu_and_cuda():
    x = torch.zeros(4, 8, device="meta")
    w = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        moe_gmm(x, w, torch.zeros(2, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# one MoE FFN
# ---------------------------------------------------------------------------

def _assert_routing_is_decided(jp, tp, x, cfg):
    """The k-th and (k+1)-th router logits of every token differ by more
    than the JAX and port logits differ anywhere."""
    jl = np.asarray(jnp.asarray(x, jnp.float32) @ jnp.asarray(jp["router"]))
    tl = (_t(x).float() @ tp["router"].float()).numpy()
    jl, tl = jl[:, :cfg.n_experts], tl[:, :cfg.n_experts]
    srt = -np.sort(-jl, axis=-1)
    gap = (srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]).min()
    assert gap > np.abs(jl - tl).max(), (gap, np.abs(jl - tl).max())


def _run_ffn(jcfg, tcfg, x, seed=0):
    """(JAX out, port out, port routing stats) of layer 0's MoE FFN."""
    tree = _tree(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["moe"])
    tp = jax.tree.map(lambda a: a[0],
                      params_from_numpy(tree, tcfg, device="cpu")
                      ["layers"]["moe"],
                      is_leaf=lambda t: isinstance(t, torch.Tensor))
    xj = jnp.asarray(x, jnp.dtype(jcfg.dtype))
    _assert_routing_is_decided(jp, tp, xj.reshape(-1, x.shape[-1]), jcfg)
    want = jax_moe_ffn(jp, xj, jcfg)
    moe.ROUTING_STATS = []
    try:
        got = moe.moe_ffn(tp, _t(xj), tcfg)
        stats = moe.ROUTING_STATS
    finally:
        moe.ROUTING_STATS = None
    assert got.dtype == _t(xj).dtype and got.shape == x.shape
    return want, got, stats


def _dropped(stats):
    return sum(int((~s["keep"]).sum()) for s in stats)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_ffn_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype="float32" if dtype == "fp32" else "bfloat16")
    x = np.random.default_rng(5).normal(size=(2, 64, 128)).astype(np.float32)
    want, got, stats = _run_ffn(jcfg, tcfg, x)
    assert [s["capacity"] for s in stats] == [40]   # ⌈128·2/8⌉·1.25
    _close(got, want, f"moe/cpu_{dtype}")


def test_moe_ffn_drops_assignments_like_jax():
    """Tokens that all prefer the same experts overflow their capacity
    (C = 5 for 16 tokens, top-2 of 8): assignments past C are dropped in
    token order, in both packages alike."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(1, 1, 128)) +
         0.05 * rng.normal(size=(2, 8, 128))).astype(np.float32)
    want, got, stats = _run_ffn(jcfg, tcfg, x)
    assert stats[0]["capacity"] == 5
    assert _dropped(stats) >= 16                    # 2 experts · 11 over C
    _close(got, want, "moe/cpu_fp32")


def test_moe_dense_residual_matches_jax():
    """arctic's dense MLP beside the experts (reduced: 8 experts top-2)."""
    jcfg, tcfg = _cfgs("arctic-480b")
    assert jcfg.moe_dense_residual
    x = np.random.default_rng(7).normal(size=(2, 24, 128)).astype(np.float32)
    want, got, _ = _run_ffn(jcfg, tcfg, x)
    _close(got, want, "moe/cpu_fp32")


def test_capacity_matches_jax_formula():
    cfg = t_get_config(ARCH)
    assert [moe.capacity(cfg, T) for T in (8192, 8, 2, 1, 1000, 1001)] == \
        [2048, 2, 1, 1, 250, 251]


# ---------------------------------------------------------------------------
# the whole reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    tree = _tree(jcfg)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("backend", ["reference", "pallas-interpret"])
def test_moe_forward_matches_jax(setup, backend):
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 21)).astype(
        np.int32)
    force_backend(backend)
    try:
        jh, _ = jax_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    finally:
        force_backend(None)
    th, _ = forward(tp, {"tokens": _t(toks)}, tcfg)
    _close(th, jh, "moe/model_cpu_fp32")


def test_moe_prefill_and_decode_match_jax(setup):
    """Prefill (C from B·S tokens) and two decode steps (C from B = 3
    tokens: 1, so lanes that share an expert drop) against JAX's."""
    jcfg, tcfg, jp, tp = setup
    key = "moe/model_cpu_fp32"
    rng = np.random.default_rng(9)
    B, S, max_len = 3, 13, 20
    toks = rng.integers(0, jcfg.vocab, (B, S + 2)).astype(np.int32)
    jl, js = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                         max_len=max_len)
    tl, ts = prefill(tp, {"tokens": _t(toks[:, :S])}, tcfg, max_len=max_len)

    def same_state(ts, js):
        assert sorted(ts) == sorted(js) == ["kv", "len"]
        np.testing.assert_array_equal(ts["len"].numpy(),
                                      np.asarray(js["len"]))
        for name in ("k", "v"):
            assert ts["kv"][name].shape == js["kv"][name].shape, name
            _close(ts["kv"][name], js["kv"][name], key)

    _close(tl, jl, key)
    same_state(ts, js)
    moe.ROUTING_STATS = []
    try:
        for step in range(2):
            tok = toks[:, S + step:S + step + 1]
            jl, js = jax_decode_step(jp, js, jnp.asarray(tok), jcfg)
            tl, ts = decode_step(tp, ts, _t(tok), tcfg)
            _close(tl, jl, key)
            same_state(ts, js)
        stats = moe.ROUTING_STATS
    finally:
        moe.ROUTING_STATS = None
    assert [s["capacity"] for s in stats] == [1] * 4   # 2 steps · 2 layers


def test_moe_decode_consistency_with_forward_at_batch_one():
    """Prefill S + decode 1 against forward S + 1 at B = 1.  Each run routes
    its own tokens under its own capacity, so the two agree only where
    neither drops an assignment; as in the JAX package's own check
    (tests/test_models.py), top_k = n_experts makes the routing drop-free
    (C = ⌈T·k/E⌉·1.25 >= T), which the test asserts first."""
    _, tcfg = _cfgs(n_experts=4, top_k=4)
    tp = init_params(tcfg, torch.Generator().manual_seed(2), device="cpu")
    S = 12
    toks = _t(np.random.default_rng(10).integers(0, tcfg.vocab, (1, S + 1))
              .astype(np.int64))
    moe.ROUTING_STATS = []
    try:
        hidden, _ = forward(tp, {"tokens": toks}, tcfg)
        full = (hidden[:, -1] @ tp["lm_head"]).float()
        _, state = prefill(tp, {"tokens": toks[:, :S]}, tcfg,
                           max_len=S + 4)
        dec, _ = decode_step(tp, state, toks[:, S:S + 1], tcfg)
        stats = moe.ROUTING_STATS
    finally:
        moe.ROUTING_STATS = None
    assert [s["capacity"] for s in stats] == [16, 16, 15, 15, 1, 1]
    assert _dropped(stats) == 0
    _close(dec, full, "moe/model_cpu_fp32")
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_moe_init_params_and_decode_state_match_jax_tree():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    tp = init_params(tcfg, device="cpu")
    leaf = lambda x: isinstance(x, torch.Tensor)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp, is_leaf=leaf))[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.ndim >= 2 and a.std() > 0:     # same scales, within 20%
            assert 0.8 < b.std() / a.std() < 1.25, path
        elif a.std() == 0:                  # the constant leaves are equal
            np.testing.assert_array_equal(a, b)
    js = jax.tree.map(np.asarray, jax_init_decode_state(jcfg, 3, 10))
    ts = init_decode_state(tcfg, 3, 10, device="cpu")
    flat_js = jax.tree_util.tree_flatten_with_path(js)[0]
    flat_ts = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), ts, is_leaf=leaf))[0]
    assert [(p, a.shape, a.dtype) for p, a in flat_js] == \
        [(p, a.shape, a.dtype) for p, a in flat_ts]


def test_moe_params_from_numpy_checks_layers_and_experts():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tp = params_from_numpy(tree, tcfg, device="cpu")
    w = tp["layers"]["moe"]["w_gate"]
    assert w.dtype == torch.bfloat16
    assert w.shape == (2, 16, tcfg.d_model, tcfg.d_ff_expert)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        w.float().numpy(), tree["layers"]["moe"]["w_gate"].astype(np.float32))
    for over in (dict(n_layers=3), dict(n_experts=20)):   # 20 pads to 32
        with pytest.raises(ValueError):
            params_from_numpy(tree, dataclasses.replace(tcfg, **over),
                              device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_demo_granite_serves_every_request_greedy_like_jax():
    """``serve_demo("granite-moe-3b-a800m", device="cpu")`` serves JAX's
    counts, and the same requests on the same parameters (serve_demo's own,
    drawn from its seed) give the token streams of a greedy loop over JAX's
    ``prefill`` / ``decode_step``.  Each decode step routes its 2 lanes
    under C = 1, so lanes that pick the same expert drop it in both."""
    kw = dict(n_requests=5, n_lanes=2, prompt_len=8, max_new=4, max_len=16)
    seed = 3
    before = launches()
    got = serve_demo(ARCH, device="cpu", seed=seed, **kw)
    assert launches() == before          # the plain versions: no launch
    want = jax_serve_demo(ARCH, seed=seed, **kw)
    for key in ("requests", "decode_steps", "tokens"):
        assert got[key] == want[key], key
    assert got["requests"] == 5 and got["tokens"] == 20

    jcfg, tcfg = _cfgs()
    params = init_params(tcfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    rng = np.random.default_rng(seed)
    prompts = np.stack([rng.integers(0, tcfg.vocab, kw["prompt_len"])
                        .astype(np.int32) for _ in range(kw["n_requests"])])
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))
    want_tokens = _jax_greedy(jparams, jcfg, prompts, n_lanes=2,
                              max_new=kw["max_new"], max_len=kw["max_len"])
    moe.ROUTING_STATS = []
    try:
        stats, finished = serve_requests(
            params, tcfg,
            [Request(rid=i, prompt=p, max_new_tokens=kw["max_new"])
             for i, p in enumerate(prompts)],
            n_lanes=2, prompt_len=kw["prompt_len"], max_len=kw["max_len"],
            device="cpu")
        routing = moe.ROUTING_STATS
    finally:
        moe.ROUTING_STATS = None
    assert {r.rid: list(r.generated) for r in finished} == want_tokens
    assert stats["decode_steps"] == got["decode_steps"]
    assert _dropped([s for s in routing if s["tokens"] == 2]) > 0
