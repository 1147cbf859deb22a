"""The port's hybrid family (zamba2: Mamba2 layers on the SSD scan, one
shared attention block) against the JAX package's, on the CPU, with JAX's
parameters carried across by ``params_from_numpy``.

The config is the reduced zamba2-1.2b (float32, 5 Mamba2 layers in 2 groups
of 2 plus a tail of 1, the shared block after each group, d_model 128, 8 SSM
heads of 32, state 16).  JAX's ``init_params`` makes dt_bias and a_log zero
and d_skip and the norm weights one; all of them are replaced by random
values here so that each enters the comparison.  Tolerances are
``TOLERANCES["ssd/…"]`` in ``repro_torch.kernels.common``, each with its
reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.common import force_backend
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.ssm import mamba_block as jax_mamba_block
from repro.models.ssm import mamba_decode_step as jax_mamba_decode_step
from repro.serve.batcher import Batcher as JaxBatcher
from repro.serve.batcher import Request as JaxRequest
from repro.serve.step import make_decode_step as jax_make_decode_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.common import TOLERANCES, launches
from repro_torch.launch.serve import serve_demo, serve_requests
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, params_from_numpy, prefill)
from repro_torch.models.ssm import mamba_block, mamba_decode_step
from repro_torch.serve.batcher import Request

ARCH = "zamba2-1.2b"


def _close(got, want, key):
    atol, rtol = TOLERANCES[key]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _cfgs(**over):
    jcfg = dataclasses.replace(reduced(get_config(ARCH)), **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config(ARCH)), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _randomize(tree, rng):
    """dt_bias, a_log, d_skip and every norm weight drawn at random, in
    place in the numpy tree."""
    for part in [tree["groups"]] + ([tree["tail"]] if "tail" in tree
                                    else []):
        shape = part["dt_bias"].shape
        part["dt_bias"] = rng.normal(size=shape).astype(np.float32) * 0.5
        part["a_log"] = rng.normal(size=shape).astype(np.float32) * 0.5
        part["d_skip"] = (1 + 0.3 * rng.normal(size=shape)).astype(np.float32)
        part["norm"]["w"] = (1 + 0.1 * rng.normal(
            size=part["norm"]["w"].shape)).astype(np.float32)
    for node in (tree["shared_attn"]["attn_norm"],
                 tree["shared_attn"]["mlp_norm"], tree["final_norm"]):
        node["w"] = (1 + 0.1 * rng.normal(size=node["w"].shape)).astype(
            np.float32)
    return tree


def _params(jcfg, seed=0):
    """(jax tree, numpy tree) with the random entries of _randomize."""
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    tree = _randomize(tree, np.random.default_rng(seed))
    return jax.tree.map(jnp.asarray, tree), tree


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp, npt = _params(jcfg)
    return jcfg, tcfg, jp, params_from_numpy(npt, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# one Mamba2 layer
# ---------------------------------------------------------------------------

def test_mamba_block_and_decode_step_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(1)
    B, S = 2, 19
    x = rng.normal(size=(B, S + 3, jcfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0, 0], jp["groups"])
    tlp = jax.tree.map(lambda t: t[0, 0], tp["groups"])
    key = "ssd/mamba_cpu_fp32"

    jo, (jconv, jssd) = jax_mamba_block(jlp, jnp.asarray(x[:, :S]), jcfg,
                                        return_state=True)
    to, (tconv, tssd) = mamba_block(tlp, _t(x[:, :S]), tcfg,
                                    return_state=True)
    assert to.shape == (B, S, jcfg.d_model)
    assert tconv.dtype == torch.float32 and tssd.dtype == torch.float32
    for a, b in ((to, jo), (tconv, jconv), (tssd, jssd)):
        _close(a, b, key)
    assert not np.allclose(tssd.numpy(), 0)

    for t in range(S, S + 3):               # three steps: the state carries
        xt = x[:, t:t + 1]
        jy, jconv, jssd = jax_mamba_decode_step(jlp, jnp.asarray(xt), jcfg,
                                                jconv, jssd)
        before = tssd.clone()
        ty, tconv, tssd_new = mamba_decode_step(tlp, _t(xt), tcfg, tconv,
                                                tssd)
        assert torch.equal(tssd, before)    # the input state is not modified
        tssd = tssd_new
        for a, b in ((ty, jy), (tconv, jconv), (tssd, jssd)):
            _close(a, b, key)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "pallas-interpret"])
def test_hybrid_forward_matches_jax(setup, backend):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (2, 21)).astype(np.int32)
    force_backend(backend)
    try:
        jh, _ = jax_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    finally:
        force_backend(None)
    th, _ = forward(tp, {"tokens": _t(toks)}, tcfg)
    _close(th, jh, "ssd/hybrid_cpu_fp32")


def test_hybrid_prefill_and_decode_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    key = "ssd/hybrid_cpu_fp32"
    rng = np.random.default_rng(3)
    B, S, max_len = 2, 13, 20
    toks = rng.integers(0, jcfg.vocab, (B, S + 2)).astype(np.int32)

    jl, js = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                         max_len=max_len)
    tl, ts = prefill(tp, {"tokens": _t(toks[:, :S])}, tcfg, max_len=max_len)

    def same_state(ts, js):
        assert sorted(ts) == sorted(js) == ["conv", "kv", "len", "ssd"]
        np.testing.assert_array_equal(ts["len"].numpy(),
                                      np.asarray(js["len"]))
        for name in ("conv", "ssd"):
            assert ts[name].shape == js[name].shape, name
            _close(ts[name], js[name], key)
        for name in ("k", "v"):
            assert ts["kv"][name].shape == js["kv"][name].shape, name
            _close(ts["kv"][name], js["kv"][name], key)

    _close(tl, jl, key)
    same_state(ts, js)
    for step in range(2):                   # two steps: the state carries
        tok = toks[:, S + step:S + step + 1]
        jl, js = jax_decode_step(jp, js, jnp.asarray(tok), jcfg)
        conv, ssd, kc = ts["conv"], ts["ssd"], ts["kv"]["k"]
        tl, ts = decode_step(tp, ts, _t(tok), tcfg)
        # updated in place: the new state shares the old buffers
        assert ts["conv"] is conv and ts["ssd"] is ssd and \
            ts["kv"]["k"] is kc
        _close(tl, jl, key)
        same_state(ts, js)


def test_hybrid_decode_consistency_with_forward():
    """Teacher-forced decode reproduces the full forward's next-token logits
    (the port's twin of tests/test_models.py's check), at float32's
    precision rather than the 2e-2 that check allows."""
    _, tcfg = _cfgs()
    tp = init_params(tcfg, torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(4)
    B, S = 2, 12
    toks = _t(rng.integers(0, tcfg.vocab, (B, S + 1)).astype(np.int64))
    hidden, _ = forward(tp, {"tokens": toks}, tcfg)
    full = (hidden[:, -1] @ tp["lm_head"]).float()
    _, state = prefill(tp, {"tokens": toks[:, :S]}, tcfg, max_len=S + 4)
    dec, _ = decode_step(tp, state, toks[:, S:S + 1], tcfg)
    _close(dec, full, "ssd/hybrid_cpu_fp32")
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_hybrid_init_params_and_decode_state_match_jax_tree():
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
    from repro.models import init_decode_state as jax_init_decode_state
    js = jax.tree.map(np.asarray, jax_init_decode_state(jcfg, 3, 10))
    ts = init_decode_state(tcfg, 3, 10, device="cpu")
    flat_js = jax.tree_util.tree_flatten_with_path(js)[0]
    flat_ts = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), ts, is_leaf=leaf))[0]
    assert [(p, a.shape, a.dtype) for p, a in flat_js] == \
        [(p, a.shape, a.dtype) for p, a in flat_ts]


def test_hybrid_params_from_numpy_keeps_layout_and_bf16():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tp = params_from_numpy(tree, tcfg, device="cpu")
    w_in = tp["groups"]["w_in"]
    assert w_in.dtype == torch.bfloat16
    assert w_in.shape == (2, 2, tcfg.d_model, 2 * tcfg.d_inner +
                          2 * tcfg.ssm_state + tcfg.ssm_heads)   # (in, out)
    np.testing.assert_array_equal(w_in.float().numpy(),
                                  tree["groups"]["w_in"].astype(np.float32))
    assert tp["groups"]["w_conv"].dtype == torch.float32
    assert tp["tail"]["w_out"].shape == (1, tcfg.d_inner, tcfg.d_model)
    assert tp["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    for n_layers in (7, 4, 6):     # groups (3, 2); tail 0; groups (3, 2)
        with pytest.raises(ValueError, match="Mamba"):
            params_from_numpy(tree, dataclasses.replace(tcfg,
                                                        n_layers=n_layers),
                              device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_greedy(params, cfg, prompts, *, n_lanes, max_new, max_len):
    """JAX's wave loop of ``repro/launch/serve.py`` over the given prompts;
    returns {rid: generated tokens}."""
    decode = jax.jit(jax_make_decode_step(cfg))
    prefill_fn = jax.jit(lambda p, i: jax_prefill(p, i, cfg,
                                                  max_len=max_len))
    batcher = JaxBatcher(n_lanes=n_lanes, max_len=max_len)
    for rid, prompt in enumerate(prompts):
        batcher.submit(JaxRequest(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new))
    while not batcher.idle:
        wave = batcher.admit()
        batch = np.zeros((n_lanes, prompts.shape[1]), np.int32)
        for lane, req in wave:
            batch[lane] = req.prompt
        logits, state = prefill_fn(params, {"tokens": jnp.asarray(batch)})
        nxt = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        while batcher.active_lanes():
            batcher.record_tokens(nxt[:, 0])
            nxt_j, _, state = decode(params, state, jnp.asarray(nxt))
            nxt = np.asarray(nxt_j)
    return {r.rid: list(r.generated) for r in batcher.finished}


def test_serve_demo_zamba2_serves_every_request_greedy_like_jax():
    """``serve_demo("zamba2-1.2b", device="cpu")`` serves JAX's counts, and
    the same requests on the same parameters (serve_demo's own, drawn from
    its seed) give the token streams of a greedy loop over JAX's
    ``prefill`` / ``decode_step``."""
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
    stats, finished = serve_requests(
        params, tcfg, [Request(rid=i, prompt=p, max_new_tokens=kw["max_new"])
                       for i, p in enumerate(prompts)],
        n_lanes=2, prompt_len=kw["prompt_len"], max_len=kw["max_len"],
        device="cpu")
    assert {r.rid: list(r.generated) for r in finished} == want_tokens
    assert stats["decode_steps"] == got["decode_steps"]
