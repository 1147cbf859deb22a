"""The port's dense model (``repro_torch.models``) against the JAX package's
(``repro.models``) on the CPU, with JAX's parameters carried across by
``params_from_numpy``; then the vlm and audio families (the same layer stack
fed by precomputed embeddings) at their reduced configs.

The config is the reduced qwen2-7b (float32, 2 layers, d_model 128, 4 q
heads over 2 kv heads).  JAX's ``init_params`` makes the QKV biases zero and
the norm weights one; both are replaced by random values here so the bias
adds and norm scales are tested too.  Tolerance: float32 with the same
arithmetic in another order, through two layers — 1e-4 absolute and
relative (observed errors are ~1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.model import loss_fn as jax_loss_fn
from repro.models.layers import attention_block as jax_attention_block
from repro.models.layers import attention_decode as jax_attention_decode
from repro.models.layers import rope as jax_rope
from repro.serve.step import make_decode_step as jax_make_decode_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.common import TOLERANCES
from repro_torch.launch import check_card_config
from repro_torch.models import (decode_step, forward, init_params, loss_fn,
                                params_from_numpy, prefill)
from repro_torch.models.layers import attention_block, attention_decode, rope
from repro_torch.serve.step import make_decode_step

TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch="qwen2-7b", **over):
    jcfg = dataclasses.replace(reduced(get_config(arch)), **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    """JAX params with random biases and norm weights, as (jax tree,
    numpy tree)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    lay = tree["layers"]
    for name in ("bq", "bk", "bv") if jcfg.qkv_bias else ():
        lay["attn"][name] = rng.normal(
            size=lay["attn"][name].shape).astype(np.float32) * 0.1
    for norm in ("attn_norm", "mlp_norm"):
        lay[norm]["w"] = (1 + 0.1 * rng.normal(
            size=lay[norm]["w"].shape)).astype(np.float32)
    tree["final_norm"]["w"] = (1 + 0.1 * rng.normal(
        size=tree["final_norm"]["w"].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), tree


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp, npt = _params(jcfg)
    return jcfg, tcfg, jp, params_from_numpy(npt, tcfg, device="cpu")


def test_init_params_tree_matches_jax_shapes_and_dtypes():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    tp = init_params(tcfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        # same scales: std within 20% of JAX's for every weight matrix
        if a.ndim >= 2 and a.std() > 0:
            assert 0.8 < b.std() / a.std() < 1.25, path


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        rope(_t(x), _t(pos), 1e6).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), **TOL)


def test_attention_block_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(2)
    B, S = 2, 19
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jo, jk, jv = jax_attention_block(_layer0(jp["layers"])["attn"],
                                     jnp.asarray(x), jcfg, jnp.asarray(pos))
    lp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    to, tk, tv = attention_block(lp, _t(x), tcfg, _t(pos))
    for a, b in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_attention_decode_matches_jax_including_dropped_write(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(3)
    B, S_max = 3, 16
    dh, hkv = jcfg.d_head, jcfg.n_kv_heads
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(B, S_max, hkv, dh)).astype(np.float32)
    vc = rng.normal(size=(B, S_max, hkv, dh)).astype(np.float32)
    # lane 1 is full: JAX drops its write (mode="drop") and attends over
    # all S_max rows
    cache_len = np.asarray([5, S_max, 0], np.int32)
    jo, jk, jv = jax_attention_decode(
        _layer0(jp["layers"])["attn"], jnp.asarray(x), jcfg, jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(cache_len))
    lp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    tkc, tvc = _t(kc), _t(vc)
    to, tk, tv = attention_decode(lp, _t(x), tcfg, tkc, tvc, _t(cache_len))
    assert tk is tkc and tv is tvc                    # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(tk[1].numpy(), kc[1])   # full lane kept
    assert not np.allclose(tk[0, 5].numpy(), kc[0, 5])    # lane 0 written


def _forward_prefill_decode_match(jcfg, tcfg, jp, tp, seed):
    rng = np.random.default_rng(seed)
    B, S, max_len = 2, 13, 20
    toks = rng.integers(0, jcfg.vocab, (B, S + 2)).astype(np.int32)

    jh, jkv = jax_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                          collect=True)
    th, tkv = forward(tp, {"tokens": _t(toks)}, tcfg, collect=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for i, (k, v) in enumerate(tkv):
        np.testing.assert_allclose(k.numpy(), np.asarray(jkv[0][i]), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jkv[1][i]), **TOL)

    jl, js = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                         max_len=max_len)
    tl, ts = prefill(tp, {"tokens": _t(toks[:, :S])}, tcfg, max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts["len"].numpy(), np.asarray(js["len"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(ts["kv"][name].numpy(),
                                   np.asarray(js["kv"][name]), **TOL)

    for step in range(2):                   # two steps: the state carries
        tok = toks[:, S + step:S + step + 1]
        jl, js = jax_decode_step(jp, js, jnp.asarray(tok), jcfg)
        tl, ts = decode_step(tp, ts, _t(tok), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(ts["len"].numpy(),
                                      np.asarray(js["len"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(ts["kv"][name].numpy(),
                                       np.asarray(js["kv"][name]), **TOL)


def test_forward_prefill_decode_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    _forward_prefill_decode_match(jcfg, tcfg, jp, tp, seed=4)


# The reduced configs of the dense archs whose attention shapes the kernels
# took last, narrowed but keeping the heads that matter: starcoder2-15b's
# group of 12 (with its gelu MLP and q/k/v biases), llama3-405b's group of
# 16, nemotron-4-340b's head dim 192 (with its squared-ReLU MLP).
NEW_SHAPES = {
    "starcoder2-15b": (dict(d_model=384, n_heads=12, n_kv_heads=1),
                       12, 32, "gelu"),
    "llama3-405b": (dict(d_model=256, n_heads=16, n_kv_heads=1),
                    16, 16, "swiglu"),
    "nemotron-4-340b": (dict(d_model=384, n_heads=2, n_kv_heads=1),
                        2, 192, "relu2"),
}


@pytest.mark.parametrize("arch", list(NEW_SHAPES))
def test_new_attention_shapes_forward_prefill_decode_match_jax(arch):
    over, group, d_head, act = NEW_SHAPES[arch]
    jcfg, tcfg = _cfgs(arch, **over)
    assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.d_head, tcfg.act) == \
        (group, d_head, act)
    assert tcfg.qkv_bias == (arch == "starcoder2-15b")
    jp, npt = _params(jcfg, seed=8)
    tp = params_from_numpy(npt, tcfg, device="cpu")
    _forward_prefill_decode_match(jcfg, tcfg, jp, tp, seed=9)


def test_decode_step_masks_padded_vocab_like_jax():
    jcfg, tcfg = _cfgs(vocab=500)            # vocab_padded 512
    assert tcfg.vocab_padded == 512
    jp, npt = _params(jcfg, seed=5)
    tp = params_from_numpy(npt, tcfg, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 500, (3, 7)).astype(np.int32)
    _, js = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :6])}, jcfg,
                        max_len=10)
    _, ts = prefill(tp, {"tokens": _t(toks[:, :6])}, tcfg, max_len=10)
    jn, jl, _ = jax_make_decode_step(jcfg)(jp, js, jnp.asarray(toks[:, 6:]))
    tn, tl, _ = make_decode_step(tcfg)(tp, ts, _t(toks[:, 6:]))
    assert torch.isinf(tl[:, 500:]).all() and (tl[:, 500:] < 0).all()
    np.testing.assert_allclose(tl[:, :500].numpy(), np.asarray(jl)[:, :500],
                               **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (tn < 500).all()


def test_decode_consistency_with_forward():
    """Teacher-forced decode reproduces the full forward's next-token logits
    (the port's twin of tests/test_models.py's check), at float32's
    precision rather than the 2e-2 that check allows."""
    _, tcfg = _cfgs()
    tp = init_params(tcfg, torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(6)
    B, S = 2, 12
    toks = _t(rng.integers(0, tcfg.vocab, (B, S + 1)).astype(np.int64))
    hidden, _ = forward(tp, {"tokens": toks}, tcfg)
    full = (hidden[:, -1] @ tp["lm_head"]).float()
    _, state = prefill(tp, {"tokens": toks[:, :S]}, tcfg, max_len=S + 4)
    dec, _ = decode_step(tp, state, toks[:, S:S + 1], tcfg)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_params_from_numpy_keeps_layout_and_bf16():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tp = params_from_numpy(tree, tcfg, device="cpu")
    wq = tp["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert wq.shape == (tcfg.n_layers, tcfg.d_model,
                        tcfg.n_heads * tcfg.d_head)           # (in, out)
    np.testing.assert_array_equal(
        wq.float().numpy(), tree["layers"]["attn"]["wq"].astype(np.float32))
    assert tp["layers"]["attn_norm"]["w"].dtype == torch.float32
    with pytest.raises(ValueError):
        params_from_numpy(tree, dataclasses.replace(tcfg, n_layers=3),
                          device="cpu")


# ---------------------------------------------------------------------------
# the vlm and audio families: the dense layer stack fed by precomputed
# embeddings, no embedding table (reduced internvl2-76b: swiglu; reduced
# musicgen-medium: gelu; each 2 layers, d_model 128, 4 q heads over 2 kv
# heads).  Inputs as tests/test_models.py builds them: N(0, 1) embeddings
# (B, S, d_model) and labels drawn from the vocabulary.
# ---------------------------------------------------------------------------

FRONTEND_ARCHS = ["internvl2-76b", "musicgen-medium"]


def _embeds(rng, B, S, D):
    return rng.normal(size=(B, S, D)).astype(np.float32)


@pytest.fixture(scope="module", params=FRONTEND_ARCHS)
def frontend(request):
    jcfg, tcfg = _cfgs(request.param)
    assert tcfg.frontend != "none" and tcfg.family in ("vlm", "audio")
    jp, npt = _params(jcfg, seed=10)
    return jcfg, tcfg, jp, npt


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _paths(v, prefix + k + "/")]
    return [(prefix[:-1], tree)]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_frontend_params_have_no_embedding_table(frontend):
    jcfg, tcfg, _, npt = frontend
    assert "embed" not in npt                       # the JAX package's tree
    tp = params_from_numpy(npt, tcfg, device="cpu")
    assert set(tp) == set(npt) == {"layers", "final_norm", "lm_head"}
    fresh = init_params(tcfg, device="cpu")
    got = {p: (tuple(t.shape), t.dtype) for p, t in _paths(fresh)}
    want = {p: (a.shape, a.dtype) for p, a in _paths(npt)}
    assert sorted(got) == sorted(want)
    for p, (shape, dt) in got.items():
        assert shape == want[p][0] and str(dt)[6:] == str(want[p][1]), p
    table = {"tok": np.zeros((tcfg.vocab_padded, tcfg.d_model), np.float32)}
    with pytest.raises(ValueError, match="has no embedding table"):
        params_from_numpy({"embed": table, **npt}, tcfg, device="cpu")


def test_frontend_forward_prefill_decode_match_jax(frontend):
    jcfg, tcfg, jp, npt = frontend
    tp = params_from_numpy(npt, tcfg, device="cpu")
    rng = np.random.default_rng(11)
    B, S, max_len = 2, 13, 20
    emb = _embeds(rng, B, S + 2, jcfg.d_model)

    jh, jkv = jax_forward(jp, {"embeds": jnp.asarray(emb)}, jcfg,
                          collect=True)
    th, tkv = forward(tp, {"embeds": _t(emb)}, tcfg, collect=True)
    assert th.shape == (B, S + 2, tcfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for i, (k, v) in enumerate(tkv):
        np.testing.assert_allclose(k.numpy(), np.asarray(jkv[0][i]), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jkv[1][i]), **TOL)

    jl, js = jax_prefill(jp, {"embeds": jnp.asarray(emb[:, :S])}, jcfg,
                         max_len=max_len)
    tl, ts = prefill(tp, {"embeds": _t(emb[:, :S])}, tcfg, max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(ts["len"].numpy(), np.asarray(js["len"]))
    for step in range(2):                   # two steps: the state carries
        e = emb[:, S + step:S + step + 1]
        jl, js = jax_decode_step(jp, js, jnp.asarray(e), jcfg)
        tl, ts = decode_step(tp, ts, _t(e), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(ts["kv"][name].numpy(),
                                       np.asarray(js["kv"][name]), **TOL)


def test_frontend_loss_and_every_grad_match_jax(frontend):
    jcfg, tcfg, jp, npt = frontend
    rng = np.random.default_rng(12)
    B, S = 2, 17
    inputs = {"embeds": _embeds(rng, B, S, jcfg.d_model),
              "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    inputs["labels"][:, -3:] = -100               # padding: masked out
    jloss, jgrads = jax.value_and_grad(jax_loss_fn)(
        jp, jax.tree.map(jnp.asarray, inputs), jcfg)
    tp = params_from_numpy(npt, tcfg, device="cpu")
    flat = _paths(tp)
    for _, t in flat:
        t.requires_grad_(True)
    loss = loss_fn(tp, {k: _t(v) for k, v in inputs.items()}, tcfg)
    grads = torch.autograd.grad(loss, [t for _, t in flat])
    atol, rtol = TOLERANCES["model_loss/cpu_fp32"]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=atol,
                               rtol=rtol)
    jg = jax.tree.map(np.asarray, jgrads)
    assert len(flat) == len(jax.tree.leaves(jg))
    atol, rtol = TOLERANCES["model_grad/cpu_fp32"]
    for (path, _), g in zip(flat, grads):
        want = _get(jg, path)
        assert g.shape == want.shape, path
        np.testing.assert_allclose(g.numpy(), want, atol=atol, rtol=rtol,
                                   err_msg=path)


def test_frontend_prefill_decode_match_forward(frontend):
    """Prefill S embeddings, then decode embedding S through the serving
    step, against the forward over S + 1 (the check chip_smoke.py makes at
    full width)."""
    _, tcfg, _, npt = frontend
    tp = params_from_numpy(npt, tcfg, device="cpu")
    rng = np.random.default_rng(13)
    B, S = 2, 12
    emb = _t(_embeds(rng, B, S + 1, tcfg.d_model))
    hidden, _ = forward(tp, {"embeds": emb}, tcfg)
    full = (hidden[:, -1] @ tp["lm_head"]).float()
    _, state = prefill(tp, {"embeds": emb[:, :S]}, tcfg, max_len=S + 4)
    nxt, dec, state = make_decode_step(tcfg)(tp, state, emb[:, S:S + 1])
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)
    assert torch.equal(nxt[:, 0].long(), full.argmax(-1))
    assert state["len"].tolist() == [S + 1] * B


@pytest.mark.parametrize("published", [True, False],
                         ids=["published", "reduced"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_card_config_check_frontend_families(arch, published):
    """On a CUDA device the published configs are taken (internvl2-76b's
    head dim 128 for training too; musicgen-medium's 64 has no flash
    backward) and the reduced ones refused, before any allocation."""
    cfg = t_get_config(arch)
    if published:
        check_card_config(cfg, "cuda")
        if cfg.d_head == 128:
            check_card_config(cfg, "cuda", training=True)
        else:
            with pytest.raises(ValueError, match="flash attention at head "
                                                 f"dim {cfg.d_head}"):
                check_card_config(cfg, "cuda", training=True)
        return
    cfg = t_reduced(cfg)
    for training in (False, True):
        with pytest.raises(ValueError, match="float32 and head dim 32"):
            check_card_config(cfg, "cuda", training=training)
