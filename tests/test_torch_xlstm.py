"""The port's ssm family (xlstm: mLSTM blocks on the SSD scan at N = d_head,
P = d_head + 1, and sLSTM blocks) against the JAX package's, on the CPU,
with JAX's parameters carried across by ``params_from_numpy``.

Two sizes: the reduced xlstm-1.3b (float32, 4 blocks in 2 segments of one
mLSTM and one sLSTM, d_model 128, 4 heads of 32) for the whole model, and
xlstm's real head shape (d_model 2048, 4 heads of 512: the SSD scan at
N 512, P 513) for single blocks.  JAX's ``init_params`` makes the norm
weights one and the sLSTM bias zero; both are drawn at random here so that
each enters the comparison.  Tolerances are ``TOLERANCES["xlstm/…"]`` and
``TOLERANCES["ssd_wide/…"]`` in ``repro_torch.kernels.common``, each with
its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.common import force_backend
from repro.kernels.ssd.kernel import ssd_scan_pallas
from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_decode_state as jax_init_decode_state
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import xlstm as jax_xlstm
from repro.models.model import _mlstm_params as jax_mlstm_params
from repro.models.model import _slstm_params as jax_slstm_params
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.common import TOLERANCES, launches
from repro_torch.kernels.ssd.kernel import padded_like, ssd_launch_args
from repro_torch.launch.serve import serve_demo
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, params_from_numpy, prefill)
from repro_torch.models import xlstm

ARCH = "xlstm-1.3b"


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


def _wide_cfgs():
    """xlstm-1.3b's real widths in float32 (d_model 2048, 4 heads of 512),
    for one block at a time."""
    over = dict(dtype="float32", remat=False)
    jcfg = dataclasses.replace(get_config(ARCH), **over)
    tcfg = dataclasses.replace(t_get_config(ARCH), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _rand_norm(node, rng):
    node["w"] = (1 + 0.1 * rng.normal(size=node["w"].shape)).astype(
        np.float32)


def _randomize(tree, rng):
    """Every norm weight and the sLSTM bias drawn at random, in place in
    the numpy tree."""
    for part in (tree["mlstm"], tree["slstm"]):
        _rand_norm(part["norm"], rng)
    tree["slstm"]["b"] = (0.5 * rng.normal(
        size=tree["slstm"]["b"].shape)).astype(np.float32)
    _rand_norm(tree["final_norm"], rng)
    return tree


def _params(jcfg, seed=0):
    """(jax tree, numpy tree) with the random entries of _randomize."""
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    tree = _randomize(tree, np.random.default_rng(seed))
    return jax.tree.map(jnp.asarray, tree), tree


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jp, npt = _params(jcfg)
    return jcfg, tcfg, jp, params_from_numpy(npt, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the SSD scan at xlstm's shape
# ---------------------------------------------------------------------------

def _mlstm_like_inputs(B, H, S, N=512, P=513, seed=0):
    """c = q·N**-0.5, b = k (unit normals), x = v with a last column of
    ones, log_a = log σ(f + 3) and gate = σ(i), as the mLSTM block hands
    them to the scan at init (b_gates 0 and 3)."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(B, H, S, N)) * N ** -0.5).astype(np.float32)
    b = rng.normal(size=(B, H, S, N)).astype(np.float32)
    x = rng.normal(size=(B, H, S, P)).astype(np.float32)
    x[..., -1] = 1.0
    f = rng.normal(size=(B, H, S)) + 3.0
    i = rng.normal(size=(B, H, S))
    log_a = (-np.log1p(np.exp(-f))).astype(np.float32)
    gate = (1 / (1 + np.exp(-i))).astype(np.float32)
    return c, b, x, log_a, gate


def test_ssd_scan_wide_matches_jax_pallas_and_ref():
    args = _mlstm_like_inputs(1, 1, 256)
    y, s = ssd_scan(*map(torch.from_numpy, args))
    assert y.shape == (1, 1, 256, 513) and s.shape == (1, 1, 512, 513)
    jargs = tuple(map(jnp.asarray, args))
    for want_y, want_s in (jax_ssd_ref(*jargs),
                           ssd_scan_pallas(*jargs, interpret=True)):
        _close(y, want_y, "ssd_wide/cpu_fp32")
        _close(s, want_s, "ssd_wide/cpu_fp32")


def test_ssd_scan_wide_ragged_matches_jax_padded_scan():
    """At S = 200 JAX's ssd_scan pads to 256 with zeros and runs the Pallas
    kernel (in interpret mode here); the port's plain version needs no
    padding."""
    args = _mlstm_like_inputs(1, 1, 200, seed=1)
    force_backend("pallas-interpret")
    try:
        want_y, want_s = jax_ssd_scan(*map(jnp.asarray, args))
    finally:
        force_backend(None)
    y, s = ssd_scan(*map(torch.from_numpy, args))
    assert y.shape == (1, 1, 200, 513)
    _close(y, want_y, "ssd_wide/cpu_fp32")
    _close(s, want_s, "ssd_wide/cpu_fp32")


def test_ssd_launch_args_take_the_mlstm_views():
    """The mLSTM block's views: q and k (B, H, S, 512) through the strides
    of their (B, S, H, 512) layout, v with its ones column a (B, H, S, 513)
    view of a (B, S, H, 520) buffer, and y allocated the same way."""
    B, S, H, dh = 2, 40, 4, 512
    bf = torch.bfloat16
    qk = torch.zeros(B, S, H, dh, dtype=bf)
    v_aug = xlstm._ones_augmented(torch.zeros(B, S, H, dh, dtype=bf))
    assert v_aug.shape == (B, S, H, dh + 1) and v_aug.stride(2) == 520
    assert bool((v_aug[..., dh] == 1).all())
    xh = v_aug.transpose(1, 2)
    y = padded_like(xh)
    assert y.shape == xh.shape and y.stride() == xh.stride()
    gates = torch.zeros(B, S, H).transpose(1, 2)
    args = ssd_launch_args(qk.transpose(1, 2), qk.transpose(1, 2), xh,
                           gates, gates, y)
    assert args[:5] == (B, H, S, dh, dh + 1)
    assert args[5:8] == (S * H * dh, dh, H * dh)          # c (b, h, s)
    assert args[11:14] == (S * H * 520, 520, H * 520)     # x
    assert args[14:17] == (S * H * 520, 520, H * 520)     # y


def test_ssd_launch_args_refuse_a_row_of_513():
    """A dense (B, H, S, 513) x has rows 1,026 bytes apart: not 16-byte
    aligned, so the wrapper refuses it and says how to lay it out."""
    B, H, S = 1, 2, 8
    bf = torch.bfloat16
    c = torch.zeros(B, H, S, 512, dtype=bf)
    x = torch.zeros(B, H, S, 513, dtype=bf)
    la = torch.zeros(B, H, S)
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        ssd_launch_args(c, c, x, la, la, padded_like(x))
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        ssd_launch_args(c, c, padded_like(x), la, la, x)


# ---------------------------------------------------------------------------
# single blocks, at the reduced config and at xlstm's real head shape
# ---------------------------------------------------------------------------

def _block_params(size, seed=0):
    """(jcfg, tcfg, JAX and port mLSTM params, JAX and port sLSTM params)
    of one block, norm weights and the sLSTM bias random."""
    jcfg, tcfg = _cfgs() if size == "reduced" else _wide_cfgs()
    km, ks = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    mp = jax.tree.map(np.asarray, jax_mlstm_params(km, jcfg, jnp.float32))
    sp = jax.tree.map(np.asarray, jax_slstm_params(ks, jcfg, jnp.float32))
    sp["b"] = (0.5 * rng.normal(size=sp["b"].shape)).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, mp), _tree_t(mp),
            jax.tree.map(jnp.asarray, sp), _tree_t(sp))


@pytest.mark.parametrize("size", ["reduced", "d2048"])
def test_mlstm_block_and_decode_step_match_jax(size):
    jcfg, tcfg, jmp, tmp, _, _ = _block_params(size)
    key = f"xlstm/{'block' if size == 'reduced' else 'wide'}_cpu_fp32"
    rng = np.random.default_rng(1)
    B, S = (2, 19) if size == "reduced" else (1, 16)
    x = rng.normal(size=(B, S + 2, jcfg.d_model)).astype(np.float32)

    jo = jax_xlstm.mlstm_block(jmp, jnp.asarray(x[:, :S]), jcfg)
    to = xlstm.mlstm_block(tmp, _t(x[:, :S]), tcfg)
    _close(to, jo, key)
    jo, jst = jax_xlstm.mlstm_block(jmp, jnp.asarray(x[:, :S]), jcfg,
                                    return_state=True)
    to, tst = xlstm.mlstm_block(tmp, _t(x[:, :S]), tcfg, return_state=True)
    H, dh = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    assert tst.shape == (B, H, dh, dh + 1) and tst.dtype == torch.float32
    _close(to, jo, key)
    _close(tst, jst, key)

    for t in range(S, S + 2):               # two steps: the state carries
        xt = x[:, t:t + 1]
        jy, jst = jax_xlstm.mlstm_decode_step(jmp, jnp.asarray(xt), jcfg,
                                              jst)
        before = tst.clone()
        ty, tst_new = xlstm.mlstm_decode_step(tmp, _t(xt), tcfg, tst)
        assert torch.equal(tst, before)     # the input state is not modified
        tst = tst_new
        _close(ty, jy, key)
        _close(tst, jst, key)


@pytest.mark.parametrize("size", ["reduced", "d2048"])
def test_slstm_block_and_decode_step_match_jax(size):
    jcfg, tcfg, _, _, jsp, tsp = _block_params(size, seed=2)
    key = f"xlstm/{'block' if size == 'reduced' else 'wide'}_cpu_fp32"
    rng = np.random.default_rng(3)
    B, S = (2, 19) if size == "reduced" else (1, 16)
    x = rng.normal(size=(B, S + 2, jcfg.d_model)).astype(np.float32)

    jo = jax_xlstm.slstm_block(jsp, jnp.asarray(x[:, :S]), jcfg)
    _close(xlstm.slstm_block(tsp, _t(x[:, :S]), tcfg), jo, key)
    jo, jst = jax_xlstm.slstm_block(jsp, jnp.asarray(x[:, :S]), jcfg,
                                    return_state=True)
    to, tst = xlstm.slstm_block(tsp, _t(x[:, :S]), tcfg, return_state=True)
    _close(to, jo, key)
    assert len(tst) == 4
    for a, b in zip(tst, jst):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(a, b, key)

    for t in range(S, S + 2):
        xt = x[:, t:t + 1]
        jy, jst = jax_xlstm.slstm_decode_step(jsp, jnp.asarray(xt), jcfg,
                                              jst)
        ty, tst = xlstm.slstm_decode_step(tsp, _t(xt), tcfg, tst)
        _close(ty, jy, key)
        for a, b in zip(tst, jst):
            _close(a, b, key)


def test_mlstm_q_scale_rounds_like_jax_in_bf16():
    """JAX casts the Python scalar of ``q * dh ** -0.5`` to q's dtype
    before the product; the port does the same, so bf16 q agrees bit for
    bit (a float32 scale would move ~2% of the values by one ulp)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4096,)).astype(np.float32)
    want = np.asarray((jnp.asarray(q).astype(jnp.bfloat16) * 512 ** -0.5)
                      .astype(jnp.float32))
    qt = torch.from_numpy(q).to(torch.bfloat16)
    got = (qt * xlstm._q_scale(512, qt.dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert xlstm._q_scale(512, torch.float32) == np.float32(512 ** -0.5)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "pallas-interpret"])
def test_xlstm_forward_matches_jax(setup, backend):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (2, 21)).astype(np.int32)
    force_backend(backend)
    try:
        jh, _ = jax_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    finally:
        force_backend(None)
    th, _ = forward(tp, {"tokens": _t(toks)}, tcfg)
    _close(th, jh, "xlstm/model_cpu_fp32")


def test_xlstm_prefill_and_decode_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    key = "xlstm/model_cpu_fp32"
    rng = np.random.default_rng(3)
    B, S, max_len = 2, 13, 20
    toks = rng.integers(0, jcfg.vocab, (B, S + 2)).astype(np.int32)

    jl, js = jax_prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                         max_len=max_len)
    tl, ts = prefill(tp, {"tokens": _t(toks[:, :S])}, tcfg, max_len=max_len)

    def same_state(ts, js):
        assert sorted(ts) == sorted(js) == ["len", "mlstm", "slstm"]
        np.testing.assert_array_equal(ts["len"].numpy(),
                                      np.asarray(js["len"]))
        assert ts["mlstm"].shape == js["mlstm"].shape
        _close(ts["mlstm"], js["mlstm"], key)
        for a, b in zip(ts["slstm"], js["slstm"]):
            assert a.shape == b.shape
            _close(a, b, key)

    _close(tl, jl, key)
    same_state(ts, js)
    for step in range(2):                   # two steps: the state carries
        tok = toks[:, S + step:S + step + 1]
        jl, js = jax_decode_step(jp, js, jnp.asarray(tok), jcfg)
        mem, h = ts["mlstm"], ts["slstm"][0]
        tl, ts = decode_step(tp, ts, _t(tok), tcfg)
        # updated in place: the new state shares the old buffers
        assert ts["mlstm"] is mem and ts["slstm"][0] is h
        _close(tl, jl, key)
        same_state(ts, js)


def test_xlstm_decode_consistency_with_forward():
    """Teacher-forced decode reproduces the full forward's next-token
    logits (the port's twin of tests/test_models.py's check), at float32's
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
    _close(dec, full, "xlstm/model_cpu_fp32")
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_xlstm_init_params_and_decode_state_match_jax_tree():
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
        else:                               # the constant leaves are equal
            np.testing.assert_array_equal(a, b)
    js = jax.tree.map(np.asarray, jax_init_decode_state(jcfg, 3, 10))
    ts = init_decode_state(tcfg, 3, 10, device="cpu")
    flat_js = jax.tree_util.tree_flatten_with_path(js)[0]
    flat_ts = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), ts, is_leaf=leaf))[0]
    assert [(p, a.shape, a.dtype) for p, a in flat_js] == \
        [(p, a.shape, a.dtype) for p, a in flat_ts]
    for (path, a), (_, b) in zip(flat_js, flat_ts):
        np.testing.assert_array_equal(a, b)   # zeros, and m = -1e30


def test_xlstm_params_from_numpy_keeps_layout_and_checks_segments():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    tp = params_from_numpy(tree, tcfg, device="cpu")
    D = tcfg.d_model
    assert tp["mlstm"]["w_up"].dtype == torch.bfloat16
    assert tp["mlstm"]["w_up"].shape == (2, 1, D, 2 * D)        # (in, out)
    np.testing.assert_array_equal(tp["mlstm"]["w_q"].float().numpy(),
                                  tree["mlstm"]["w_q"].astype(np.float32))
    assert tp["mlstm"]["w_gates"].dtype == torch.float32
    assert tp["slstm"]["r"].dtype == torch.float32
    assert tp["slstm"]["r"].shape == (2, 4, D // 4, D)
    for over in (dict(n_layers=6), dict(slstm_period=4, n_layers=4),
                 dict(n_layers=2, slstm_period=1)):
        with pytest.raises(ValueError, match="LSTM blocks"):
            params_from_numpy(tree, dataclasses.replace(tcfg, **over),
                              device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serve_demo_xlstm_serves_every_request_like_jax():
    """``serve_demo("xlstm-1.3b", device="cpu")`` serves the reduced
    config's requests with the counts of JAX's ``serve_demo``."""
    kw = dict(n_requests=5, n_lanes=2, prompt_len=8, max_new=4, max_len=16)
    before = launches()
    got = serve_demo(ARCH, device="cpu", seed=3, **kw)
    assert launches() == before          # the plain versions: no launch
    want = jax_serve_demo(ARCH, seed=3, **kw)
    for key in ("requests", "decode_steps", "tokens"):
        assert got[key] == want[key], key
    assert got["requests"] == 5 and got["tokens"] == 20
    assert len(got["prefill_s"]) == 3                    # waves of 2, 2, 1
