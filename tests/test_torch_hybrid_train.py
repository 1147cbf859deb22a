"""Training the port's hybrid family (zamba2-1.2b) against the JAX
package's, on the CPU, with JAX's parameters carried across by
``params_from_numpy``.

* ``ssd_bwd_ref``, its chunked twin ``ssd_chunked_bwd_ref`` (the
  decomposition of the backward kernel, at chunk 64 and 16) and autograd
  through ``ssd_scan`` against ``jax.vjp`` of the JAX ``ssd_ref`` (the JAX
  package cannot differentiate its Pallas scan), at N 16 / P 32 and 64 /
  64, S a multiple of 64, ragged and 1, b and c shared by the heads (a
  head dim of 1, and a head stride of 0) and per head, ds_final zero and
  not; the twin against both where l falls by more than 88 a chunk.
* ``ssd_scan`` under autograd on the CPU is exactly the chunked twin, and a
  head dim of 1 gets the twin's gradients summed over the heads.
* The reduced zamba2 (fp32, 5 Mamba2 layers in 2 groups of 2 and a tail of
  1, the shared block after each group, d_model 128, 8 SSD heads of 32,
  state 16): the loss and every gradient against
  ``jax.value_and_grad(loss_fn)``, remat off and on; the remat reruns each
  Mamba2 layer and each application of the shared block; one AdamW step.
* The backward's shape guard (zamba2's 64 / 64 and xlstm's 512 / 513 are
  taken, another shape is refused by name) and the train CLI for the
  reduced zamba2 on the CPU.

Tolerances are ``repro_torch.kernels.common.TOLERANCES`` entries.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim import adamw as j_adamw
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import find_latest
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.common import TOLERANCES
from repro_torch.kernels.ssd.kernel import check_bwd_shape, ssd_scan_bwd_cuda
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import (ssd_bwd_ref, ssd_chunked_bwd_ref,
                                          ssd_ref)
from repro_torch.models import loss_fn, model as t_model, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import make_train_step

ARCH = "zamba2-1.2b"
SRC = Path(__file__).resolve().parents[1] / "src"
GRADS = ("c", "b", "x", "log_a", "gate")


def _close(got, want, key):
    atol, rtol = TOLERANCES[key]
    got, want = (a.detach().float().numpy() if isinstance(a, torch.Tensor)
                 else np.asarray(a, np.float32) for a in (got, want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _cfgs(**over):
    jcfg = dataclasses.replace(reduced(get_config(ARCH)), **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config(ARCH)), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _paths(tree, prefix=""):
    """[(path, leaf)] of a nested dict, insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _paths(v, prefix + k + "/")]
    return [(prefix[:-1], tree)]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _np_params(jcfg, seed=0):
    """JAX's init as a numpy tree, with dt_bias, a_log, d_skip and every
    norm weight drawn at random (JAX's init makes them 0 or 1), so that each
    enters the comparison."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    draw = lambda shape, loc, scale: (
        loc + scale * rng.normal(size=shape)).astype(np.float32)
    for part in (tree["groups"], tree["tail"]):
        shape = part["dt_bias"].shape
        part["dt_bias"] = draw(shape, 0.0, 0.5)
        part["a_log"] = draw(shape, 0.0, 0.5)
        part["d_skip"] = draw(shape, 1.0, 0.3)
        part["norm"]["w"] = draw(part["norm"]["w"].shape, 1.0, 0.1)
    for node in (tree["shared_attn"]["attn_norm"],
                 tree["shared_attn"]["mlp_norm"], tree["final_norm"]):
        node["w"] = draw(node["w"].shape, 1.0, 0.1)
    return tree


def _batch(jcfg, M, mb, S, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (M, mb, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    batch["labels"][..., -3:] = -100              # padding: masked out
    return batch


# ---------------------------------------------------------------------------
# the SSD scan's backward
# ---------------------------------------------------------------------------

def _scan_inputs(N, P, S, shared, seed=0, B=2, H=3, gates="model"):
    """numpy inputs as the Mamba2 block makes them: c and b (B, 1, S, N)
    when shared by the heads, else (B, H, S, N); x (B, H, S, P), its last
    column ones where P = N + 1 (the mLSTM's x: v and the ones); gate =
    softplus(dt), log_a = -gate·exp(a_log), the model's gates ("overflow":
    log_a <= -1.5, so l falls by more than 88 within a 64-row chunk and
    exp(l_i - l_j) above the diagonal overflows fp32); dy and ds_final
    N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    hc = 1 if shared else H
    c, b, x = f(B, hc, S, N), f(B, hc, S, N), f(B, H, S, P)
    if P == N + 1:                     # the mLSTM's normalizer column
        x[..., -1] = 1.0
    dt = f(B, H, S)
    gate = np.log1p(np.exp(dt))
    log_a = {"model": -gate * np.exp(0.5 * f(H))[None, :, None],
             "overflow": -1.5 - 0.5 * np.abs(dt)}[gates].astype(np.float32)
    return c, b, x, log_a, gate, f(B, H, S, P), f(B, H, N, P)


def _jax_vjp(c, b, x, log_a, gate, dy, ds_final, H):
    """jax.vjp of the JAX ssd_ref, c and b broadcast over the heads inside
    the function (so a shared c's gradient sums over them)."""
    def f(c, b, x, log_a, gate):
        shape = (c.shape[0], H) + c.shape[2:]
        return jax_ssd_ref(jnp.broadcast_to(c, shape),
                           jnp.broadcast_to(b, shape), x, log_a, gate)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (c, b, x, log_a, gate)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy),
                                        jnp.asarray(ds_final)))]


def _key(name):
    return "ssd_bwd_dlog_a/cpu_fp32" if name == "log_a" \
        else "ssd_bwd/cpu_fp32"


@pytest.mark.parametrize("ds", [False, True], ids=["ds0", "ds"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-head"])
@pytest.mark.parametrize("S", [64, 70, 1], ids=["S64", "S70", "S1"])
@pytest.mark.parametrize("N,P", [(16, 32), (64, 64), (32, 33)],
                         ids=["16x32", "64x64", "32x33"])
def test_ssd_bwd_matches_jax_vjp(N, P, S, shared, ds):
    """``ssd_bwd_ref`` (per head; summed over the heads where c and b are
    shared), ``ssd_chunked_bwd_ref`` at chunk 64 and 16 (given the shared c
    and b with their head dim of 1, so it folds them itself) and
    ``ssd_scan`` under autograd (shared c and b as expands and with a head
    dim of 1) against ``jax.vjp`` of the JAX ``ssd_ref``, every input's
    gradient, with y's and s_final's upstream gradients both nonzero where
    ``ds``; at the reduced hybrid's (16, 32), zamba2's (64, 64) and the
    reduced xlstm's (32, 33) with its column of ones (xlstm's real (512,
    513) in tests/test_torch_xlstm_train.py)."""
    c, b, x, log_a, gate, dy, ds_final = _scan_inputs(N, P, S, shared)
    B, H = x.shape[:2]
    ds_final = ds_final if ds else np.zeros_like(ds_final)
    want = _jax_vjp(c, b, x, log_a, gate, dy, ds_final, H)

    t = [torch.from_numpy(a) for a in (c, b, x, log_a, gate)]
    tdy, tds = torch.from_numpy(dy), torch.from_numpy(ds_final)
    full = [v.expand(B, H, *v.shape[2:]) for v in t[:2]] + t[2:]
    got = list(ssd_bwd_ref(*full, tdy, tds if ds else None))
    if shared:
        got[0], got[1] = (g.sum(1, keepdim=True) for g in got[:2])
    for chunk in (64, 16):
        twin = ssd_chunked_bwd_ref(*t, tdy, tds if ds else None, chunk=chunk)
        for name, g, w in zip(GRADS, twin, want):
            assert g.shape == w.shape and g.dtype == torch.float32, name
            _close(g, w, _key(name))
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        _close(g, w, _key(name))

    views = [lambda v: v.expand(B, H, *v.shape[2:])] + (
        [lambda v: v] if shared else [])
    for view in views:
        leaves = [v.clone().requires_grad_() for v in t]
        y, s_final = ssd_scan(*map(view, leaves[:2]), *leaves[2:])
        assert y.grad_fn is not None
        torch.autograd.backward((y, s_final) if ds else (y,),
                                (tdy, tds) if ds else (tdy,))
        for name, leaf, w in zip(GRADS, leaves, want):
            _close(leaf.grad, w, _key(name))


@pytest.mark.parametrize("chunk", [64, 16])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-head"])
def test_ssd_chunked_bwd_ref_holds_where_the_decay_overflows(shared, chunk):
    """The twin against ``ssd_bwd_ref`` and ``jax.vjp`` where l falls by more
    than 88 within a chunk, so exp(l_i - l_j) above the diagonal would be
    inf (the twin's mask is a select taken before the exp, as the kernel's
    is), at a ragged S, b and c shared by 4 heads or per head, a nonzero
    ds_final."""
    c, b, x, log_a, gate, dy, ds_final = _scan_inputs(
        64, 64, 150, shared, H=4, gates="overflow")
    B, H = x.shape[:2]
    t = [torch.from_numpy(a) for a in (c, b, x, log_a, gate, dy, ds_final)]
    got = ssd_chunked_bwd_ref(*t, chunk=chunk)
    assert all(torch.isfinite(g).all() for g in got)
    want = list(ssd_bwd_ref(*[v.expand(B, H, *v.shape[2:]) for v in t[:2]],
                            *t[2:]))
    if shared:
        want[0], want[1] = (w.sum(1, keepdim=True) for w in want[:2])
    for name, g, w in zip(GRADS, got, want):
        _close(g, w, _key(name))
    for name, g, w in zip(GRADS, got, _jax_vjp(c, b, x, log_a, gate, dy,
                                               ds_final, H)):
        _close(g, w, _key(name))


@pytest.mark.parametrize("shared", [False, True], ids=["per-head", "shared"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssd_scan_autograd_on_cpu_is_the_plain_backward(dtype, shared):
    """On the CPU ``ssd_scan`` runs ``ssd_ref`` forward (c and b of a head
    dim of 1 read over the heads) and, where a gradient is wanted, its
    autograd Function's backward is the kernel's plain chunked twin
    ``ssd_chunked_bwd_ref`` bit for bit, each gradient cast to its input's
    type (bf16 c, b, x as the model's, fp32 gates): for a shared c and b the
    twin's gradients summed over the heads, of their (B, 1, S, N) shape,
    with no fold after it."""
    c, b, x, log_a, gate, dy, ds_final = _scan_inputs(64, 64, 70, shared)
    t = [torch.from_numpy(a).to(dtype) for a in (c, b, x)] + [
        torch.from_numpy(a) for a in (log_a, gate)]
    dy, ds_final = torch.from_numpy(dy).to(dtype), torch.from_numpy(ds_final)
    leaves = [v.clone().requires_grad_() for v in t]
    y, s_final = ssd_scan(*leaves)
    B, H = x.shape[:2]
    want_y, want_s = ssd_ref(*[v.expand(B, H, *v.shape[2:]) for v in t[:2]],
                             *t[2:])
    assert torch.equal(y, want_y) and torch.equal(s_final, want_s)
    torch.autograd.backward((y, s_final), (dy, ds_final))
    want = ssd_chunked_bwd_ref(*t, dy, ds_final)
    for name, leaf, w in zip(GRADS, leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        assert leaf.grad.shape == leaf.shape, name
        assert torch.equal(leaf.grad, w.to(leaf.dtype)), name
    # only y used: s_final's gradient is None in the Function, not zeros
    leaves = [v.clone().requires_grad_() for v in t]
    ssd_scan(*leaves)[0].backward(dy)
    want = ssd_chunked_bwd_ref(*t, dy)
    for name, leaf, w in zip(GRADS, leaves, want):
        assert torch.equal(leaf.grad, w.to(leaf.dtype)), name


def test_ssd_backward_guard_names_the_wide_shape():
    """The backward kernels take zamba2's (64, 64) and xlstm's (512, 513);
    another shape, the reduced hybrid's (16, 32), is refused by name before
    any launch, as a CUDA-destined scan with a gradient wanted is
    (``ssd_scan`` calls the same guard)."""
    check_bwd_shape(64, 64)
    check_bwd_shape(512, 513)
    with pytest.raises(NotImplementedError, match=r"not \(16, 32\)"):
        check_bwd_shape(16, 32)
    c = torch.zeros(1, 1, 3, 16, dtype=torch.bfloat16)
    x = torch.zeros(1, 1, 3, 32, dtype=torch.bfloat16)
    g = torch.zeros(1, 1, 3)
    with pytest.raises(NotImplementedError, match=r"\(512, 513\).*ROADMAP"):
        ssd_scan_bwd_cuda(c, c, x, g, g, x)


# ---------------------------------------------------------------------------
# the reduced zamba2 model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_reduced_zamba2_loss_and_every_grad_match_jax(remat):
    """The loss and all 26 gradients (the Mamba2 projections, the conv
    taps, a_log, dt_bias and d_skip through the SSD backward and the gates,
    the shared block's through both of its applications, the embedding and
    the head) against ``jax.value_and_grad`` of the reference's loss, each
    leaf within a share of its own largest entry."""
    jcfg, tcfg = _cfgs(remat=remat)
    npt = _np_params(jcfg)
    inputs = {k: v[0] for k, v in _batch(jcfg, 1, 2, 17).items()}
    jloss, jgrads = jax.value_and_grad(jax_loss_fn)(
        jax.tree.map(jnp.asarray, npt), jax.tree.map(jnp.asarray, inputs),
        jcfg)
    tp = params_from_numpy(npt, tcfg, device="cpu")
    flat = _paths(tp)
    for _, t in flat:
        t.requires_grad_(True)
    loss = loss_fn(tp, {k: torch.from_numpy(v) for k, v in inputs.items()},
                   tcfg)
    grads = torch.autograd.grad(loss, [t for _, t in flat])
    _close(loss, jloss, "model_loss/cpu_fp32")
    jg = jax.tree.map(np.asarray, jgrads)
    assert len(flat) == len(jax.tree.leaves(jg)) == 26
    for (path, _), g in zip(flat, grads):
        want = _get(jg, path)
        assert g.shape == want.shape and g.dtype == torch.float32, path
        scale = np.abs(want).max()
        assert scale > 0, path
        atol, rtol = TOLERANCES["ssd/hybrid_grad_cpu_fp32"]
        np.testing.assert_allclose(g.numpy(), want, atol=atol * scale,
                                   rtol=rtol, err_msg=path)


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_remat_reruns_each_layer_once(remat, monkeypatch):
    """Under remat each Mamba2 layer (its SSD scan) and each application of
    the shared block run twice in a loss and its backward (once more in
    the backward); without remat once.  The launch counts that
    ``chip_smoke.py`` holds the card to follow from this."""
    jcfg, tcfg = _cfgs(remat=remat)
    calls = {"mamba_block": 0, "attention_block": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(t_model, "mamba_block", counted(
        "mamba_block", t_model.mamba_block))
    monkeypatch.setattr(t_model, "attention_block", counted(
        "attention_block", t_model.attention_block))
    tp = params_from_numpy(_np_params(jcfg), tcfg, device="cpu")
    flat = [t.requires_grad_(True) for _, t in _paths(tp)]
    inputs = {k: torch.from_numpy(v[0]) for k, v in
              _batch(jcfg, 1, 2, 9).items()}
    torch.autograd.grad(loss_fn(tp, inputs, tcfg), flat)
    n_apps = tcfg.n_layers // tcfg.attn_every
    times = 2 if remat else 1
    assert calls == {"mamba_block": times * tcfg.n_layers,
                     "attention_block": times * n_apps}


def test_one_adamw_step_on_reduced_zamba2_matches_jax():
    """One step of 2 microbatches under remat: the loss, the gradient norm
    and the parameters after AdamW, at the first-step sign rule of
    tests/test_torch_train.py (a gradient near 0 may move a parameter by
    2·lr in either package)."""
    jcfg, tcfg = _cfgs(remat=True)
    npt = _np_params(jcfg)
    b = _batch(jcfg, 2, 2, 17)
    lr = 1e-3
    jstep = j_make_train_step(jcfg, j_adamw(lr=lr))
    jp = jax.tree.map(jnp.asarray, npt)
    jp_new, jopt, jm = jstep(jp, jstep.init_opt_state(jp),
                             jax.tree.map(jnp.asarray, b))
    # JAX's first moment after one step is (1 - b1)·g, g the clipped mean
    # gradient that the update's sign follows
    jg = jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), jopt["m"])
    step = make_train_step(tcfg, adamw(lr=lr))
    tp = params_from_numpy(npt, tcfg, device="cpu")
    opt = step.init_opt_state(tp)
    tp, opt, tm = step(tp, opt, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
    _close(tm["loss"], jm["loss"], "model_loss/cpu_fp32")
    _close(tm["grad_norm"], jm["grad_norm"], "model_loss/cpu_fp32")
    jnew = jax.tree.map(np.asarray, jp_new)
    for path, t in _paths(tp):
        want, g = _get(jnew, path), _get(jg, path)
        got = t.detach().numpy()
        np.testing.assert_allclose(got, want, atol=2 * lr, rtol=0)
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[big], want[big], atol=1e-6,
                                   rtol=1e-5)


def test_train_cli_trains_reduced_zamba2_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trained 2 steps" in out.stdout
    assert find_latest(str(tmp_path)) == 2
