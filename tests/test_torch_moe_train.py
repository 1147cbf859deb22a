"""Training the port's MoE family (granite-moe-3b-a800m) against the JAX
package's, on the CPU, with JAX's parameters carried across by
``params_from_numpy``.

* ``moe_gmm_bwd_ref`` (and its equal-groups form) against ``jax.vjp`` of
  the JAX ``moe_gmm_ref``, in fp32 and bf16, with equal groups, with
  ragged sizes that sum to T, an empty group among them, and with expert
  ends off 64-row slices beside a neighbour of large rows.
* ``moe_gmm`` under autograd on the CPU gives the plain backward's dx and
  dw; the group sizes get no gradient.
* The flash backward's plain version at granite's head dim 64 and GQA group
  3 against ``jax.vjp`` of the JAX ``attention_ref``.
* The reduced granite config (fp32, 2 layers, d_model 128, 8 experts padded
  to 16, top-2, head dim 32): the loss and every gradient against
  ``jax.value_and_grad(loss_fn)``, remat off and on; one AdamW step.
* ``missing_backwards``: granite trains on the card, the ssm, hybrid and
  head-dim-192 configs do not; the train CLI for granite on the CPU.

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
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim import adamw as j_adamw
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import find_latest
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import flash_attention, moe_gmm
from repro_torch.kernels.common import TOLERANCES
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as t_attention_ref
from repro_torch.kernels.moe_gmm.ref import (moe_gmm_bwd_equal_ref,
                                             moe_gmm_bwd_ref)
from repro_torch.launch import check_card_config, missing_backwards
from repro_torch.models import loss_fn, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import make_train_step

ARCH = "granite-moe-3b-a800m"
SRC = Path(__file__).resolve().parents[1] / "src"
RNG = np.random.default_rng(0)


def _np(*shape, scale=1.0, rng=RNG):
    return (rng.normal(size=shape) * scale).astype(np.float32)


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
    """JAX's init as a numpy tree, with random norm weights."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    lay = tree["layers"]
    for norm in ("attn_norm", "mlp_norm"):
        lay[norm]["w"] = (1 + 0.1 * rng.normal(
            size=lay[norm]["w"].shape)).astype(np.float32)
    return tree


def _batch(jcfg, M, mb, S, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (M, mb, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    batch["labels"][..., -3:] = -100              # padding: masked out
    return batch


# ---------------------------------------------------------------------------
# the grouped matmul's backward
# ---------------------------------------------------------------------------

GMM_CASES = {
    # name: (D, F, group sizes, the expert whose rows are large or None);
    # every case's sizes sum to T, as the JAX oracle needs (it hands rows
    # past the groups to the last expert)
    "equal": (64, 48, [12] * 6, None),
    "ragged, an empty group": (32, 24, [5, 0, 17, 1, 9, 0, 3], None),
    # every expert ends off a 64-row slice (rows 70, 75, 134, 134, 265: the
    # card's dw walks an expert's rows 64 at a time from its first), and
    # expert 1, after expert 0's end, has x and dy rows of +-1e3: a dw[0]
    # that took its first row would be off by ~1e6.  w is +-2^-6, so that
    # every product and sum over expert 1's rows is exact in fp32 and the
    # comparison's absolute atol holds at that scale.
    "ends off 64-row slices, a large neighbour":
        (16, 24, [70, 5, 59, 0, 131], 1),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_moe_gmm_bwd_ref_matches_jax_vjp(case, dtype):
    """dx and dw against ``jax.vjp`` of the JAX oracle.  In bf16 the oracle
    runs in fp32 on the same bf16 values and is rounded once, which is the
    port's contract (fp32 sums, one rounding); JAX's own bf16 vjp would
    round each row's contribution to dw before the gather's transpose adds
    them."""
    D, F, sizes, big = GMM_CASES[case]
    T, E = sum(sizes), len(sizes)
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    # the large case draws from its own generator: the other tests' inputs
    # stay as they were
    rng = RNG if big is None else np.random.default_rng(1)
    arrays = [_np(T, D, rng=rng), _np(E, D, F, scale=D ** -0.5, rng=rng),
              _np(T, F, rng=rng)]
    if big is not None:
        lo = sum(sizes[:big])
        for a in (arrays[0], arrays[2]):
            a[lo:lo + sizes[big]] = np.sign(a[lo:lo + sizes[big]]) * 1e3
        arrays[1] = np.sign(arrays[1]) * np.float32(2.0 ** -6)
    x, w, dy = (torch.from_numpy(a).to(tdt) for a in arrays)
    gs = torch.tensor(sizes, dtype=torch.int32)
    _, vjp = jax.vjp(
        lambda x, w: jax_moe_gmm_ref(x, w, jnp.asarray(sizes, jnp.int32)),
        *(jnp.asarray(t.float().numpy()) for t in (x, w)))
    jdx, jdw = vjp(jnp.asarray(dy.float().numpy()))
    want = [torch.from_numpy(np.array(a)).to(tdt) for a in (jdx, jdw)]
    key = f"moe_gmm/cpu_{dtype}"
    dx, dw = moe_gmm_bwd_ref(x, w, dy, gs)
    assert dx.dtype == dw.dtype == tdt
    _close(dx, want[0], key)
    _close(dw, want[1], key)
    empty = [e for e, n in enumerate(sizes) if n == 0]
    assert not dw[empty].any()                   # an empty group gets dw 0
    if len(set(sizes)) == 1:
        edx, edw = moe_gmm_bwd_equal_ref(x, w, dy, sizes[0])
        _close(edx, want[0], key)
        _close(edw, want[1], key)


def test_moe_gmm_bwd_ref_past_the_groups():
    """Rows past ``sum(group_sizes)`` get dx 0 and give nothing to dw: the
    plain backward equals the one of the rows inside the groups alone."""
    D, F, sizes, T = 32, 16, [7, 0, 5], 20
    x, dy = torch.from_numpy(_np(T, D)), torch.from_numpy(_np(T, F))
    w = torch.from_numpy(_np(3, D, F))
    gs = torch.tensor(sizes, dtype=torch.int32)
    dx, dw = moe_gmm_bwd_ref(x, w, dy, gs)
    n = sum(sizes)
    assert not dx[n:].any()
    dx_in, dw_in = moe_gmm_bwd_ref(x[:n], w, dy[:n], gs)
    assert torch.equal(dx[:n], dx_in) and torch.equal(dw, dw_in)


@pytest.mark.parametrize("equal", [False, True], ids=["sizes", "equal"])
def test_moe_gmm_autograd_on_cpu_is_the_plain_backward(equal):
    """``moe_gmm`` with a gradient wanted goes through its autograd
    Function: on the CPU x.grad and w.grad are the plain backward's
    (``moe_gmm_bwd_equal_ref`` under ``equal_groups``), and the int32
    group sizes get none."""
    E, C, D, F = 4, 6, 16, 24
    x = torch.from_numpy(_np(E * C, D)).requires_grad_()
    w = torch.from_numpy(_np(E, D, F)).requires_grad_()
    dy = torch.from_numpy(_np(E * C, F))
    gs = torch.full((E,), C, dtype=torch.int32)
    out = moe_gmm(x, w, gs, equal_groups=C if equal else None)
    assert out.grad_fn is not None
    out.backward(dy)
    want = (moe_gmm_bwd_equal_ref(x.detach(), w.detach(), dy, C) if equal
            else moe_gmm_bwd_ref(x.detach(), w.detach(), dy, gs))
    assert torch.equal(x.grad, want[0]) and torch.equal(w.grad, want[1])
    assert gs.grad is None
    # both forms agree with each other in fp32
    other = moe_gmm_bwd_ref(x.detach(), w.detach(), dy, gs)
    _close(x.grad, other[0], "moe_gmm/cpu_fp32")
    _close(w.grad, other[1], "moe_gmm/cpu_fp32")


# ---------------------------------------------------------------------------
# the flash backward at head dim 64, GQA group 3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Hq,Hkv,S,causal,window", [
    (1, 6, 2, 70, True, 0),       # granite's group 3, causal
    (2, 3, 1, 45, False, 0),      # group 3 over one kv head, not causal
    (1, 6, 2, 60, True, 16),      # windowed
])
def test_flash_bwd_at_head_dim_64_group_3_matches_jax(B, Hq, Hkv, S, causal,
                                                       window):
    D = 64
    q, k, v = _np(B, S, Hq, D), _np(B, S, Hkv, D), _np(B, S, Hkv, D)
    do = _np(B, S, Hq, D)
    j = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    _, vjp = jax.vjp(lambda q, k, v: attention_ref(q, k, v, causal=causal,
                                                   window=window),
                     j(q), j(k), j(v))
    want = vjp(j(do))
    key = "flash_attention_bwd/cpu_fp32"
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    views = [t.transpose(1, 2) for t in leaves]
    o = flash_attention(*views, causal=causal, window=window)
    o.backward(torch.from_numpy(do).transpose(1, 2))
    for t, w_ in zip(leaves, want):
        _close(t.grad.transpose(1, 2), w_, key)
    o, lse = t_attention_ref(*[t.detach() for t in views], causal=causal,
                             window=window, return_lse=True)
    got = flash_attention_bwd(*[t.detach() for t in views], o, lse,
                              torch.from_numpy(do).transpose(1, 2),
                              causal=causal, window=window)
    for g, w_ in zip(got, want):
        _close(g, w_, key)


# ---------------------------------------------------------------------------
# the reduced granite model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_reduced_granite_loss_and_every_grad_match_jax(remat):
    """The loss and all of its gradients: the router's (the padding
    experts' columns exactly 0), the experts' three stacks through the
    grouped matmul's backward, and the attention at head dim 32 through the
    flash backward's plain version.  2 x 17 tokens at top-2 over 8 experts
    give a capacity of 11, so some assignments are dropped, in both."""
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
    assert len(flat) == len(jax.tree.leaves(jg)) == 13
    for (path, _), g in zip(flat, grads):
        want = _get(jg, path)
        assert g.shape == want.shape and g.dtype == torch.float32, path
        _close(g, want, "model_grad/cpu_fp32")
    router = dict(zip((p for p, _ in flat), grads))["layers/moe/router"]
    assert not router[..., tcfg.n_experts:].any()
    assert router[..., :tcfg.n_experts].abs().sum() > 0


def test_one_adamw_step_on_reduced_granite_matches_jax():
    """One step of 2 microbatches: the loss, the gradient norm and the
    parameters after AdamW, at the first-step sign rule of
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


# ---------------------------------------------------------------------------
# what trains on the card, and the CLI
# ---------------------------------------------------------------------------

def test_missing_backwards_after_the_moe_slice():
    """granite's path (the grouped matmul, the flash backward at head dim
    64) has every backward; the SSD scan (zamba2, xlstm) and the flash
    backward at head dim 192 (nemotron) are still missing, by name."""
    granite = t_get_config(ARCH)
    assert missing_backwards(granite) == []
    check_card_config(granite, "cuda", training=True)
    assert any("SSD scan" in m
               for m in missing_backwards(t_get_config("zamba2-1.2b")))
    assert any("SSD scan" in m
               for m in missing_backwards(t_get_config("xlstm-1.3b")))
    assert missing_backwards(t_get_config("nemotron-4-340b")) == [
        "the flash attention at head dim 192 (its backward is built at "
        "[64, 128])"]
    for arch in ("zamba2-1.2b", "xlstm-1.3b", "nemotron-4-340b"):
        with pytest.raises(ValueError, match="no backward"):
            check_card_config(t_get_config(arch), "cuda", training=True)


def test_train_cli_trains_reduced_granite_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trained 2 steps" in out.stdout
    assert find_latest(str(tmp_path)) == 2
