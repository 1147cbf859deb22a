"""Training the port's ssm family (xlstm-1.3b) against the JAX package's, on
the CPU, with JAX's parameters carried across by ``params_from_numpy``.

* The SSD scan's backward at xlstm's real (N 512, P 513) with a column of
  ones in x, as the mLSTM block makes it: ``ssd_chunked_bwd_ref`` (the
  decomposition of ``csrc/ssd_scan_bwd_wide.cu``) and autograd through
  ``ssd_scan`` against ``jax.vjp`` of the JAX ``ssd_ref``, ds_final zero
  and not (the reduced (32, 33) runs with the other shapes in
  ``tests/test_torch_hybrid_train.py``).
* dlog_a in the wide kernel's telescoped form (a reverse sum over the
  whole sequence and the last chunk's constant) against ``jax.vjp`` and
  the twin, at (32, 33) and (512, 513), S 70 and 1, ds_final zero and not.
* The card's limit for dlog_a at S 1 (0 in exact arithmetic) against its
  control, a carry one row late, at both SSD shapes.
* The wide backward's operands: dy and dx reach the kernel in rows that
  start 16-byte aligned whatever layout dy arrives in.
* One sLSTM block's gradients (its scan's written-out backward) against
  ``jax.grad`` of the JAX ``slstm_block`` (a ``lax.scan``), at the reduced
  widths and at xlstm's real ones.
* The reduced xlstm (fp32, 4 blocks: 2 segments of 1 mLSTM + 1 sLSTM,
  d_model 128, heads of 32): the loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference's loss, remat off and on; under
  remat each mLSTM block runs once more and the sLSTM block still once;
  one AdamW step; the train CLI.

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
from repro.models import xlstm as jax_xlstm
from repro.models.model import _slstm_params as jax_slstm_params
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim import adamw as j_adamw
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import find_latest
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.common import REL_L2, TOLERANCES
from repro_torch.kernels.ssd.kernel import wide_bwd_operands
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import (ssd_chunked_bwd_ref,
                                         ssd_dlog_a_telescoped, ssd_ref)
from repro_torch.models import loss_fn, model as t_model, params_from_numpy
from repro_torch.models import xlstm
from repro_torch.optim import adamw
from repro_torch.train import make_train_step

ARCH = "xlstm-1.3b"
SRC = Path(__file__).resolve().parents[1] / "src"
GRADS = ("c", "b", "x", "log_a", "gate")


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
    """JAX's init as a numpy tree, with every norm weight and the sLSTM
    bias drawn at random (JAX's init makes them 1 and 0), so that each
    enters the comparison."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    draw = lambda shape, loc, scale: (
        loc + scale * rng.normal(size=shape)).astype(np.float32)
    for node in (tree["mlstm"]["norm"], tree["slstm"]["norm"],
                 tree["final_norm"]):
        node["w"] = draw(node["w"].shape, 1.0, 0.1)
    tree["slstm"]["b"] = draw(tree["slstm"]["b"].shape, 0.0, 0.5)
    return tree


def _batch(jcfg, M, mb, S, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (M, mb, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    batch["labels"][..., -3:] = -100              # padding: masked out
    return batch


def _close(got, want, key, name=""):
    atol, rtol = TOLERANCES[key]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=name)


def _leaf_close(path, got, want, key):
    """A gradient leaf within ``TOLERANCES[key]``, atol a share of the
    leaf's largest |grad| (each leaf's error follows its own scale)."""
    atol, rtol = TOLERANCES[key]
    scale = np.abs(want).max()
    assert scale > 0, path
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=rtol,
                               err_msg=path)


# ---------------------------------------------------------------------------
# the SSD scan's backward at 512 / 513
# ---------------------------------------------------------------------------

def _wide_scan_inputs(B, H, S, seed=0):
    """numpy inputs as the mLSTM block makes them: c = q·512**-0.5 and b =
    k, x = v with a last column of ones, log_a = log σ(f + 3), gate = σ(i);
    dy and ds_final N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    c, b, x = f(B, H, S, 512) * 512 ** -0.5, f(B, H, S, 512), f(B, H, S, 513)
    x[..., -1] = 1.0
    log_a = -np.log1p(np.exp(-(f(B, H, S) + 3.0)))
    gate = 1.0 / (1.0 + np.exp(-f(B, H, S)))
    return (c, b, x, log_a.astype(np.float32), gate.astype(np.float32),
            f(B, H, S, 513), f(B, H, 512, 513))


@pytest.mark.parametrize("ds", [False, True], ids=["ds0", "ds"])
def test_wide_ssd_bwd_matches_jax_vjp(ds):
    """``ssd_chunked_bwd_ref`` (at chunk 64, the kernel's) and ``ssd_scan``
    under autograd against ``jax.vjp`` of the JAX ``ssd_ref`` at B 1, H 1,
    S 70 (a ragged second chunk), every input's gradient, with s_final's
    upstream gradient nonzero where ``ds``."""
    c, b, x, log_a, gate, dy, ds_final = _wide_scan_inputs(1, 1, 70)
    ds_final = ds_final if ds else np.zeros_like(ds_final)
    _, vjp = jax.vjp(jax_ssd_ref, *map(jnp.asarray, (c, b, x, log_a, gate)))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy),
                                        jnp.asarray(ds_final)))]
    key = {n: "ssd_bwd_dlog_a/cpu_fp32" if n == "log_a"
           else "ssd_bwd/cpu_fp32" for n in GRADS}
    t = [torch.from_numpy(a) for a in (c, b, x, log_a, gate)]
    tdy, tds = torch.from_numpy(dy), torch.from_numpy(ds_final)
    twin = ssd_chunked_bwd_ref(*t, tdy, tds if ds else None)
    for name, g, w in zip(GRADS, twin, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        _close(g.numpy(), w, key[name], name)
    leaves = [v.clone().requires_grad_() for v in t]
    y, s_final = ssd_scan(*leaves)
    torch.autograd.backward((y, s_final) if ds else (y,),
                            (tdy, tds) if ds else (tdy,))
    for name, leaf, w in zip(GRADS, leaves, want):
        _close(leaf.grad.numpy(), w, key[name], name)


@pytest.mark.parametrize("S", [70, 1], ids=["S70", "S1"])
@pytest.mark.parametrize("ds", [False, True], ids=["ds0", "ds"])
@pytest.mark.parametrize("N,P", [(32, 33), (512, 513)],
                         ids=["32_33", "512_513"])
def test_telescoped_dlog_a_matches_jax_vjp_and_twin(N, P, ds, S):
    """``ssd_dlog_a_telescoped``, dlog_a as the wide kernel takes it (the
    reverse sum of c·dc − g·dgate over the whole sequence plus the last
    chunk's exp(l_L)<ds_final, S_in> + Σ w q), from the twin's dc and dgate,
    against ``jax.vjp`` of the JAX ``ssd_ref`` and against the twin's own
    dlog_a (a sum within each chunk plus its carry), at B 2, H 2, x's last
    column ones, ds_final zero and given, S 70 (two chunks, the state
    carried) and S 1 (dlog_a 0 in exact arithmetic)."""
    rng = np.random.default_rng(11)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    B, H = 2, 2
    c, b, x = f(B, H, S, N) * N ** -0.5, f(B, H, S, N), f(B, H, S, P)
    x[..., N:] = 1.0
    log_a = -np.log1p(np.exp(-(f(B, H, S) + 3.0))).astype(np.float32)
    gate = (1.0 / (1.0 + np.exp(-f(B, H, S)))).astype(np.float32)
    dy = f(B, H, S, P)
    ds_final = f(B, H, N, P) if ds else np.zeros((B, H, N, P), np.float32)
    args = (c, b, x, log_a, gate)
    _, vjp = jax.vjp(jax_ssd_ref, *map(jnp.asarray, args))
    want = np.asarray(vjp((jnp.asarray(dy), jnp.asarray(ds_final)))[3])
    t = [torch.from_numpy(a) for a in args]
    tds = torch.from_numpy(ds_final) if ds else None
    dc, _, _, twin, dgate = ssd_chunked_bwd_ref(*t, torch.from_numpy(dy), tds)
    got = ssd_dlog_a_telescoped(*t, dc, dgate, tds)
    assert got.shape == (B, H, S) and got.dtype == torch.float32
    _close(got.numpy(), want, "ssd_bwd_dlog_a/cpu_fp32", "vs jax.vjp")
    _close(got.numpy(), twin.numpy(), "ssd_bwd_dlog_a/cpu_fp32", "vs twin")
    if S == 1:
        assert not want.any()


@pytest.mark.parametrize("N,P", [(64, 64), (512, 513)],
                         ids=["64_64", "512_513"])
def test_ssd_bwd_s1_dlog_a_limit_rejects_a_late_carry(N, P):
    """At S 1 with a nonzero ds_final, dlog_a is 0 in exact arithmetic
    (``jax.vjp`` of the JAX ``ssd_ref`` gives 0): the twin's is rounding
    alone, well under the card's elementwise atol for it.  The control of
    the card's S 1 limit (``chip_smoke.py:ssd_bwd_carry_late``), dlog_a
    with the carry <ds_final, S> taken one row late, reads far past that
    limit in the card check's measure (divided by the larger of the twin's
    norm and the atol's)."""
    rng = np.random.default_rng(3)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    B, H = 2, 3
    c, b, x = f(B, H, 1, N) * N ** -0.5, f(B, H, 1, N), f(B, H, 1, P)
    x[..., N:] = 1.0
    log_a = -0.01 * np.abs(f(B, H, 1))
    gate = 1.0 / (1.0 + np.exp(-f(B, H, 1)))
    dy, ds = f(B, H, 1, P), f(B, H, N, P)
    args = (c, b, x, log_a, gate.astype(np.float32))
    _, vjp = jax.vjp(jax_ssd_ref, *map(jnp.asarray, args))
    assert not np.asarray(vjp((jnp.asarray(dy), jnp.asarray(ds)))[3]).any()
    t = [torch.from_numpy(a) for a in args]
    twin = ssd_chunked_bwd_ref(*t, torch.from_numpy(dy), torch.from_numpy(ds))
    key = "ssd_scan_bwd_dlog_a_s1/card_fp32"
    atol = TOLERANCES[key][0]
    assert float(twin[3].abs().max()) < atol / 100
    late = twin[3] + (torch.from_numpy(ds) * ssd_ref(*t)[1]).sum(
        (-2, -1))[..., None]
    scale = max(float(twin[3].norm()), atol * twin[3].numel() ** 0.5)
    assert float((late - twin[3]).norm()) / scale > 100 * REL_L2[key]


@pytest.mark.parametrize("layout", ["dense", "transposed", "padded"])
def test_wide_bwd_operands_align_every_row(layout):
    """The wide backward reads dy and writes dx in rows that start 16-byte
    aligned (a pitch of a multiple of 8 bf16) whatever layout dy arrives in:
    autograd may hand it back dense, whose 513-wide rows are 1,026 bytes,
    and that copy keeps dy's values.  x is the mLSTM's padded view; dx
    comes back in its layout."""
    B, H, S = 2, 4, 5
    v = torch.empty(B, S, H, 520, dtype=torch.bfloat16)[..., :513]
    x = v.transpose(1, 2)
    x.copy_(torch.randn(B, H, S, 513))
    dy = {"dense": torch.randn(B, H, S, 513),
          "transposed": torch.randn(B, S, H, 513).transpose(1, 2),
          "padded": x.clone(memory_format=torch.preserve_format) * 0 + 1,
          }[layout].to(torch.bfloat16)
    qk = torch.randn(B, S, H, 512, dtype=torch.bfloat16).transpose(1, 2)
    c, b, x2, dy2, dx = wide_bwd_operands(qk, qk, x, dy)
    assert c is qk and b is qk and x2 is x        # aligned already: no copy
    for t in (dy2, dx):
        assert t.shape == (B, H, S, 513) and t.stride(-1) == 1
        assert all(s % 8 == 0 for s in t.stride()[:3]), t.stride()
        assert t.data_ptr() % 16 == 0
    assert torch.equal(dy2, dy)
    assert dx.stride() == x.stride()


# ---------------------------------------------------------------------------
# the sLSTM block's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["reduced", "d2048"])
def test_slstm_block_grads_match_jax(size):
    """The sLSTM block's output gradient wrt its input and each of its
    parameters (w_x, b, r, w_out), the scan's written-out backward
    (``xlstm._SlstmScan``) against ``jax.grad`` of the JAX ``slstm_block``
    (a ``lax.scan``), fp32,
    at the reduced widths (d 128, heads of 32) and at xlstm's (d 2048, heads
    of 512) at a short S."""
    over = dict(dtype="float32", remat=False)
    if size == "reduced":
        jcfg, tcfg = _cfgs(**over)
        B, S = 2, 19
    else:
        jcfg = dataclasses.replace(get_config(ARCH), **over)
        tcfg = dataclasses.replace(t_get_config(ARCH), **over)
        B, S = 1, 12
    rng = np.random.default_rng(4)
    sp = jax.tree.map(np.asarray, jax_slstm_params(
        jax.random.PRNGKey(4), jcfg, jnp.float32))
    sp["b"] = (0.5 * rng.normal(size=sp["b"].shape)).astype(np.float32)
    sp.pop("norm", None)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jax_xlstm.slstm_block(p, x, jcfg) * w)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, sp), jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in sp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (xlstm.slstm_block(tp, tx, tcfg) * torch.from_numpy(w)).sum().backward()
    key = "xlstm/slstm_grad_cpu_fp32"
    _leaf_close("x", tx.grad.numpy(), np.asarray(jg_x), key)
    assert set(tp) == set(jg_p)
    for k, t in tp.items():
        _leaf_close(k, t.grad.numpy(), np.asarray(jg_p[k]), key)


# ---------------------------------------------------------------------------
# the reduced xlstm model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_reduced_xlstm_loss_and_every_grad_match_jax(remat):
    """The loss and every gradient (the mLSTM projections and gates through
    the SSD backward at (32, 33), the sLSTM's through its loop, the norms,
    the embedding and the head) against ``jax.value_and_grad`` of the
    reference's loss, each leaf within a share of its own largest entry."""
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
    _close(float(loss.detach()), float(jloss), "model_loss/cpu_fp32")
    jg = jax.tree.map(np.asarray, jgrads)
    assert len(flat) == len(jax.tree.leaves(jg)) == 16
    for (path, _), g in zip(flat, grads):
        want = _get(jg, path)
        assert g.shape == want.shape and g.dtype == torch.float32, path
        _leaf_close(path, g.numpy(), want, "xlstm/grad_cpu_fp32")


@pytest.mark.parametrize("remat", [False, True])
def test_ssm_remat_reruns_each_mlstm_block_once(remat, monkeypatch):
    """Under remat each mLSTM block (its SSD scan) runs twice in a loss and
    its backward (once more in the backward); the sLSTM block runs outside
    the remat, once either way, as without remat each block does.  The
    launch counts that ``chip_smoke.py`` holds the card to follow from
    this."""
    jcfg, tcfg = _cfgs(remat=remat)
    calls = {"mlstm_block": 0, "slstm_block": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for name in calls:
        monkeypatch.setattr(t_model, name, counted(name,
                                                   getattr(t_model, name)))
    tp = params_from_numpy(_np_params(jcfg), tcfg, device="cpu")
    flat = [t.requires_grad_(True) for _, t in _paths(tp)]
    inputs = {k: torch.from_numpy(v[0]) for k, v in
              _batch(jcfg, 1, 2, 9).items()}
    torch.autograd.grad(loss_fn(tp, inputs, tcfg), flat)
    n_slstm, per = t_model.ssm_layout(tcfg)
    n_mlstm = n_slstm * per
    assert n_mlstm == n_slstm == 2
    assert calls == {
        "mlstm_block": (2 if remat else 1) * n_mlstm,
        "slstm_block": n_slstm}


def test_one_adamw_step_on_reduced_xlstm_matches_jax():
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
    for k in ("loss", "grad_norm"):
        _close(float(tm[k]), float(jm[k]), "model_loss/cpu_fp32", k)
    jnew = jax.tree.map(np.asarray, jp_new)
    for path, t in _paths(tp):
        want, g = _get(jnew, path), _get(jg, path)
        got = t.detach().numpy()
        np.testing.assert_allclose(got, want, atol=2 * lr, rtol=0)
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[big], want[big], atol=1e-6,
                                   rtol=1e-5)


def test_train_cli_trains_reduced_xlstm_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trained 2 steps" in out.stdout
    assert find_latest(str(tmp_path)) == 2
