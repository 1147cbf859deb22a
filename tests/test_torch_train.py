"""The port's training path (``repro_torch.models.loss_fn``, ``optim``,
``train``, ``data``, ``ckpt``, ``launch.train``) against the JAX package's on
the CPU, with JAX's parameters carried across by ``params_from_numpy``.

The config is the reduced qwen2-7b (float32, 2 layers, d_model 128, 4 q
heads over 2 kv heads, vocab 512) with random QKV biases and norm weights.
Tolerances are ``repro_torch.kernels.common.TOLERANCES`` entries.

The AdamW first step: m̂/(√v̂+eps) is sign(g) for |g| ≫ eps, so a gradient
near 0 whose sign differs between the packages would move a parameter by
2·lr.  The gradients are compared tightly; the parameters after one step
are compared tightly where |g| > 1e-6 and within 2·lr everywhere.
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
from repro.data.lm import DataConfig as JDataConfig
from repro.data.lm import global_batch_at as j_global_batch_at
from repro.data.lm import shard_batch_at as j_shard_batch_at
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import cosine_schedule as j_cosine
from repro.optim import linear_warmup as j_warmup
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import (CheckpointManager, find_latest, load_checkpoint,
                              save_checkpoint)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.data.lm import DataConfig, global_batch_at, shard_batch_at
from repro_torch.kernels.common import TOLERANCES
from repro_torch.launch.train import build_trainer
from repro_torch.models import forward, loss_fn, params_from_numpy
from repro_torch.optim import (adafactor, adamw, cosine_schedule,
                               linear_warmup, pick_optimizer)
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train import PreemptionError, make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"


def _close(got, want, key, **kw):
    atol, rtol = TOLERANCES[key]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=kw.get("atol", atol),
                               rtol=kw.get("rtol", rtol))


def _cfgs(**over):
    jcfg = dataclasses.replace(reduced(get_config("qwen2-7b")), **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config("qwen2-7b")), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _np_params(jcfg, seed=0):
    """JAX's init, with random biases and norm weights, as a numpy tree."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    lay = tree["layers"]
    for name in ("bq", "bk", "bv"):
        lay["attn"][name] = (rng.normal(size=lay["attn"][name].shape)
                             * 0.1).astype(np.float32)
    for norm in ("attn_norm", "mlp_norm"):
        lay[norm]["w"] = (1 + 0.1 * rng.normal(
            size=lay[norm]["w"].shape)).astype(np.float32)
    tree["final_norm"]["w"] = (1 + 0.1 * rng.normal(
        size=tree["final_norm"]["w"].shape)).astype(np.float32)
    return tree


def _paths(tree, prefix=""):
    """[(path, leaf)] of a nested dict, insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _paths(v, prefix + k + "/")]
    return [(prefix[:-1], tree)]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _batch(jcfg, M, mb, S, seed=5, pad=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (M, mb, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    if pad:
        batch["labels"][..., -3:] = -100          # padding: masked out
    return batch


# ---------------------------------------------------------------------------
# whole-model loss and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_grad_match_jax(remat):
    jcfg, tcfg = _cfgs(remat=remat)
    npt = _np_params(jcfg)
    b = _batch(jcfg, 1, 2, 17)
    inputs = {k: v[0] for k, v in b.items()}
    jloss, jgrads = jax.value_and_grad(jax_loss_fn)(
        jax.tree.map(jnp.asarray, npt),
        jax.tree.map(jnp.asarray, inputs), jcfg)
    tp = params_from_numpy(npt, tcfg, device="cpu")
    flat = _paths(tp)
    for _, t in flat:
        t.requires_grad_(True)
    loss = loss_fn(tp, {k: torch.from_numpy(v) for k, v in inputs.items()},
                   tcfg)
    grads = torch.autograd.grad(loss, [t for _, t in flat])
    _close(loss.detach(), jloss, "model_loss/cpu_fp32")
    jg = jax.tree.map(np.asarray, jgrads)
    assert len(flat) == len(jax.tree.leaves(jg))
    for (path, _), g in zip(flat, grads):
        want = _get(jg, path)
        assert g.shape == want.shape and g.dtype == torch.float32, path
        _close(g, want, "model_grad/cpu_fp32")


def test_forward_takes_layers_by_unbind_not_select():
    """One UnbindBackward per stacked tensor, no SelectBackward: the
    backward of ``tree[i]`` would allocate a stack-sized zero gradient for
    every layer."""
    _, tcfg = _cfgs()
    tp = params_from_numpy(_np_params(_cfgs()[0]), tcfg, device="cpu")
    for _, t in _paths(tp):
        t.requires_grad_(True)
    h, _ = forward(tp, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                   tcfg)
    names, seen, todo = [], set(), [h.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    assert "SelectBackward0" not in names
    assert names.count("UnbindBackward0") == len(_paths(tp["layers"]))


def test_remat_dots_policy_is_not_ported():
    _, tcfg = _cfgs(remat=True, remat_policy="dots")
    tp = params_from_numpy(_np_params(_cfgs()[0]), tcfg, device="cpu")
    for _, t in _paths(tp):
        t.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        forward(tp, {"tokens": torch.zeros(1, 4, dtype=torch.int32)}, tcfg)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def test_one_adamw_step_matches_jax():
    jcfg, tcfg = _cfgs(remat=True)
    npt = _np_params(jcfg)
    b = _batch(jcfg, 2, 2, 17)
    lr = 1e-3
    jstep = j_make_train_step(jcfg, j_adamw(lr=lr))
    jp = jax.tree.map(jnp.asarray, npt)
    jp_new, jopt, jm = jstep(jp, jstep.init_opt_state(jp),
                             jax.tree.map(jnp.asarray, b))
    # JAX's mean microbatch gradient, for the |g| > 1e-6 mask
    jg = jax.tree.map(
        lambda *g: np.mean(np.stack(g), 0),
        *[jax.tree.map(np.asarray, jax.grad(jax_loss_fn)(
            jp, {k: jnp.asarray(v[i]) for k, v in b.items()}, jcfg))
          for i in range(2)])

    step = make_train_step(tcfg, adamw(lr=lr))
    tp = params_from_numpy(npt, tcfg, device="cpu")
    opt = step.init_opt_state(tp)
    tp, opt, tm = step(tp, opt, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
    _close(tm["loss"], jm["loss"], "model_loss/cpu_fp32")
    _close(tm["grad_norm"], jm["grad_norm"], "model_loss/cpu_fp32")
    assert int(opt["count"]) == int(jopt["count"]) == 1
    jnew = jax.tree.map(np.asarray, jp_new)
    for path, t in _paths(tp):
        want, g = _get(jnew, path), _get(jg, path)
        got = t.detach().numpy()
        np.testing.assert_allclose(got, want, atol=2 * lr, rtol=0)
        big = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[big], want[big], atol=1e-6,
                                   rtol=1e-5)
        _close(_get(opt["m"], path), _get(jax.tree.map(np.asarray,
                                                        jopt["m"]), path),
               "model_grad/cpu_fp32")


def test_grad_accumulators_are_fp32_for_bf16_params():
    """bf16 parameters: each microbatch's gradient is added into an fp32
    accumulator (the sum is not rounded to bf16 between microbatches)."""
    _, tcfg = _cfgs(dtype="bfloat16")
    seen = []

    class Spy:
        def init(self, params):
            return {}

        def update(self, grads, state, params):
            seen.extend(tree_leaves(grads))
            return params, state, torch.zeros(())

    step = make_train_step(tcfg, Spy())
    tp = params_from_numpy(_np_params(_cfgs()[0]), tcfg, device="cpu")
    tp = jax.tree.map(lambda t: t.to(torch.bfloat16)
                      if t.dim() >= 2 else t, tp,
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    b = _batch(_cfgs()[0], 2, 1, 9)
    step(tp, {}, {k: torch.from_numpy(v) for k, v in b.items()})
    assert seen and all(g.dtype == torch.float32 for g in seen)


def test_train_step_refuses_what_the_later_slice_brings():
    """``grad_compress``, ``policy`` (the distributed slice) and Adafactor
    under a policy (the dry-run slice: its moments' means summed across
    the shards) are ported, and none is refused any more.  Adafactor's
    step under a one-rank policy (no process: every collective is over
    one shard) is the single-device step, its loss and parameters within
    the model tolerances.  On one device, the compressed step is the
    reference's: the loss, and the parameters after the AdamW step at the
    first-step sign rule of ``test_one_adamw_step_matches_jax`` (the int8
    round trip of the gradients is exact arithmetic in both)."""
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.policy import make_policy
    from repro_torch.models.config import ShapeConfig
    jcfg, tcfg = _cfgs()
    pol = make_policy(tcfg, ShapeConfig("t", 17, 4, "train"),
                      Mesh(shape={"data": 1, "model": 1}))
    npt = _np_params(jcfg)
    b = _batch(jcfg, 2, 2, 17)
    runs = []
    for policy in (None, pol):
        step = make_train_step(tcfg, adafactor(lr=1e-3), policy=policy)
        tp = params_from_numpy(npt, tcfg, device="cpu")
        tp, _, tm = step(tp, step.init_opt_state(tp),
                         {k: torch.from_numpy(v) for k, v in b.items()})
        runs.append((dict(_paths(tp)), tm["loss"]))
    _close(runs[1][1], runs[0][1].numpy(), "model_loss/cpu_fp32")
    for path, t in runs[1][0].items():
        np.testing.assert_allclose(t.detach().numpy(),
                                   runs[0][0][path].detach().numpy(),
                                   atol=1e-6, rtol=0)
    jstep = j_make_train_step(jcfg, j_adamw(lr=1e-3), grad_compress=True)
    jp = jax.tree.map(jnp.asarray, npt)
    jp_new, _, jm = jstep(jp, jstep.init_opt_state(jp),
                          jax.tree.map(jnp.asarray, b))
    step = make_train_step(tcfg, adamw(lr=1e-3), grad_compress=True)
    tp = params_from_numpy(npt, tcfg, device="cpu")
    opt = step.init_opt_state(tp)
    assert set(opt) == {"opt", "ef"}
    tp, opt, tm = step(tp, opt, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
    _close(tm["loss"], jm["loss"], "model_loss/cpu_fp32")
    jnew = jax.tree.map(np.asarray, jp_new)
    for path, t in _paths(tp):
        np.testing.assert_allclose(t.detach().numpy(), _get(jnew, path),
                                   atol=2 * 1e-3, rtol=0)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def test_adafactor_update_matches_jax():
    rng = np.random.default_rng(3)
    p = {"w": rng.normal(size=(6, 5)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    jo = j_adafactor(lr=1e-2, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, p)
    js = jo.init(jp)
    to = adafactor(lr=1e-2, weight_decay=0.01)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = to.init(tp)
    for _ in range(2):
        jp, js, jn = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tn = to.update({k: torch.from_numpy(v.copy())
                                for k, v in g.items()}, ts, tp)
        _close(tn, jn, "model_loss/cpu_fp32")
        for k in p:
            _close(tp[k], jp[k], "model_loss/cpu_fp32")


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 150])
def test_schedules_match_jax(step):
    s_j = jnp.asarray(step, jnp.int32)
    s_t = torch.tensor(step, dtype=torch.int32)
    for jf, tf in ((j_cosine(3e-4, 10, 100), cosine_schedule(3e-4, 10, 100)),
                   (j_warmup(1e-3, 20), linear_warmup(1e-3, 20))):
        np.testing.assert_allclose(float(tf(s_t)), float(jf(s_j)),
                                   rtol=1e-6, atol=1e-12)
        assert float(tf(step)) == float(tf(s_t))


def test_pick_optimizer_policy():
    assert pick_optimizer(7_000_000_000).name == "adamw"
    assert pick_optimizer(405_000_000_000).name == "adafactor"


# ---------------------------------------------------------------------------
# data: the same tokens bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,M,seed,step", [
    (512, 16, 8, 2, 0, 0), (152064, 64, 4, 1, 3, 7), (1000, 33, 6, 3, 1, 2)])
def test_data_matches_jax_bit_for_bit(vocab, seq, batch, M, seed, step):
    tc = DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                    microbatches=M, seed=seed)
    jc = JDataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                     microbatches=M, seed=seed)
    got, want = global_batch_at(tc, step), j_global_batch_at(jc, step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    n = 2 if (batch // M) % 2 == 0 else 1
    for s in range(n):
        g, w = shard_batch_at(tc, step, s, n), j_shard_batch_at(jc, step, s, n)
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


# ---------------------------------------------------------------------------
# checkpoints (mirroring tests/test_ckpt_loop.py)
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "bf": (torch.arange(6.0) / 7).to(torch.bfloat16),
            "nested": {"b": torch.ones((5,), dtype=torch.int32),
                       "count": torch.zeros((), dtype=torch.int32)}}


def _assert_tree_equal(a, b):
    for (pa, x), (pb, y) in zip(_paths(a), _paths(b)):
        assert pa == pb and x.dtype == y.dtype and x.shape == y.shape, pa
        assert torch.equal(x, y), pa


def test_checkpoint_roundtrip_keeps_bf16_bits(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t, extras={"note": "hi"})
    assert find_latest(str(tmp_path)) == 7
    restored, manifest = load_checkpoint(str(tmp_path), 7, t)
    assert manifest["extras"]["note"] == "hi"
    dtypes = {e["path"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes["bf"] == "bfloat16" and dtypes["nested/b"] == "int32"
    _assert_tree_equal(t, restored)


def test_uncommitted_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    d = tmp_path / "step_00000009"        # a crash mid-write: no COMMIT
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    assert find_latest(str(tmp_path)) == 3


def test_manager_gc_keeps_last_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        m.save(s, _tree())
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_async_checkpoint_copies_before_the_step_mutates(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    t = _tree()
    want = {k: v.clone() for k, v in t.items() if torch.is_tensor(v)}
    m.save(5, t)
    t["a"].add_(1.0)                      # the next step updates in place
    t["bf"].mul_(2)
    m.wait()
    assert m.latest() == 5
    restored, _ = load_checkpoint(str(tmp_path), 5, t)
    assert torch.equal(restored["a"], want["a"])
    assert torch.equal(restored["bf"], want["bf"])


def test_load_checkpoint_checks_shapes(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), 1, bad)
    with pytest.raises(KeyError):
        load_checkpoint(str(tmp_path), 1, {**_tree(), "extra": torch.ones(1)})


# ---------------------------------------------------------------------------
# the loop: preemption, resume, stragglers
# ---------------------------------------------------------------------------

KW = dict(use_reduced=True, seq_len=16, global_batch=4, total_steps=8,
          ckpt_every=3, device="cpu")


def test_preemption_then_resume_repeats_the_uninterrupted_losses(tmp_path):
    whole = build_trainer("qwen2-7b", ckpt_dir=str(tmp_path / "a"),
                          **KW).run()
    loop = build_trainer("qwen2-7b", inject_preemption_at=5,
                         ckpt_dir=str(tmp_path / "b"), **KW)
    with pytest.raises(PreemptionError):
        loop.run()
    assert find_latest(str(tmp_path / "b")) == 5
    state = build_trainer("qwen2-7b", ckpt_dir=str(tmp_path / "b"),
                          **KW).run()
    assert state.resumed_from == 5 and state.step == 8
    assert loop.state.losses == whole.losses[:5]
    assert state.losses == whole.losses[5:]
    assert all(np.isfinite(whole.losses))


def test_straggler_detection(tmp_path, monkeypatch):
    """Step 6 takes 10x the others on the loop's clock.  The clock is a fake
    that the batch function advances, so the test does not depend on how
    loaded the machine running it is."""
    import types

    import repro_torch.train.loop as loop_mod
    clock = types.SimpleNamespace(t=0.0)
    monkeypatch.setattr(loop_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: clock.t))
    loop = build_trainer("qwen2-7b", use_reduced=True, seq_len=16,
                         global_batch=4, total_steps=8, ckpt_every=100,
                         ckpt_dir=str(tmp_path), device="cpu")
    events = []
    loop.on_straggler = lambda step, dt: events.append(step)
    orig = loop.batch_fn

    def timed_batch(step):
        clock.t += 10.0 if step == 6 else 1.0   # step 6 straggles
        return orig(step)

    loop.batch_fn = timed_batch
    state = loop.run()
    assert state.stragglers == [(6, 10.0)] and events == [6]


def test_build_trainer_raises_without_cuda_or_with_a_mesh(tmp_path):
    """Without CUDA and without ``device="cpu"`` it raises; a mesh is taken
    (the distributed slice) only once it has ranks: one built for the
    policy alone, with no process group, is refused before anything is
    allocated."""
    from repro_torch.distributed import Mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_trainer("qwen2-7b", ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="no ranks"):
        build_trainer("qwen2-7b", mesh=Mesh(shape={"data": 2, "model": 4}),
                      device="cpu", ckpt_dir=str(tmp_path))


def test_train_cli_on_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "4", "--ckpt-dir", str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trained 4 steps" in out.stdout
    assert find_latest(str(tmp_path)) == 4


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_update_takes_step_as_the_reference_does(name):
    """``update(grads, state, params, step=None)`` is the reference's
    signature; ``step`` is accepted and ignored (the count is in the
    state), so passing it changes nothing."""
    import inspect
    import repro.optim as j_optim
    import repro_torch.optim as t_optim
    j_upd = getattr(j_optim, name)().update
    t_make = getattr(t_optim, name)
    assert "step" in inspect.signature(j_upd).parameters
    assert inspect.signature(t_make().update).parameters["step"].default \
        is None
    rng = np.random.default_rng(3)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))}
    outs = []
    for kw in ({}, {"step": 7}):
        opt = t_make(lr=1e-2)
        params = {"w": p["w"].clone()}
        state = opt.init(params)
        outs.append(opt.update(g, state, params, **kw)[0]["w"])
    assert torch.equal(outs[0], outs[1])
