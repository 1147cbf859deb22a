"""The port's serving path against the JAX package's, on the CPU, and the
port's isolation from JAX.

* Greedy token streams: the same requests through JAX's ``prefill`` /
  ``decode_step`` (driven as ``repro/launch/serve.py`` drives them) and
  through the port's ``serve_requests``, with JAX's parameters carried
  across, are identical.
* ``serve_demo(device="cpu")`` serves the same request, step and token
  counts as ``repro.launch.serve.serve_demo``.
* ``serve_demo()`` with no CUDA device raises.
* ``check_card_config`` refuses, before any parameter is allocated, a config
  that the CUDA kernels do not take (the reduced fp32, head-dim-32 ones) on
  a CUDA device, and takes every published config the port serves.
* Importing every ``repro_torch`` module pulls in neither jax nor repro.
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
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serve.batcher import Batcher as JaxBatcher
from repro.serve.batcher import Request as JaxRequest
from repro.serve.step import make_decode_step as jax_make_decode_step
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import check_card_config
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.launch.serve import serve_demo, serve_requests
from repro_torch.models import params_from_numpy
from repro_torch.serve.batcher import Request

SRC = Path(__file__).resolve().parent.parent / "src"


def _jax_streams(params, cfg, prompts, *, n_lanes, max_new, max_len):
    """JAX's wave loop of ``repro/launch/serve.py`` over the given prompts;
    returns {rid: generated tokens}."""
    decode = jax.jit(jax_make_decode_step(cfg))
    prefill_fn = jax.jit(lambda p, i: jax_prefill(p, i, cfg,
                                                  max_len=max_len))
    prompt_len = prompts.shape[1]
    batcher = JaxBatcher(n_lanes=n_lanes, max_len=max_len)
    for rid, prompt in enumerate(prompts):
        batcher.submit(JaxRequest(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new))
    while not batcher.idle:
        wave = batcher.admit()
        if not wave:
            break
        batch = np.zeros((n_lanes, prompt_len), np.int32)
        for lane, req in wave:
            batch[lane] = req.prompt
        logits, state = prefill_fn(params, {"tokens": jnp.asarray(batch)})
        nxt = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        while batcher.active_lanes():
            batcher.record_tokens(nxt[:, 0])
            nxt_j, _, state = decode(params, state, jnp.asarray(nxt))
            nxt = np.asarray(nxt_j)
    return {r.rid: list(r.generated) for r in batcher.finished}


@pytest.mark.parametrize("vocab", [512, 500])
def test_greedy_token_streams_match_jax(vocab):
    jcfg = dataclasses.replace(reduced(get_config("qwen2-7b")), vocab=vocab)
    tcfg = dataclasses.replace(t_reduced(t_get_config("qwen2-7b")),
                               vocab=vocab)
    rng = np.random.default_rng(7)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(7)))
    tree["layers"]["attn"]["bq"] = rng.normal(
        size=tree["layers"]["attn"]["bq"].shape).astype(np.float32) * 0.1
    tree["final_norm"]["w"] = (1 + 0.1 * rng.normal(
        size=tree["final_norm"]["w"].shape)).astype(np.float32)
    n_req, n_lanes, prompt_len, max_new, max_len = 6, 4, 8, 5, 24
    prompts = rng.integers(0, vocab, (n_req, prompt_len)).astype(np.int32)

    want = _jax_streams(jax.tree.map(jnp.asarray, tree), jcfg, prompts,
                        n_lanes=n_lanes, max_new=max_new, max_len=max_len)
    stats, finished = serve_requests(
        params_from_numpy(tree, tcfg, device="cpu"), tcfg,
        [Request(rid=i, prompt=p, max_new_tokens=max_new)
         for i, p in enumerate(prompts)],
        n_lanes=n_lanes, prompt_len=prompt_len, max_len=max_len,
        device="cpu")
    got = {r.rid: list(r.generated) for r in finished}
    assert got == want
    assert stats["requests"] == n_req
    assert stats["tokens"] == n_req * max_new
    assert all(t < vocab for toks in got.values() for t in toks)


def test_serve_demo_counts_match_jax():
    kw = dict(n_requests=5, n_lanes=2, prompt_len=8, max_new=4, max_len=16)
    want = jax_serve_demo("qwen2-7b", **kw)
    got = serve_demo("qwen2-7b", device="cpu", **kw)
    for key in ("requests", "decode_steps", "tokens"):
        assert got[key] == want[key], key
    assert len(got["prefill_s"]) == 3                    # waves of 2, 2, 1


def test_serve_demo_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_demo("qwen2-7b")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_card_config_check_refuses_reduced_configs(arch):
    cfg = t_reduced(t_get_config(arch))
    for training in (False, True):
        with pytest.raises(ValueError, match="--full") as err:
            check_card_config(cfg, "cuda", training=training)
        assert "dtype float32" in str(err.value)
        assert f"head dim {cfg.d_head}" in str(err.value)
    check_card_config(cfg, "cpu")                 # the CPU takes any config
    check_card_config(cfg, torch.device("cpu"), training=True)


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if t_get_config(a)
                                  .family in ("dense", "moe", "hybrid",
                                              "ssm")])
def test_card_config_check_takes_published_configs(arch):
    cfg = t_get_config(arch)
    check_card_config(cfg, "cuda")
    check_card_config(cfg, torch.device("cuda", 0))
    # training reaches the flash backward, built at head dim 128 only, and
    # the SSD scan and the grouped expert matmul, which have no backward
    if cfg.family == "dense" and cfg.d_head == 128:
        check_card_config(cfg, "cuda", training=True)
    else:
        with pytest.raises(ValueError, match="has no backward|have no "
                                             "backward"):
            check_card_config(cfg, "cuda", training=True)


@pytest.mark.parametrize("training", [False, True],
                         ids=["serve", "train"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_card_config_check_names_missing_backward(arch, training):
    """Every published config is taken for serving; for training it is
    refused, naming each kernel of its path without a backward (and no
    depth flag, which cannot help), exactly when it has one."""
    cfg = t_get_config(arch)
    want = []
    if cfg.family in ("ssm", "hybrid"):
        want.append("SSD scan")
    if cfg.family == "moe":
        want.append("grouped expert matmul")
    if cfg.uses_attention and cfg.d_head != 128:
        want.append(f"flash attention at head dim {cfg.d_head}")
    if not training or not want:
        check_card_config(cfg, "cuda", training=training)
        return
    with pytest.raises(ValueError) as err:
        check_card_config(cfg, "cuda", training=True)
    msg = str(err.value)
    assert all(w in msg for w in want), msg
    assert "--layers" not in msg and "no backward" in msg


@pytest.mark.parametrize("arch", ["internvl2-76b", "musicgen-medium"])
def test_serve_demo_refuses_embedding_families(arch, monkeypatch):
    """serve_demo's prompts are tokens, as the JAX package's are: the vlm
    and audio families (fed precomputed embeddings, served through
    serve.step) raise before any parameter is allocated."""
    def no_alloc(*args, **kwargs):
        raise AssertionError("init_params ran before the check")

    monkeypatch.setattr(t_serve, "init_params", no_alloc)
    for reduced_cfg in (True, False):
        with pytest.raises(ValueError, match="precomputed embeddings"):
            serve_demo(arch, use_reduced=reduced_cfg, device="cpu")


def test_entry_points_check_the_config_before_allocating(monkeypatch):
    """On a CUDA device, serve_demo and build_trainer raise for the reduced
    config before ``init_params`` allocates anything (the device is faked:
    the check needs no card)."""
    def no_alloc(*args, **kwargs):
        raise AssertionError("init_params ran before the check")

    for mod in (t_serve, t_train):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda device=None: torch.device("cuda"))
        monkeypatch.setattr(mod, "init_params", no_alloc)
    with pytest.raises(ValueError, match="float32 and head dim 32"):
        t_serve.serve_demo("qwen2-7b")
    with pytest.raises(ValueError, match="float32 and head dim 32"):
        t_train.build_trainer("qwen2-7b")


def test_port_imports_neither_jax_nor_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.models.moe", "repro_torch.kernels.moe_gmm",
        "repro_torch.models.xlstm", "repro_torch.core.runtime",
        "repro_torch.tabular.impls", "repro_torch.data.tabular",
        "repro_torch.client", "repro_torch.core.backends.torch_segment",
        "repro_torch.core.analysis.analyzer",
        "repro_torch.agents.aide"} <= set(names)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
assert "triton" not in sys.modules
print(len(names))
"""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25       # every module was imported


def test_make_decode_step_takes_sample_as_the_reference_does():
    """``make_decode_step(cfg, sample="greedy")`` is the reference's
    signature; the argument is accepted and ignored (decoding is greedy)."""
    import inspect
    from repro_torch.serve.step import make_decode_step as t_make
    want = inspect.signature(jax_make_decode_step).parameters["sample"]
    got = inspect.signature(t_make).parameters["sample"]
    assert got.default == want.default == "greedy"
    cfg = t_reduced(t_get_config("qwen2-7b"))
    from repro_torch.models import init_params, prefill
    params = init_params(cfg, device="cpu")
    prompt = {"tokens": torch.ones(2, 4, dtype=torch.int32)}
    tok = torch.ones(2, 1, dtype=torch.int32)
    outs = []
    for kw in ({}, {"sample": "greedy"}):
        _, state = prefill(params, prompt, cfg, max_len=8)
        outs.append(t_make(cfg, **kw)(params, state, tok)[1])
    assert torch.equal(outs[0], outs[1])
