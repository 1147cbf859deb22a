"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's kernels: the Pallas kernels in interpret mode and
the ``ref.py`` oracles, on the same numpy inputs.

The hand-written CUDA/Triton kernels run only on a GPU; ``chip_smoke.py``
holds them against these plain versions there.  Here the wrappers' argument
checks and stride handling, which are plain Python, are tested too.

Tolerances (``repro_torch.kernels.common.TOLERANCES``, float32): the same
arithmetic summed in another order — 1e-5 for rmsnorm's one mean of
squares, 1e-4 for attention's softmax and two products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels import decode_attention, flash_attention, rmsnorm
from repro_torch.kernels.common import TOLERANCES, launches
from repro_torch.kernels.decode_attention.kernel import decode_launch_args
from repro_torch.kernels.flash_attention.kernel import flash_launch_args

RNG = np.random.default_rng(0)


def _np(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, key):
    atol, rtol = TOLERANCES[key]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 37, 256), (3, 5, 7, 128), (6, 3584)])
def test_rmsnorm_matches_jax(shape):
    x = _np(*shape)
    w = 1.0 + _np(shape[-1], scale=0.1)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5)
    assert got.shape == shape and got.dtype == torch.float32
    _close(got, rmsnorm_pallas(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                               interpret=True), "rmsnorm/cpu_fp32")
    _close(got, rmsnorm_ref(jnp.asarray(x), jnp.asarray(w), eps=1e-5),
           "rmsnorm/cpu_fp32")


def test_rmsnorm_bf16_keeps_dtype_fp32_stats():
    x = torch.from_numpy(_np(5, 128)).to(torch.bfloat16)
    w = torch.from_numpy(1.0 + _np(128, scale=0.1))
    got = rmsnorm(x, w)
    assert got.dtype == torch.bfloat16
    want = rmsnorm_ref(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                       jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, Hq, Hkv, S, D, causal, window)
    (1, 14, 2, 77, 32, True, 0),        # GQA group 7, S below one block
    (1, 14, 2, 200, 64, True, 0),       # S not a multiple of the block
    (1, 14, 2, 200, 64, True, 64),      # windowed
    (2, 4, 2, 150, 32, False, 0),       # not causal
]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", FLASH_CASES)
def test_flash_attention_matches_jax(B, Hq, Hkv, S, D, causal, window):
    # the model's layout: (B, S, H, D) arrays, seen by the port as
    # (B, H, S, D) strided views, by JAX as transposed copies
    q, k, v = _np(B, S, Hq, D), _np(B, S, Hkv, D), _np(B, S, Hkv, D)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    j = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    got = flash_attention(t(q), t(k), t(v), causal=causal, window=window)
    assert got.shape == (B, Hq, S, D)
    key = "flash_attention/cpu_fp32"
    _close(got, flash_attention_pallas(j(q), j(k), j(v), causal=causal,
                                       window=window, interpret=True), key)
    _close(got, attention_ref(j(q), j(k), j(v), causal=causal,
                              window=window), key)


def test_flash_launch_args_read_model_layout_through_strides():
    B, S, Hq, Hkv, D = 2, 77, 14, 2, 128
    q = torch.zeros(B, S, Hq, D, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16).transpose(1, 2)
    out = torch.empty_like(q)
    # the output keeps q's layout, so transposing back is free
    assert out.transpose(1, 2).is_contiguous()
    args = flash_launch_args(q, k, k, out, causal=True, window=0, scale=None)
    assert args[:5] == (B, Hq, Hkv, S, D)
    assert args[5:8] == (S * Hq * D, D, Hq * D)          # q (b, h, s)
    assert args[8:11] == (S * Hkv * D, D, Hkv * D)       # k (b, h, s)
    assert args[-3:] == (pytest.approx(D ** -0.5), 1, 0)


@pytest.mark.parametrize("bad", ["fp32", "head_dim", "gqa", "cross",
                                 "stride", "window"])
def test_flash_launch_args_refuse_what_the_kernel_does_not_take(bad):
    B, Hq, Hkv, S, D = 1, 4, 2, 64, 128
    dt, w = torch.bfloat16, 0
    shapes = {"q": (B, Hq, S, D), "k": (B, Hkv, S, D)}
    if bad == "fp32":
        dt = torch.float32
    elif bad == "head_dim":
        shapes = {"q": (B, Hq, S, 32), "k": (B, Hkv, S, 32)}
    elif bad == "gqa":
        shapes["k"] = (B, 3, S, D)
    elif bad == "cross":
        shapes["k"] = (B, Hkv, S + 1, D)
    elif bad == "window":
        w = -1
    q = torch.zeros(shapes["q"], dtype=dt)
    k = torch.zeros(shapes["k"], dtype=dt)
    if bad == "stride":
        q = torch.zeros(B, Hq, S, D + 4, dtype=dt)[..., :D]
    with pytest.raises((ValueError, TypeError)):
        flash_launch_args(q, k, k, torch.empty_like(q), causal=True,
                          window=w, scale=None)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [[1, 300, 137], [300, 129, 2]])
def test_decode_attention_matches_jax(lens):
    B, Hq, Hkv, S, D = 3, 14, 2, 300, 64
    q, k, v = _np(B, Hq, D), _np(B, S, Hkv, D), _np(B, S, Hkv, D)
    lengths = np.asarray(lens, np.int32)
    got, m, l = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(lengths), return_lse=True)
    want, wm, wl = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        interpret=True, block_s=128, return_lse=True)
    key = "decode_attention/cpu_fp32"
    _close(got, want, key)
    _close(got, decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lengths)),
           key)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(wl), rtol=1e-5)
    # without lengths: the whole cache
    full = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))
    _close(full, decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v)), key)


def test_decode_launch_args_and_refusals():
    B, S, Hq, Hkv, D = 8, 2048, 28, 4, 128
    q = torch.zeros(B, 1, Hq, D, dtype=torch.bfloat16)[:, 0]
    kv = torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16)
    lengths = torch.zeros(B, dtype=torch.int32)
    args = decode_launch_args(q, kv, kv, lengths, scale=None, chunk=128)
    assert args[:6] == (B, Hq, Hkv, S, D, 16)
    assert args[6:8] == (Hq * D, D)
    assert args[8:11] == (S * Hkv * D, Hkv * D, D)
    with pytest.raises(ValueError):                     # int64 lengths
        decode_launch_args(q, kv, kv, lengths.long(), scale=None, chunk=128)
    with pytest.raises(ValueError):                     # group of 14 > 8
        decode_launch_args(q, kv[:, :, :2], kv[:, :, :2], lengths,
                           scale=None, chunk=128)
    with pytest.raises(TypeError):
        decode_launch_args(q.float(), kv.float(), kv.float(), lengths,
                           scale=None, chunk=128)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_wrappers_raise_off_cpu_and_cuda_and_count_no_cpu_launch():
    before = launches()
    x = torch.zeros(2, 128)
    rmsnorm(x, torch.ones(128))
    assert launches() == before          # the plain version is no launch
    meta = torch.empty(2, 128, device="meta")
    with pytest.raises(ValueError):
        rmsnorm(meta, torch.ones(128, device="meta"))
    with pytest.raises(ValueError):      # tensors on two devices
        rmsnorm(x, torch.ones(128, device="meta"))
    qm = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(qm, qm, qm)
    with pytest.raises(ValueError):
        decode_attention(qm[:, :, 0], qm.transpose(1, 2), qm.transpose(1, 2))
