"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's kernels: the Pallas kernels in interpret mode and
the ``ref.py`` oracles, on the same numpy inputs.

The hand-written CUDA/Triton kernels run only on a GPU; ``chip_smoke.py``
holds them against these plain versions there.  Here the wrappers' argument
checks and stride handling, which are plain Python, are tested too.

Tolerances (``repro_torch.kernels.common.TOLERANCES``, float32): the same
arithmetic summed in another order — 1e-5 for rmsnorm's one mean of
squares, 1e-4 for attention's softmax and two products; the gradients and
the cross entropy have their own entries there, each with its reason.

The gradients are held against ``jax.vjp`` / ``jax.grad`` of the JAX
package's functions.  For rmsnorm and flash attention that is the plain
``ref.py`` oracle: the JAX package cannot differentiate through its Pallas
kernels of the two (``pallas_call`` has no reverse-mode rule), so its oracle
is the function they compute.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cross_entropy.kernel import ce_forward_pallas
from repro.kernels.cross_entropy.ops import _forward_chunked
from repro.kernels.cross_entropy.ops import \
    fused_cross_entropy as jax_fused_cross_entropy
from repro.kernels.cross_entropy.ref import \
    cross_entropy_ref as jax_cross_entropy_ref
from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.common import force_backend
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro.kernels.ssd.kernel import ssd_scan_pallas
from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ops import ssd_step as jax_ssd_step
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro_torch.kernels import (decode_attention, flash_attention,
                                 fused_cross_entropy, rmsnorm, ssd_scan)
from repro_torch.kernels.common import (BF16_ULPS, REL_L2, TOLERANCES,
                                        bf16_ulps, launches, rel_l2)
from repro_torch.kernels.cross_entropy.kernel import ce_launch_args
from repro_torch.kernels.cross_entropy.ops import ce_forward
from repro_torch.kernels.cross_entropy.ref import (ce_backward_chunked,
                                                   cross_entropy_ref)
from repro_torch.kernels.decode_attention.kernel import decode_launch_args
from repro_torch.kernels.flash_attention.kernel import (flash_bwd_launch_args,
                                                        flash_bwd_scratch_shape,
                                                        flash_launch_args)
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as t_attention_ref
from repro_torch.kernels.rmsnorm.kernel import (DW_SUM_WARPS,
                                                rmsnorm_bwd_launch_args)
from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd
from repro_torch.kernels.ssd.kernel import (WIDE_RECORD, bwd_workspace_bytes,
                                             ssd_launch_args,
                                             ssd_scan_bwd_cuda,
                                             wide_workspace_bytes)
from repro_torch.kernels.ssd.ops import ssd_step
from repro_torch.kernels.ssd.ref import (ssd_chunk_m, ssd_chunked_ref,
                                          ssd_ref)

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
    (1, 24, 2, 150, 192, True, 0),      # nemotron's head dim 192, group 12
    (1, 24, 2, 150, 192, True, 64),     # windowed, head dim 192
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


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (2048, 2048, True, 0),          # at the switch: chunked, two K blocks
    (2100, 2100, True, 300),        # a ragged last block, windowed
    (64, 2500, True, 0),            # queries at the end of a longer context
    (2048, 2048, False, 0),
])
def test_flash_attention_chunked_on_cpu_matches_jax(Sq, Sk, causal, window,
                                                   monkeypatch):
    """From Sk 2048 on, the CPU path runs the online softmax over K blocks
    (as ``repro``'s ``CHUNKED_MIN_SEQ``) and matches ``repro``'s
    ``attention_chunked`` within flash_attention/cpu_fp32; its lse matches
    the full score matrix's."""
    from repro.kernels.flash_attention.ref import attention_chunked as j_chk
    from repro_torch.kernels.flash_attention import ops as t_ops
    from repro_torch.kernels.flash_attention.ref import attention_chunked
    B, Hq, Hkv, D = 1, 2, 1, 32
    q, k, v = _np(B, Sq, Hq, D), _np(B, Sk, Hkv, D), _np(B, Sk, Hkv, D)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    j = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    calls = []
    real = t_ops.attention_chunked
    monkeypatch.setattr(t_ops, "attention_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = t_ops._forward(t(q), t(k), t(v), causal, window, None)
    assert calls == [1]                     # the chunked path was taken
    key = "flash_attention/cpu_fp32"
    _close(got, j_chk(j(q), j(k), j(v), causal=causal, window=window), key)
    out, lse = attention_chunked(t(q), t(k), t(v), causal=causal,
                                 window=window, return_lse=True)
    _, want_lse = t_attention_ref(t(q), t(k), t(v), causal=causal,
                                  window=window, return_lse=True)
    assert torch.equal(out, got)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5,
                               atol=1e-5)


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


@pytest.mark.parametrize("layout", ["bhsd", "bshd", "sbhd"])
def test_flash_launch_args_take_any_order_of_strides(layout):
    """The kernel's tensor maps order the (batch, head, seq) dimensions by
    stride, so q, k, v may each come in any of these layouts: the call
    passes their strides as they are and refuses none of them."""
    B, S, Hq, Hkv, D = 2, 129, 4, 2, 64
    perm = {"bhsd": (0, 1, 2, 3), "bshd": (0, 2, 1, 3),
            "sbhd": (1, 2, 0, 3)}[layout]
    inv = [perm.index(i) for i in range(4)]

    def make(H):
        shape = [(B, H, S, D)[i] for i in perm]
        return torch.zeros(shape, dtype=torch.bfloat16).permute(*inv)

    q, k = make(Hq), make(Hkv)
    assert q.shape == (B, Hq, S, D)
    out = torch.empty_like(q)
    args = flash_launch_args(q, k, k, out, causal=True, window=0, scale=None)
    assert args[:5] == (B, Hq, Hkv, S, D)
    assert args[5:8] == q.stride()[:3]
    assert args[8:11] == k.stride()[:3]


def test_flash_launch_args_take_head_dim_192():
    """nemotron-4-340b's prefill: 96 q heads over 8 kv heads of 192, read
    through the model's (B, S, H, D) layout; 96 and 256 stay refused."""
    B, S, Hq, Hkv, D = 2, 77, 96, 8, 192
    q = torch.zeros(B, S, Hq, D, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16).transpose(1, 2)
    out = torch.empty_like(q)
    args = flash_launch_args(q, k, k, out, causal=True, window=0, scale=None)
    assert args[:5] == (B, Hq, Hkv, S, D)
    assert args[5:8] == (S * Hq * D, D, Hq * D)
    assert args[-3:] == (pytest.approx(D ** -0.5), 1, 0)
    for d in (96, 256):
        qd = torch.zeros(B, Hq, S, d, dtype=torch.bfloat16)
        kd = torch.zeros(B, Hkv, S, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            flash_launch_args(qd, kd, kd, torch.empty_like(qd), causal=True,
                              window=0, scale=None)


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

@pytest.mark.parametrize("Hq,Hkv,D", [
    (14, 2, 64),        # group 7
    (24, 2, 128),       # group 12 (starcoder2-15b)
    (32, 2, 128),       # group 16 (llama3-405b)
    (24, 2, 192)])      # group 12 at head dim 192 (nemotron-4-340b)
@pytest.mark.parametrize("lens", [[1, 300, 137], [300, 129, 2]])
def test_decode_attention_matches_jax(lens, Hq, Hkv, D):
    B, S = 3, 300
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
    # any group: 14 over 2 and 16 over 1 (llama3-405b's group)
    for q_, kv_ in ((q[:, :14], kv[:, :, :1]), (q[:, :16], kv[:, :, :1]),
                    (q, kv[:, :, :2])):
        G = q_.shape[1] // kv_.shape[2]
        got = decode_launch_args(q_, kv_, kv_, lengths, scale=None,
                                 chunk=128)
        assert got[1] // got[2] == G
    # head dim 192 (nemotron-4-340b: 96 q heads over 8 kv heads)
    q192 = torch.zeros(B, 1, 96, 192, dtype=torch.bfloat16)[:, 0]
    kv192 = torch.zeros(B, S, 8, 192, dtype=torch.bfloat16)
    args = decode_launch_args(q192, kv192, kv192, lengths, scale=None,
                              chunk=128)
    assert args[:6] == (B, 96, 8, S, 192, 16)
    assert args[-1] == pytest.approx(192 ** -0.5)
    with pytest.raises(ValueError):                     # head dim 96
        decode_launch_args(q[..., :96], kv[..., :96], kv[..., :96], lengths,
                           scale=None, chunk=128)
    with pytest.raises(ValueError):                     # 28 over 3 heads
        decode_launch_args(q, kv[:, :, :3], kv[:, :, :3], lengths,
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
    with pytest.raises(ValueError):
        fused_cross_entropy(meta, torch.empty(128, 8, device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"))


def test_cpu_gradients_count_no_launch():
    """The training wrappers on the CPU (forward and backward of rmsnorm,
    flash attention and the cross entropy) run their plain versions: no
    counter of any kernel moves."""
    before = launches()
    assert {"cross_entropy", "flash_attention_bwd",
            "rmsnorm_bwd"} <= set(before)
    x = torch.randn(2, 5, 64, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    q = torch.randn(1, 4, 5, 32, requires_grad=True)
    kv = torch.randn(1, 2, 5, 32, requires_grad=True)
    y = rmsnorm(x, w)
    o = flash_attention(q, kv, kv)
    loss = fused_cross_entropy(y, torch.randn(64, 40),
                               torch.zeros(2, 5, dtype=torch.int32))
    (loss + o.sum()).backward()
    assert x.grad is not None and q.grad is not None and kv.grad is not None
    assert launches() == before


# ---------------------------------------------------------------------------
# gradients: rmsnorm and flash attention against jax.vjp of the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 37, 256), (6, 3584)])
def test_rmsnorm_grad_matches_jax(shape):
    x = _np(*shape)
    w = 1.0 + _np(shape[-1], scale=0.1)
    dy = _np(*shape)
    _, vjp = jax.vjp(lambda x, w: rmsnorm_ref(x, w, eps=1e-5),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    key = "rmsnorm_bwd/cpu_fp32"
    # the plain backward itself
    dx, dw = rmsnorm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(dy), eps=1e-5)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    _close(dx, jdx, key)
    _close(dw, jdw, key)
    # and through autograd (the Function the model calls)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    rmsnorm(tx, tw, eps=1e-5).backward(torch.from_numpy(dy))
    _close(tx.grad, jdx, key)
    _close(tw.grad, jdw, key)


# The CUDA backward's launch (csrc/rmsnorm_bwd.cu): (rows, D, dtype, start
# offset in elements) -> (path, grid, threads, vectors a thread, ring slots,
# dynamic shared bytes), at 132 SMs.  Block b takes rows b, b + grid, ....
# The bulk path's shared memory is the 384-byte head, w's fp32 copy and the
# slots of x and dy rows.
BWD_LAUNCHES = {
    # the train step's shape: 448 threads x 8 bf16 cover D exactly; two
    # blocks an SM of 2 slots each
    "D3584 bf16": ((8192, 3584, torch.bfloat16, 0),
                   ("bulk", 264, 448, 1, 2, 384 + 4 * 3584
                    + 2 * 2 * 7168)),
    # nemotron-4-340b's width: 2304 vectors, 8 a thread, one block an SM;
    # w's copy (72 KB) leaves room for 2 slots of 72 KB
    "D18432 bf16": ((264, 18432, torch.bfloat16, 0),
                    ("bulk", 132, 288, 8, 2, 384 + 4 * 18432
                     + 2 * 2 * 36864)),
    # rows of 2002 bytes: not 16-byte aligned, the second path
    "D1001 bf16": ((77, 1001, torch.bfloat16, 0),
                   ("rows", 77, 512, 0, 0, 0)),
    # rows of 256 KB: x and dy do not fit 2 slots in 227 KB
    "D65536 fp32": ((16, 65536, torch.float32, 0),
                    ("rows", 16, 512, 0, 0, 0)),
    # an aligned width starting one element into its buffer
    "D3584 bf16 offset": ((300, 3584, torch.bfloat16, 1),
                          ("rows", 132, 512, 0, 0, 0)),
    "0 rows": ((0, 3584, torch.bfloat16, 0),
               ("bulk", 0, 448, 1, 2, 384 + 4 * 3584 + 2 * 2 * 7168)),
}


@pytest.mark.parametrize("case", list(BWD_LAUNCHES))
def test_rmsnorm_bwd_launch_args(case):
    (rows, D, dt, off), want = BWD_LAUNCHES[case]
    buf = torch.empty(rows * D + off, dtype=dt)
    x = buf[off:].view(rows, D)
    w = torch.ones(D)
    x2, dy2, a = rmsnorm_bwd_launch_args(x, w, x, sms=132)
    assert x2.shape == dy2.shape == (rows, D)
    got = tuple(a[k] for k in ("path", "grid", "threads", "vpt", "stages",
                               "smem"))
    assert got == want
    assert (a["rows"], a["D"], a["sx"], a["sdy"]) == (rows, D, D, D)
    assert a["kind"] == {torch.float32: 0, torch.bfloat16: 1}[dt]
    assert a["grid"] <= min(rows, 2 * 132)        # every block takes a row
    if a["path"] == "bulk":
        blocks_an_sm = 2 if a["vpt"] == 1 else 1
        assert blocks_an_sm * (a["smem"] + 1024) <= 232448 + 1024
        assert a["stages"] >= 2
        assert a["threads"] % 32 == 0 and \
            a["threads"] * a["vpt"] * 16 >= D * x.element_size()
    if case == "D3584 bf16":                      # 4 rows in flight an SM
        assert a["threads"] * a["vpt"] * 8 == D and 2 * a["stages"] >= 3


@pytest.mark.parametrize("bad", ["weight_dtype", "too_wide", "dy_shape",
                                 "dy_dtype"])
def test_rmsnorm_bwd_launch_args_refuse(bad):
    D = 65537 if bad == "too_wide" else 256
    x = torch.zeros(4, D, dtype=torch.bfloat16)
    w = torch.ones(D, dtype=torch.bfloat16 if bad == "weight_dtype"
                   else torch.float32)
    dy = {"dy_shape": torch.zeros(5, D, dtype=torch.bfloat16),
          "dy_dtype": torch.zeros(4, D)}.get(bad, x)
    err = TypeError if bad == "weight_dtype" else ValueError
    with pytest.raises(err):
        rmsnorm_bwd_launch_args(x, w, dy, sms=132)


def _dw_in_kernel_order(x, dy, w, eps, grid):
    """dw as csrc/rmsnorm_bwd.cu sums it, in fp32: block b's partial adds
    dy·x̂ over its rows b, b + grid, ... in order; rms_dw_sum_kernel sums
    the partials by DW_SUM_WARPS residues (blocks b ≡ k, in increasing b),
    then the residues in order."""
    rstd = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    contrib = dy * (x * rstd)
    parts = []
    for b in range(grid):
        acc = torch.zeros(x.shape[-1])
        for row in range(b, x.shape[0], grid):
            acc = acc + contrib[row]
        parts.append(acc)
    dw = torch.zeros(x.shape[-1])
    for k in range(DW_SUM_WARPS):
        res = torch.zeros(x.shape[-1])
        for b in range(k, grid, DW_SUM_WARPS):
            res = res + parts[b]
        dw = dw + res
    return dw


@pytest.mark.parametrize("rows,D", [(300, 96), (77, 1001)])
def test_rmsnorm_bwd_dw_in_kernel_order_matches_jax(rows, D):
    """dw summed as the kernel sums it (per-block partials over the rows
    b, b + grid, ..., then the partials by warp residue) against jax.grad
    of the JAX oracle, at a launch of many blocks (264 over 300 rows; 77 of
    one row)."""
    x, dy = _np(rows, D), _np(rows, D)
    w = 1.0 + _np(D, scale=0.1)
    _, vjp = jax.vjp(lambda w: rmsnorm_ref(jnp.asarray(x), w, eps=1e-5),
                     jnp.asarray(w))
    (jdw,) = vjp(jnp.asarray(dy))
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    a = rmsnorm_bwd_launch_args(tx, tw, tdy, sms=132)[2]
    assert a["grid"] > 8                          # every warp residue used
    got = _dw_in_kernel_order(tx, tdy, tw, 1e-5, a["grid"])
    np.testing.assert_allclose(got.numpy(), np.asarray(jdw), atol=1e-5,
                               rtol=1e-5)


GRAD_CASES = [
    # (B, Hq, Hkv, S, D, causal, window)
    (2, 4, 2, 45, 32, True, 0),         # GQA 4/2, causal
    (1, 7, 1, 70, 32, True, 0),         # GQA 7/1 (qwen2-7b's group)
    (1, 4, 2, 60, 32, True, 16),        # windowed
    (2, 4, 2, 33, 16, False, 0),        # not causal
]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,window", GRAD_CASES)
def test_flash_attention_grad_matches_jax(B, Hq, Hkv, S, D, causal, window):
    q, k, v = _np(B, S, Hq, D), _np(B, S, Hkv, D), _np(B, S, Hkv, D)
    do = _np(B, S, Hq, D)
    j = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    _, vjp = jax.vjp(lambda q, k, v: attention_ref(q, k, v, causal=causal,
                                                   window=window),
                     j(q), j(k), j(v))
    want = vjp(j(do))
    key = "flash_attention_bwd/cpu_fp32"
    # through autograd, on the model's (B, S, H, D) layout seen as
    # (B, H, S, D) views
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    views = [t.transpose(1, 2) for t in leaves]
    o = flash_attention(*views, causal=causal, window=window)
    o.backward(torch.from_numpy(do).transpose(1, 2))
    for t, w_ in zip(leaves, want):
        _close(t.grad.transpose(1, 2), w_, key)
    # the plain backward from the forward's saved o and lse
    o, lse = t_attention_ref(*[t.detach() for t in views], causal=causal,
                             window=window, return_lse=True)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    got = flash_attention_bwd(*[t.detach() for t in views], o, lse,
                              torch.from_numpy(do).transpose(1, 2),
                              causal=causal, window=window)
    for g, w_ in zip(got, want):
        _close(g, w_, key)


@pytest.mark.parametrize("Hq,Hkv,S,causal,window", [
    (7, 1, 256, True, 0), (4, 2, 300, True, 64), (4, 2, 200, False, 0)])
def test_flash_bwd_rel_l2_limit_rejects_dropped_delta(
        Hq, Hkv, S, causal, window):
    """The card's whole-tensor check (REL_L2) at head dim 128 in bf16:
    dropping Delta = rowsum(dO∘O), planted as o = 0 as chip_smoke.py does,
    moves dq and dk far past its limit and leaves dv as it was."""
    limit = REL_L2["flash_attention_bwd/card_bf16"]
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2)
    q, k, v = bf(_np(1, S, Hq, 128)), bf(_np(1, S, Hkv, 128)), \
        bf(_np(1, S, Hkv, 128))
    do = bf(_np(1, S, Hq, 128))
    opts = dict(causal=causal, window=window)
    o, lse = t_attention_ref(q, k, v, return_lse=True, **opts)
    sound = flash_attention_bwd(q, k, v, o, lse, do, **opts)
    dropped = flash_attention_bwd(q, k, v, torch.zeros_like(o), lse, do,
                                  **opts)
    assert rel_l2(dropped[0], sound[0]) > 10 * limit
    assert rel_l2(dropped[1], sound[1]) > 10 * limit
    assert torch.equal(dropped[2], sound[2])


def test_attention_lse_is_the_row_logsumexp():
    q, k = _np(1, 2, 9, 16), _np(1, 1, 9, 16)
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, 2, axis=1)) * 16 ** -0.5
    s = np.where(np.tril(np.ones((9, 9), bool)), s, -np.inf)
    want = np.log(np.exp(s).sum(-1))
    _, lse = t_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k), return_lse=True)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# fused LM-head cross entropy
# ---------------------------------------------------------------------------

def _ce_inputs(T, D, V, n_labels=None, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(T, D)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    lab = rng.integers(0, n_labels or V, T).astype(np.int32)
    return x, w, lab


@pytest.mark.parametrize("T,D,V", [(128, 64, 1000), (64, 32, 513),
                                   (100, 32, 4096)])
def test_ce_forward_matches_pallas_and_chunked(T, D, V):
    """n_valid == V: the port's forward against the Pallas kernel in
    interpret mode (the branch the JAX package takes on a TPU) and against
    the chunked forward (the branch below it)."""
    x, w, lab = _ce_inputs(T, D, V)
    lse, ll = ce_forward(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(lab))
    key = "cross_entropy/cpu_fp32"
    lp, llp = ce_forward_pallas(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(lab), interpret=True,
                                block_t=64, block_v=256)
    _close(lse, lp, key)
    _close(ll, llp, key)
    lc, llc = _forward_chunked(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(lab), V)
    _close(lse, lc, key)
    _close(ll, llc, key)
    loss = cross_entropy_ref(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(lab))
    _close(loss, jax_cross_entropy_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(lab)), key)


@pytest.mark.parametrize("T,D,V,n_valid", [(64, 32, 256, 200),
                                           (50, 32, 9000, 8500)])
def test_ce_forward_padded_head_masks_exactly(T, D, V, n_valid):
    """n_valid < V with the padding columns poisoned: against JAX's chunked
    forward and against the oracle on the valid columns alone."""
    x, w, lab = _ce_inputs(T, D, V, n_labels=n_valid)
    w[:, n_valid:] = 100.0
    lse, ll = ce_forward(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(lab), n_valid=n_valid)
    key = "cross_entropy/cpu_fp32"
    lc, llc = _forward_chunked(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(lab), n_valid)
    _close(lse, lc, key)
    _close(ll, llc, key)
    loss = fused_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(lab), n_valid=n_valid)
    _close(loss, jax_cross_entropy_ref(jnp.asarray(x),
                                       jnp.asarray(w[:, :n_valid]),
                                       jnp.asarray(lab)), key)


@pytest.mark.parametrize("T,D,V,n_valid", [(64, 32, 500, 500),
                                           (40, 32, 9000, 8700)])
def test_ce_grad_matches_jax(T, D, V, n_valid):
    """dx and dw of the port's autograd.Function against jax.grad of the JAX
    package's fused_cross_entropy, with some tokens masked out; the second
    case spans two 8192-column chunks and a padded head."""
    x, w, lab = _ce_inputs(T, D, V, n_labels=n_valid)
    valid = np.random.default_rng(1).random(T) > 0.2
    gx, gw = jax.grad(
        lambda x, w: 3.0 * jax_fused_cross_entropy(
            x, w, jnp.asarray(lab), valid=jnp.asarray(valid),
            n_valid=n_valid), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = fused_cross_entropy(tx, tw, torch.from_numpy(lab),
                               valid=torch.from_numpy(valid),
                               n_valid=n_valid)
    (3.0 * loss).backward()
    key = "cross_entropy_bwd/cpu_fp32"
    _close(tx.grad, gx, key)
    _close(tw.grad, gw, key)
    # the plain backward on its own: dtype kept, columns past n_valid zero
    lse, _ = ce_forward(tx.detach(), tw.detach(), torch.from_numpy(lab),
                        n_valid)
    dx, dw = ce_backward_chunked(
        tx.detach().to(torch.bfloat16), tw.detach().to(torch.bfloat16),
        torch.from_numpy(lab), torch.from_numpy(valid), lse,
        torch.tensor(3.0), n_valid)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert not dw[:, n_valid:].any()


def test_ce_launch_args_and_refusals():
    T, D, V = 8192, 3584, 152064
    x = torch.zeros(T, D, dtype=torch.bfloat16)
    w = torch.zeros(D, V, dtype=torch.bfloat16)
    lab = torch.zeros(T, dtype=torch.int32)
    # the training path's shape: 74 full 2048-column splits and a tail
    assert ce_launch_args(x, w, lab, V, 2048) == (T, D, V, V, 75)
    with pytest.raises(ValueError):                      # int64 labels
        ce_launch_args(x, w, lab.long(), V, 2048)
    with pytest.raises(TypeError):                       # fp32
        ce_launch_args(x.float(), w.float(), lab, V, 2048)
    with pytest.raises(ValueError):                      # V % 8
        ce_launch_args(x, w[:, :1001], lab, 1001, 2048)
    with pytest.raises(ValueError):                      # n_valid > V
        ce_launch_args(x, w, lab, V + 1, 2048)
    with pytest.raises(ValueError):                      # not contiguous
        ce_launch_args(x[:, :1024], w[:1024], lab, V, 2048)


@pytest.mark.parametrize("T,D,V,n_valid,n_split", [
    (8192, 3584, 152064, 152064, 594),   # the train step: 594 tiles exactly
    (1000, 3584, 152064, 151000, 594),   # ragged T, padded head
    (129, 3616, 5000, 4000, 20),         # D = 56·64 + 32, V a ragged tile
    (128, 256, 512, 512, 2),             # the TrainLoop check's shape
])
def test_ce_scratch_at_the_kernels_tile(T, D, V, n_valid, n_split):
    """The wrapper sizes the (3, n_split, T) scratch from the kernel's tile
    of 256 columns (cross_entropy_split() in csrc/cross_entropy.cu); a D
    that is 32 mod 64 is taken (its last slice reads zeros past D)."""
    x = torch.zeros(T, D, dtype=torch.bfloat16)
    w = torch.zeros(D, V, dtype=torch.bfloat16)
    lab = torch.zeros(T, dtype=torch.int32)
    assert ce_launch_args(x, w, lab, n_valid, 256) == (T, D, V, n_valid,
                                                       n_split)
    with pytest.raises(ValueError):                      # D % 32
        ce_launch_args(x[:, :D - 16].contiguous(), w[:D - 16], lab, n_valid,
                       256)


@pytest.mark.parametrize("S,S_pad", [(2048, 2048), (129, 256), (77, 128),
                                     (1, 128), (1000, 1024)])
def test_flash_bwd_scratch_rows_padded(S, S_pad):
    """The backward's (lse·log2e, Delta) rows are padded to the kernels'
    multiple of 128 (flash_attention_bwd_rows() in
    csrc/flash_attention_bwd.cu), so that every 64- and 128-row tile's rows
    are one aligned bulk copy."""
    q = torch.zeros(2, S, 7, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert flash_bwd_scratch_shape(q, 128) == (2, 7, S_pad, 2)


# ---------------------------------------------------------------------------
# head dim 64 (zamba2's shared attention block)
# ---------------------------------------------------------------------------

def test_flash_and_decode_take_head_dim_64_and_the_backward_does_not():
    B, S, H, D = 2, 77, 4, 64
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    out = torch.empty_like(q)
    args = flash_launch_args(q, q, q, out, causal=True, window=0, scale=None)
    assert args[:5] == (B, H, H, S, D)
    assert args[-3] == pytest.approx(D ** -0.5)
    kv = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    lengths = torch.full((B,), S, dtype=torch.int32)
    dargs = decode_launch_args(q[:, :, 0], kv, kv, lengths, scale=None,
                               chunk=128)
    assert dargs[:6] == (B, H, H, S, D, 1)
    # the backward is built at 64 (granite-moe-3b-a800m's training) and
    # 128; 192 stays refused (queued in ROADMAP.md)
    lse = torch.zeros(B, H, S)
    for d in (64, 128):
        qd = torch.zeros(B, S, H, d, dtype=torch.bfloat16).transpose(1, 2)
        bargs = flash_bwd_launch_args(
            qd, qd, qd, torch.empty_like(qd), lse, qd,
            *[torch.empty_like(qd) for _ in range(3)], causal=True, window=0,
            scale=None)
        assert bargs[:5] == (B, H, H, S, d) and len(bargs) == 5 + 24 + 3
    q192 = torch.zeros(B, S, H, 192, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="backward"):
        flash_bwd_launch_args(q192, q192, q192, torch.empty_like(q192), lse,
                              q192, *[torch.empty_like(q192)
                                      for _ in range(3)],
                              causal=True, window=0, scale=None)


# ---------------------------------------------------------------------------
# ssd scan
# ---------------------------------------------------------------------------

def _ssd_inputs(B, H, S, N, P):
    """tests/test_kernels.py's distributions: |log_a| ~ 0.1, gate ~ 0.5."""
    return (_np(B, H, S, N), _np(B, H, S, N, scale=0.3), _np(B, H, S, P),
            -np.abs(_np(B, H, S, scale=0.1)), np.abs(_np(B, H, S, scale=0.5)))


@pytest.mark.parametrize("B,H,S,N,P,chunk", [
    (1, 2, 256, 16, 32, 64), (2, 1, 128, 8, 16, 32), (1, 3, 192, 64, 64, 64),
])
def test_ssd_scan_matches_jax_ref_and_pallas(B, H, S, N, P, chunk):
    args = _ssd_inputs(B, H, S, N, P)
    y, s = ssd_scan(*map(torch.from_numpy, args))
    assert y.shape == (B, H, S, P) and s.shape == (B, H, N, P)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    key = "ssd/cpu_fp32"
    jargs = list(map(jnp.asarray, args))
    for want_y, want_s in (jax_ssd_ref(*jargs),
                           ssd_scan_pallas(*jargs, interpret=True,
                                           chunk=chunk)):
        _close(y, want_y, key)
        _close(s, want_s, key)


def test_ssd_scan_ragged_matches_jax_padded_scan():
    """At S = 200 JAX's ssd_scan pads to 256 with zeros and runs the Pallas
    kernel (interpret mode); the port's plain version needs no padding."""
    args = _ssd_inputs(2, 3, 200, 16, 32)
    force_backend("pallas-interpret")
    try:
        want_y, want_s = jax_ssd_scan(*map(jnp.asarray, args))
    finally:
        force_backend(None)
    y, s = ssd_scan(*map(torch.from_numpy, args))
    assert want_y.shape == y.shape == (2, 3, 200, 32)
    _close(y, want_y, "ssd/cpu_fp32")
    _close(s, want_s, "ssd/cpu_fp32")


def test_ssd_ref_with_initial_state_matches_jax():
    args = _ssd_inputs(2, 3, 70, 16, 32)
    s0 = _np(2, 3, 16, 32)
    y, s = ssd_ref(*map(torch.from_numpy, args), s0=torch.from_numpy(s0))
    want_y, want_s = jax_ssd_ref(*map(jnp.asarray, args),
                                 s0=jnp.asarray(s0))
    _close(y, want_y, "ssd/cpu_fp32")
    _close(s, want_s, "ssd/cpu_fp32")
    y0, _ = ssd_ref(*map(torch.from_numpy, args))
    assert not np.allclose(y.numpy(), y0.numpy())      # s0 entered


def test_ssd_step_matches_jax_step_by_step_and_the_scan():
    B, H, S, N, P = 2, 3, 16, 8, 8
    c, b, x, la, g = _ssd_inputs(B, H, S, N, P)
    key = "ssd/cpu_fp32"
    s = torch.from_numpy(_np(B, H, N, P))
    js = jnp.asarray(s.numpy())
    s_start = s.clone()
    ys = []
    for t in range(S):
        sl = [a[:, :, t] for a in (c, b, x, la, g)]
        y, s_new = ssd_step(s, *map(torch.from_numpy, sl))
        if t == 0:
            assert torch.equal(s, s_start)      # the input state is kept
        s = s_new
        jy, js = jax_ssd_step(js, *map(jnp.asarray, sl))
        _close(y, jy, key)
        _close(s, js, key)
        ys.append(y)
    want_y, want_s = ssd_ref(*map(torch.from_numpy, (c, b, x, la, g)),
                             s0=s_start)
    np.testing.assert_array_equal(torch.stack(ys, 2).numpy(), want_y.numpy())
    np.testing.assert_array_equal(s.numpy(), want_s.numpy())


def test_ssd_bf16_keeps_dtype_fp32_state():
    args = _ssd_inputs(1, 2, 40, 64, 64)
    t = [torch.from_numpy(a) for a in args]
    for i in range(3):
        t[i] = t[i].to(torch.bfloat16)
    y, s = ssd_scan(*t)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_y, want_s = ssd_ref(*[a.float() for a in t[:3]], *t[3:])
    np.testing.assert_array_equal(y.float().numpy(),
                                  want_y.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(s.numpy(), want_s.numpy())


def test_ssd_launch_args_read_model_layout_through_strides():
    """The Mamba2 block's views: x and y through the strides of their
    (B, S, H, P) layout, b and c shared by all heads (head stride 0) as
    views of the one projection, the gates as (B, H, S) views of (B, S, H)
    tensors."""
    B, S, H, N, P = 2, 200, 8, 64, 64
    proj = torch.zeros(B, S, 2 * H * P + 2 * N + H, dtype=torch.bfloat16)
    xs, _, b, c, _ = torch.split(proj, [H * P, H * P, N, N, H], dim=-1)
    xh = xs.contiguous().view(B, S, H, P).transpose(1, 2)
    bh, ch = (t[:, None].expand(B, H, S, N) for t in (b, c))
    gates = torch.zeros(B, S, H).transpose(1, 2)
    y = torch.empty_like(xh)
    assert y.transpose(1, 2).is_contiguous()   # the reshape back is free
    args = ssd_launch_args(ch, bh, xh, gates, gates, y)
    width = proj.shape[-1]
    assert args[:5] == (B, H, S, N, P)
    assert args[5:8] == (S * width, 0, width)             # c (b, h, s)
    assert args[8:11] == (S * width, 0, width)            # b
    assert args[11:14] == (S * H * P, P, H * P)           # x
    assert args[14:17] == (S * H * P, P, H * P)           # y
    assert args[17:20] == (S * H, 1, H)                   # log_a
    assert args[20:23] == (S * H, 1, H)                   # gate


def test_ssd_scan_reads_a_head_dim_of_one_over_the_heads():
    """zamba2's block hands the scan c and b of shape (B, 1, S, N): the
    launch arguments are those of their expand over x's heads (a head
    stride of 0), and on the CPU the output is the expand's bit for bit."""
    B, H, S, N, P = 2, 4, 70, 64, 64
    c, b, x, la, g = (torch.from_numpy(a) for a in _ssd_inputs(B, H, S, N, P))
    c1, b1 = c[:, :1], b[:, :1]
    bf = torch.bfloat16
    y = torch.empty_like(x, dtype=bf)
    args = ssd_launch_args(c1.to(bf), b1.to(bf), x.to(bf), la, g, y)
    want = ssd_launch_args(*(t.to(bf).expand(B, H, S, N) for t in (c1, b1)),
                           x.to(bf), la, g, y)
    assert args[6] == args[9] == 0 and args == want
    got_y, got_s = ssd_scan(c1, b1, x, la, g)
    want_y, want_s = ssd_scan(c1.expand(B, H, S, N), b1.expand(B, H, S, N),
                              x, la, g)
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("bad", ["heads", "dtype", "gate_shape", "ds_final",
                                 "wide_shared"])
def test_ssd_scan_bwd_cuda_refuses_before_any_launch(bad):
    """The backward's wrapper checks shapes and types before it builds or
    loads anything: c and b of a head dim other than 1 or x's, fp32 c, a
    gate of the wrong shape, a ds_final of the wrong shape, and at the wide
    (512, 513) a head dim of 1 (its kernel takes xlstm's per-head q and
    k)."""
    B, H, S = 1, 3, 64
    bf = torch.bfloat16
    N, P = (512, 513) if bad == "wide_shared" else (64, 64)
    c = torch.zeros(B, 1, S, N, dtype=bf)
    x = torch.zeros(B, H, S, -(-P // 8) * 8, dtype=bf)[..., :P]
    g = torch.zeros(B, H, S)
    ds = None
    if bad == "heads":
        c = torch.zeros(B, 2, S, 64, dtype=bf)
    elif bad == "dtype":
        c = c.float()
    elif bad == "gate_shape":
        g = torch.zeros(B, H, S + 1)
    elif bad == "ds_final":
        ds = torch.zeros(B, H, 64, 32)
    with pytest.raises((ValueError, TypeError)):
        ssd_scan_bwd_cuda(c, c, x, g, g, x, ds)
    # two fp32 states a (batch, head, 64-row chunk); at 512 / 513 a record
    # (M and dM∘D in three bf16 parts, 3 KB of floats) and the 8 bands'
    # shares of c·dc, q and (B G)[:, 512] a chunk, and 8 shares of
    # <ds_final, S_in> a (batch, head): 29.9 MB at the train shape, where
    # the states themselves took 1.21 GB
    assert bwd_workspace_bytes(4, 64, 2048) == 2 * 4 * 64 * 32 * 64 * 64 * 4
    assert bwd_workspace_bytes(1, 1, 65) == 2 * 2 * 64 * 64 * 4
    wide_chunk = 6 * 64 * 64 * 2 + 3072 + 3 * 8 * 64 * 4
    assert bwd_workspace_bytes(1, 1, 65, (512, 513)) == (
        2 * wide_chunk + 8 * 4)
    assert bwd_workspace_bytes(4, 4, 2048, (512, 513)) == (
        4 * 4 * 32 * wide_chunk + 4 * 4 * 8 * 4) == 29_884_928


def test_bf16_ulps_counts_one_ulp_off_above_the_floor():
    """The card check of a bf16 output against a plain fp32 value: 0 where
    the value rounds alike, 1 where it rounds one ulp away, and an element
    below the floor (2^-10 of the rms) measured in ulps of the floor, so
    that an fp32 error of the size the fp32 limit allows stays under one."""
    key = "ssd_scan_bwd/card_bf16"
    floor, share = BF16_ULPS[key]
    assert floor == 2.0 ** -10 and share == 3e-3
    want = torch.tensor([1.0, 3.0, -5.0, 1e-7, 2.0, 1.0 + 2.0 ** -9])
    got = want.to(torch.bfloat16).float()
    assert torch.equal(bf16_ulps(got, want, key), torch.zeros(6))
    got[1] += 2.0 ** -6                  # one ulp at 3.0
    got[2] -= 2.0 ** -5                  # one ulp at 5.0
    got[3] = 3e-6                        # below the floor: a small share
    u = bf16_ulps(got, want, key)
    assert u[1] == 1.0 and u[2] == 1.0
    assert 0 < u[3] < 1.0
    mag = floor * float(want.square().mean().sqrt())
    ulp = 2.0 ** (math.floor(math.log2(mag)) - 7)
    small = float(torch.tensor(1e-7).to(torch.bfloat16).float())
    assert float(u[3]) == pytest.approx((3e-6 - small) / ulp, rel=1e-5)


@pytest.mark.parametrize("bad", ["state", "head_dim", "fp32", "gate_dtype",
                                 "stride", "shape"])
def test_ssd_launch_args_refuse_what_the_kernel_does_not_take(bad):
    B, H, S, N, P = 1, 2, 64, 64, 64
    bf = torch.bfloat16
    c = torch.zeros(B, H, S, N, dtype=bf)
    x = torch.zeros(B, H, S, P, dtype=bf)
    la = torch.zeros(B, H, S)
    if bad == "state":                                    # xlstm's N 512
        c = torch.zeros(B, H, S, 512, dtype=bf)
    elif bad == "head_dim":                               # and P 513
        x = torch.zeros(B, H, S, 513, dtype=bf)
    elif bad == "fp32":
        c = c.float()
    elif bad == "gate_dtype":
        la = la.to(bf)
    elif bad == "stride":
        x = torch.zeros(B, H, S, P + 4, dtype=bf)[..., :P]
    elif bad == "shape":
        la = torch.zeros(B, H, S + 1)
    match = "ROADMAP" if bad in ("state", "head_dim") else None
    with pytest.raises((ValueError, TypeError), match=match):
        ssd_launch_args(c, c, x, la, la if bad != "shape" else la[..., :S],
                        torch.empty_like(x))


def test_ssd_scan_raises_off_cpu_and_cuda_and_counts_no_cpu_launch():
    before = launches()
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 2, 8, 4, 4)]
    ssd_scan(*args)
    assert launches() == before          # the plain version is no launch
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError):
        ssd_scan(*meta)
    with pytest.raises(ValueError):      # tensors on two devices
        ssd_scan(*args[:4], meta[4])


def test_ssd_rel_l2_limit_rejects_dropped_inter_chunk_term():
    """The card's whole-tensor check (REL_L2) at zamba2's N = P = 64 in
    bf16: running each 128-row chunk from a zero state, which is the kernel
    with its inter-chunk term dropped and the fault chip_smoke.py plants,
    moves y and s_final far past their limits."""
    B, H, S, N, P = 1, 2, 512, 64, 64
    c, b, x, la, g = _ssd_inputs(B, H, S, N, P)
    la = la / 10            # l falls by ~1 a chunk: the state carries
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    t = (bf(c), bf(b), bf(x), torch.from_numpy(la), torch.from_numpy(g))
    y, s = ssd_ref(*t)
    parts = [ssd_ref(*[a[:, :, i:i + 128] for a in t])
             for i in range(0, S, 128)]
    y_bad = torch.cat([p[0] for p in parts], dim=2)
    assert rel_l2(y_bad, y) > 10 * REL_L2["ssd/card_bf16"]
    assert rel_l2(parts[-1][1], s) > 10 * REL_L2["ssd_state/card_fp32"]


# the chunked form the CUDA kernels compute (64-row chunks, a first pass of
# M and gates in the wide kernel), held against the JAX package

@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("N,P", [(16, 32), (32, 33)])
@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_chunked_ref_matches_jax_ref_and_pallas(chunk, N, P, shared):
    """The plain chunked version at chunk 64 (the kernels') and 128 (the
    TPU kernel's), at a ones-column-like ragged P, with b and c per head or
    shared by the heads (head stride 0, zamba2's layout), against JAX's
    sequential ssd_ref and its Pallas kernel in interpret mode."""
    B, H, S = 2, 3, 256
    c, b, x, la, g = _ssd_inputs(B, H, S, N, P)
    if shared:
        c, b = (np.ascontiguousarray(np.broadcast_to(a[:, :1], a.shape))
                for a in (c, b))
    tc, tb = (torch.from_numpy(a[:, :1]).expand(B, H, S, N) if shared
              else torch.from_numpy(a) for a in (c, b))
    if shared:
        assert tc.stride(1) == 0 and tb.stride(1) == 0
    y, s = ssd_chunked_ref(tc, tb, *map(torch.from_numpy, (x, la, g)),
                           chunk=chunk)
    assert y.shape == (B, H, S, P) and s.shape == (B, H, N, P)
    jargs = list(map(jnp.asarray, (c, b, x, la, g)))
    for want_y, want_s in (jax_ssd_ref(*jargs),
                           ssd_scan_pallas(*jargs, interpret=True,
                                           chunk=chunk)):
        _close(y, want_y, "ssd/cpu_fp32")
        _close(s, want_s, "ssd/cpu_fp32")


@pytest.mark.parametrize("S", [200, 1])
def test_ssd_chunked_ref_ragged_matches_the_recurrence(S):
    """A ragged last chunk and a single row: rows past S add nothing."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(2, 3, S, 16, 33)]
    y, s = ssd_chunked_ref(*args, chunk=64)
    want_y, want_s = ssd_ref(*args)
    _close(y, want_y, "ssd/cpu_fp32")
    _close(s, want_s, "ssd/cpu_fp32")


def test_ssd_chunk_m_is_the_masked_decayed_cb_and_the_gates():
    """The first pass's part (the card's oracle for the wide kernel's
    records): M from its definition, computed here element by element, and
    exp(l_i), w_j, exp(l_L); where l falls by more than 88 within a chunk
    the mask, a select taken before the exp, leaves no inf or NaN."""
    B, H, S, N, L = 1, 2, 100, 8, 64
    c, b, x, la, g = _ssd_inputs(B, H, S, N, 4)
    la = la - 3.0                        # l falls by > 190 a chunk
    m, e, w, d = ssd_chunk_m(*map(torch.from_numpy, (c, b, la, g)), chunk=L)
    assert m.shape == (B, H, 2, L, L) and e.shape == w.shape == (B, H, 2, L)
    assert d.shape == (B, H, 2) and bool(torch.isfinite(m).all())
    pad = lambda a: np.pad(a.astype(np.float64),
                           [(0, 0), (0, 0), (0, 2 * L - S)]
                           + [(0, 0)] * (a.ndim - 3))
    cp, bp, lp, gp = pad(c), pad(b), pad(la), pad(g)
    for k in range(2):
        rows = slice(k * L, (k + 1) * L)
        l = np.cumsum(lp[..., rows], -1)
        want = np.zeros((B, H, L, L))
        for i in range(L):
            for j in range(i + 1):
                want[..., i, j] = ((cp[..., rows, :][..., i, :]
                                    * bp[..., rows, :][..., j, :]).sum(-1)
                                   * np.exp(l[..., i] - l[..., j])
                                   * gp[..., rows][..., j])
        # l is an fp32 cumulative sum reaching ~190 here: its absolute
        # error (~2e-5) is the relative error of each exp
        np.testing.assert_allclose(m[:, :, k].numpy(), want, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(e[:, :, k].numpy(), np.exp(l), rtol=1e-4,
                                   atol=1e-30)
        np.testing.assert_allclose(
            w[:, :, k].numpy(), np.exp(l[..., -1:] - l) * gp[..., rows],
            rtol=1e-4, atol=1e-30)
        np.testing.assert_allclose(d[:, :, k].numpy(), np.exp(l[..., -1]),
                                   rtol=1e-4, atol=1e-30)


@pytest.mark.parametrize("shared_c,shared_b",
                         [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("N,P,pitch", [(512, 513, 520), (64, 64, 64)])
def test_ssd_launch_args_take_shared_c_and_b(N, P, pitch, shared_c,
                                             shared_b):
    """Both kernels take c and b with a head stride of 0 (one head's c and b
    read by every head: zamba2's layout) beside per-head ones, and pass the
    stride 0 on to the C call."""
    B, H, S = 1, 2, 64
    bf = torch.bfloat16
    x = torch.zeros(B, S, H, pitch, dtype=bf)[..., :P].transpose(1, 2)
    y = torch.empty(B, S, H, pitch, dtype=bf)[..., :P].transpose(1, 2)
    la = torch.zeros(B, H, S)
    per_head = torch.zeros(B, H, S, N, dtype=bf)
    shared = torch.zeros(B, 1, S, N, dtype=bf).expand(B, H, S, N)
    c = shared if shared_c else per_head
    b = shared if shared_b else per_head
    args = ssd_launch_args(c, b, x, la, la, y)
    assert args[:5] == (B, H, S, N, P)
    assert (args[6] == 0) == shared_c and (args[9] == 0) == shared_b


@pytest.mark.parametrize("B,H,S,chunks", [(8, 4, 1024, 16), (3, 5, 300, 5),
                                          (2, 4, 1, 1), (1, 1, 65, 2)])
def test_wide_workspace_is_a_record_per_64_row_chunk(B, H, S, chunks):
    """The wide kernel's workspace: one 17 KB record (M's two bf16 tiles,
    the gates) per (batch, head, 64-row chunk); 8.9 MB at the prefill
    shape."""
    assert WIDE_RECORD == 2 * 64 * 64 * 2 + 1024
    assert wide_workspace_bytes(B, H, S) == B * H * chunks * WIDE_RECORD
    assert wide_workspace_bytes(B, H, S) % 16 == 0      # bulk copies
