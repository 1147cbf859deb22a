"""Device resolution, the CUDA kernel build, launch counters and tolerances.

Dispatch is by the tensor's device, never by a switch: a wrapper runs its
plain PyTorch version for a CPU tensor, launches its hand-written kernel for a
CUDA tensor (raising if the build or the launch fails), and raises for any
other device.

The CUDA sources under ``repro_torch/csrc/*.cu`` are compiled with ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` at first use:

    build/repro_torch/<source-hash>/libkernels.so

Each source compiles in its own ``nvcc`` process, all started together, and
the objects are linked in one more step.  The directory name is a hash of the
sources and flags, so an edited source builds anew and a built one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC")

# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``None`` → the card, raising when there is none; else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device; none is available. "
                "Pass device='cpu' to run the plain PyTorch versions.")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def kernel_device(*tensors: torch.Tensor) -> str:
    """The device type the wrapper dispatches on: 'cpu' or 'cuda'.  All
    tensors must lie on one device; any other device type raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, for a ctypes launch.  The C
    entry points launch on the current device, so that must be the
    tensors' device."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise ValueError(f"tensors on {device} but the current device is "
                         f"cuda:{current}; launch under "
                         f"torch.cuda.device({device.index})")
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# launch counters: each wrapper adds one where it launches its kernel
# ---------------------------------------------------------------------------

LAUNCHES: dict[str, int] = {"rmsnorm": 0, "flash_attention": 0,
                            "decode_attention": 0, "cross_entropy": 0,
                            "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                            "ssd_scan": 0, "ssd_scan_wide": 0,
                            "ssd_wide_prep": 0, "ssd_scan_bwd": 0,
                            "moe_gmm": 0,
                            "moe_gmm_bwd": 0}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


# ---------------------------------------------------------------------------
# tolerances, used by the tests and by chip_smoke.py
# ---------------------------------------------------------------------------

TOLERANCES: dict[str, tuple[float, float]] = {
    # (atol, rtol): |got - want| <= atol + rtol·|want| elementwise.
    #
    # CPU, float32, plain version against the JAX package (ref and Pallas in
    # interpret mode): the same arithmetic summed in another order.
    # rmsnorm's one mean of squares leaves ~1e-7; attention's softmax and
    # two products over up to a few hundred keys ~1e-6.
    "rmsnorm/cpu_fp32": (1e-5, 0.0),
    "flash_attention/cpu_fp32": (1e-4, 0.0),
    "decode_attention/cpu_fp32": (1e-4, 0.0),
    # The gradients against jax.grad of the JAX package's oracles.  dx of
    # rmsnorm subtracts two terms of similar size (dy·w·rstd and the
    # projection on x), so it keeps a little less than the forward.  The
    # attention gradients sum P·dO and dS·K / dS^T·Q over up to a few
    # hundred rows in another order.
    "rmsnorm_bwd/cpu_fp32": (1e-5, 1e-5),
    "flash_attention_bwd/cpu_fp32": (1e-4, 1e-4),
    # lse and the label logit sum D products in fp32 in another order (by
    # 2048-column blocks in the Pallas kernel, 8192-column chunks in the
    # chunked forward, one product here); |lse| ~ log V ~ 6-12.
    "cross_entropy/cpu_fp32": (1e-5, 1e-6),
    # The CE gradient: dx sums V terms of (p - onehot)·w, dw sums T terms
    # of x·(p - onehot); both are chunked the same way as the JAX backward.
    "cross_entropy_bwd/cpu_fp32": (1e-6, 1e-5),
    # Whole model at the reduced config (2 layers, d 128, vocab 512): the
    # loss and every gradient leaf against jax.value_and_grad, and the
    # params after one AdamW step (see tests/test_torch_train.py for the
    # first-step sign rule).
    "model_loss/cpu_fp32": (1e-5, 1e-5),
    "model_grad/cpu_fp32": (5e-6, 1e-5),
    # SSD scan: the plain step-by-step fp32 recurrence against JAX's
    # (the same arithmetic), against the Pallas kernel in interpret mode and
    # JAX's padded ssd_scan (the chunked form: exp of cumulative-sum
    # differences).  Entries |y| up to ~25 differ by at most 6e-6, s_final
    # (|s| ~ 2) by 8e-7.
    "ssd/cpu_fp32": (2e-5, 1e-5),
    # One Mamba2 layer (in_proj, conv, gates, scan, skip, gate, out_proj)
    # and the reduced hybrid model (5 Mamba2 layers, the shared block twice,
    # d 128) against the JAX package's, fp32, another summation order:
    # at most 4.3e-6 (layer, |out| up to 19) and 3.6e-5 (model, logits and
    # states up to 16).
    "ssd/mamba_cpu_fp32": (1e-5, 1e-5),
    "ssd/hybrid_cpu_fp32": (1e-4, 1e-4),
    # The SSD scan at xlstm's N 512, P 513 (mLSTM-like gates, S 256 and a
    # ragged 200), plain version against JAX's ref and its Pallas kernel in
    # interpret mode: sums over 512 state rows in another order, at most
    # 9.1e-6 at |y| up to 11.
    "ssd_wide/cpu_fp32": (2e-5, 1e-5),
    # The SSD backward: the plain two-sweep backward (ssd_bwd_ref) and
    # autograd through ssd_scan against jax.vjp of the JAX ssd_ref, fp32, at
    # N 16 / P 32 and 64 / 64, S 64 and 70: the same products summed in
    # another order (the sweeps' matrix-vector products against JAX's
    # transposed scan), at most 3.5e-4 apart at |grad| up to 410, 1.3e-5
    # relative where |grad| > 10.  dlog_a is a reverse cumulative sum of
    # r_t - g_t·dgate_t over the rows, where JAX differentiates a_t·S_{t-1}
    # row by row, so its error is that of the sum's largest partial sums
    # (at most 3.8e-4 at |dlog_a| up to 525).
    "ssd_bwd/cpu_fp32": (3e-4, 3e-5),
    "ssd_bwd_dlog_a/cpu_fp32": (2e-3, 1e-5),
    # The reduced zamba2 (5 Mamba2 layers, the shared block twice, d 128):
    # every gradient leaf against jax.value_and_grad, fp32.  Here atol is a
    # share of the leaf's largest |grad|: each leaf's error follows its own
    # scale, and the embedding table's gradient sums every token's through
    # the trunk, so an entry near 0 can keep the error of its large terms
    # (6.5e-4 at |g| up to 37, rel L2 1.4e-5; w_in 5.3e-5 at up to 3.4; the
    # other leaves at most 1.5e-5 of their largest).
    "ssd/hybrid_grad_cpu_fp32": (5e-5, 1e-5),
    # One mLSTM or sLSTM block with its decode steps against the JAX
    # package's, fp32, another summation order: at most 3.6e-6 (reduced, d
    # 128, |out| up to 9) and 2.0e-5 at xlstm's real widths (d 2048, heads
    # of 512: products over 2048 and 512 terms); the reduced xlstm model
    # (4 blocks, forward, prefill and decode, logits and states up to 10)
    # at most 1.0e-5.
    "xlstm/block_cpu_fp32": (1e-5, 1e-5),
    "xlstm/wide_cpu_fp32": (5e-5, 1e-5),
    "xlstm/model_cpu_fp32": (5e-5, 1e-5),
    # Grouped matmul, plain version against the JAX package's moe_gmm_ref,
    # its Pallas kernel in interpret mode and its equal-groups einsum: fp32
    # products of the same values summed over D <= 64 in another order (at
    # most 5.7e-6 at |out| up to 34); in bf16 the same fp32 sums rounded
    # once, so a sum next to a rounding boundary may round the other way,
    # one bf16 ulp (none did: 0 at every shape).
    "moe_gmm/cpu_fp32": (1e-5, 1e-5),
    "moe_gmm/cpu_bf16": (1e-5, 2.0 ** -7),
    # One MoE FFN (router, top-k, dispatch, three grouped products, combine)
    # and the reduced granite model (2 layers, 8 experts padded to 16, top-2,
    # d 128) against the JAX package's, fp32, another summation order: at
    # most 1.1e-6 (FFN) and 4.0e-6 (model, logits and caches up to 3.8).
    # The routing is the same: the FFN tests assert that the k-th and
    # (k+1)-th router logits of every token differ by more than the two
    # packages' logits do.  bf16 rounds the dispatch buffer, the products
    # and the output at the same points on both sides; the fp32 sums before
    # each rounding differ in order, so a value may round the other way
    # (2^-8 relative) and carry into the next product: at most 1.6e-2 at
    # |out| up to 3.4.
    "moe/cpu_fp32": (1e-5, 1e-5),
    "moe/cpu_bf16": (2e-2, 2.0 ** -6),
    "moe/model_cpu_fp32": (2e-5, 1e-5),
    # Card, bfloat16 in and out, kernel against its plain version on the
    # same inputs.  Both compute y in fp32 and round once; the fp32 sums run
    # in another order, so a value next to a rounding boundary can round the
    # other way: one bf16 ulp, 2^-7 of |y| at most.
    "rmsnorm/card_bf16": (1e-3, 2.0 ** -7),
    # The kernel rounds p to bf16 for the P·V tensor-core product, as the
    # plain version (and the JAX reference) does, but at another point of
    # the softmax (p relative to a running max, before normalising), so each
    # p differs by up to 2^-8 relative; the output (an average of V rows,
    # |v| < 5 for unit normals) then rounds once more.
    "flash_attention/card_bf16": (2e-2, 2.0 ** -7),
    # Decode keeps q·scale to fp32's 24 bits and p to 16 (each split in
    # bf16 parts for the tensor cores; the TPU kernel keeps both in fp32):
    # the fp32 sum order, p's 2^-17 and the output's one bf16 rounding
    # remain.
    "decode_attention/card_bf16": (1e-2, 2.0 ** -7),
    # CE forward: the products of bf16 values are exact in fp32 on both
    # sides (wgmma bf16 -> fp32 here, an fp32 product with TF32 off in the
    # plain version); only the order of the D = 3584 fp32 sums and of the
    # logsumexp (a tile of 256 columns, then the tiles merged in a fixed
    # order) differs.  lse ~ 12, logits ~ N(0, 1).
    "cross_entropy/card_bf16": (1e-4, 1e-5),
    # rmsnorm backward: dx in bf16 from the same fp32 arithmetic as the plain
    # version (one bf16 rounding, one ulp at a boundary); dw in fp32 sums
    # 8192 rows in another order (per-block partials, then a second pass).
    "rmsnorm_bwd/card_bf16": (1e-3, 2.0 ** -7),
    "rmsnorm_bwd_dw/card_bf16": (1e-3, 1e-4),
    # Flash backward: P and dS are rounded to bf16 for the tensor-core
    # products, as the plain version rounds them (2^-8 relative each), at
    # the same points; dP = dO·V^T and the row sums Delta are fp32 in another
    # order, which moves dS next to a rounding boundary by one bf16 ulp.
    # dq, dk, dv round once more to bf16.  The elementwise check bounds the
    # error of the largest entries only: at the train step's shape (causal,
    # S 2048) a typical |dq| is ~0.05, so 2e-2 would pass a small error
    # made everywhere.  REL_L2 below holds the whole tensor.
    "flash_attention_bwd/card_bf16": (2e-2, 2.0 ** -6),
    # SSD scan, y in bf16: the kernel multiplies its fp32 operands as bf16
    # high part + remainder (16 bits of mantissa), the plain version in fp32,
    # so y differs before its one bf16 rounding by ~2^-17 of the sum of the
    # magnitudes of its terms, and rounds the other way next to a boundary:
    # one bf16 ulp.  On the H100 the largest error is one ulp (1.0 at
    # |y| >= 128).  REL_L2 below holds the whole tensor.
    "ssd/card_bf16": (1e-2, 2.0 ** -7),
    # SSD backward kernel's fp32 outputs (dgate; dlog_a below) against its
    # plain twin ssd_chunked_bwd_ref (before it, against ssd_bwd_ref, with
    # these limits): the same bf16 and fp32 inputs, the products' fp32
    # operands in three bf16 parts (24 bits) on the tensor cores against
    # fp32 products, summed in another order; dlog_a, a reverse sum over
    # the rows, keeps the absolute error of its largest partial sums.  The
    # step-by-step kernel read at most 4.9e-4 (dgate at |dgate| ~ 2000,
    # slow decay) and dlog_a 1.0e-2 (|dlog_a| ~ 1e4) on the H100: each atol
    # is about twice that, with rtol 1e-4 for the large entries.  REL_L2
    # below holds the whole tensors; dx, dc and db, now bf16, are held by
    # BF16_ULPS.
    "ssd_scan_bwd/card_fp32": (1e-3, 1e-4),
    "ssd_scan_bwd_dlog_a/card_fp32": (5e-2, 1e-4),
    # Grouped matmul: products of bf16 values are exact in fp32 on both
    # sides (wgmma here, an fp32 product with TF32 off in the plain
    # version); the D fp32 sums run in another order, so an output next to
    # a rounding boundary rounds the other way: one bf16 ulp (on the H100 at
    # most 3.1e-2, at |y| in [4, 8)).  REL_L2 below holds the whole tensor.
    "moe_gmm/card_bf16": (1e-3, 2.0 ** -7),
    # Grouped matmul backward: the forward's case for dx (sums over F) and
    # dw (sums over an expert's rows, 2048 at the train step): products of
    # bf16 values exact in fp32 on both sides, fp32 sums in another order,
    # one bf16 rounding, so one ulp where a sum sits at a boundary (on the
    # H100 at most 0.031 for dx at |dx| < 8 and 1.0 for dw at |dw| in
    # [128, 256)).  REL_L2 below holds the whole tensor.
    "moe_gmm_bwd/card_bf16": (1e-3, 2.0 ** -7),
    # One full-width MoE FFN call on the card (bf16: the dispatch buffer,
    # the three grouped products and silu(gate)*up each rounded to bf16)
    # against the same call on the CPU in fp32 on the same bf16 values, with
    # the same routing.  On the H100 the card reads rel L2 4.26e-3 and at
    # most 9.9e-3 at |y| up to 2.1 (the prefill call; the decode call 4.13e-3
    # and 5.0e-3), as the CPU's own bf16 path does: the same roundings.  atol
    # is twice the largest reading; a token routed or combined wrongly is
    # off by O(|y|) ~ 0.3.
    "moe/card_bf16": (2e-2, 2.0 ** -6),
}

# ‖got − want‖₂ / ‖want‖₂ over the whole tensor, on top of the elementwise
# check, where an error spread over all entries could hide under its atol.
REL_L2: dict[str, float] = {
    # Flash backward, each of dq, dk, dv: P, dS and the outputs are rounded
    # to bf16 at the same points on both sides, and differ only where an
    # fp32 sum in another order rounds the other way.  The sound kernel
    # reads at most 3.3e-4 on the H100 (dv at B 4, S 2048); the limit is
    # ~6 times that.  Dropping Delta = rowsum(dO∘O) (chip_smoke.py plants
    # it by passing o = 0) reads 0.46 for dq and dk.
    "flash_attention_bwd/card_bf16": 2e-3,
    # SSD scan: y (bf16) and s_final (fp32) against the plain sequential
    # fp32 recurrence.  The sound kernel reads at most 1.11e-4 for y (the
    # prefill shape) and 1.03e-5 for s_final (l falling by 188 a chunk) on
    # the H100; each limit is ~9 times that.  Running each 128-row chunk
    # from a zero state (the inter-chunk term dropped, chip_smoke.py's
    # planted fault) reads 4.9e-2 for y at the prefill shape's fast decay,
    # and 0.63 for y and 0.42 for s_final where the state carries.
    "ssd/card_bf16": 1e-3,
    "ssd_state/card_fp32": 1e-4,
    # SSD backward (dgate and dlog_a): the step-by-step kernel read at most
    # 2.3e-7 (dc, slow decay, S 1000) and 1.3e-5 for dlog_a (S 1001)
    # against ssd_bwd_ref on the H100, the limits ~13 and ~15 times that;
    # the chunked kernel against its twin at most 7.7e-7 (dgate) and 3.5e-6
    # (dlog_a).  At S 1 dlog_a is 0 in exact arithmetic and the plain
    # version's is rounding alone, so chip_smoke.py divides by the atol's
    # norm there.  Dropping the carried state and G at 128-row slices reads
    # 0.62-0.88 for every output, dropping <ds_final, S_last> 0.18 for
    # dlog_a (chip_smoke.py's planted faults, step-by-step kernel).
    "ssd_scan_bwd/card_fp32": 3e-6,
    "ssd_scan_bwd_dlog_a/card_fp32": 2e-4,
    # Grouped matmul: the same bf16 roundings on both sides except where an
    # fp32 sum in another order crosses a rounding boundary.  The sound
    # kernel reads at most 8.73e-5 on the H100 (prefill gate/up); the limit
    # is ~11 times that.  One row handed to its neighbour's expert
    # (chip_smoke.py's planted fault) reads 4.3e-3 among 98,304 rows and
    # 0.14 among 96.
    "moe_gmm/card_bf16": 1e-3,
    # Grouped matmul backward: the sound kernel reads at most 1.04e-4 (dw at
    # the train shape) on the H100; the limit is ~10 times that.
    "moe_gmm_bwd/card_bf16": 1e-3,
    # One MoE FFN call, card against CPU fp32 (TOLERANCES above): ~2.3
    # times the largest reading, 4.26e-3.
    "moe/card_bf16": 1e-2,
}


# A bf16 output against the plain version's fp32 value rounded to bf16:
# (floor, share).  The distance is counted in bf16 ulps of the rounded value,
# or of floor × the tensor's rms where that is larger; every element must be
# within one ulp, and at most `share` of them off by one.
BF16_ULPS: dict[str, tuple[float, float]] = {
    # SSD backward, dx, dc and db: the fp32 values the kernel rounds differ
    # from the twin's as the fp32 limit allows, a relative 3e-6
    # (REL_L2 "ssd_scan_bwd/card_fp32").  That flips the rounding of about
    # 2 · 3e-6 / 2^-8 ≈ 0.15% of the values; the share is twice that.  Below
    # 2^-10 of the rms one bf16 ulp (2^-8 of the value at least) is finer
    # than 3e-6 of the rms, so an element that small, a sum that cancelled,
    # is measured at that floor.  On the H100, before the kernel rounded
    # once, db summed 64 heads in the tensor cores' accumulators and flipped
    # 0.27% against an fp64 truth where the twin flipped 0.014%.
    "ssd_scan_bwd/card_bf16": (2.0 ** -10, 3e-3),
}


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              key: str) -> torch.Tensor:
    """|got − bf16(want)| in bf16 ulps of max(|bf16(want)|, floor × rms of
    want), elementwise (``BF16_ULPS[key]``'s floor)."""
    floor, _ = BF16_ULPS[key]
    w = want.float()
    w_r = w.to(torch.bfloat16).float()
    mag = torch.maximum(w_r.abs(), floor * w.square().mean().sqrt())
    _, e = torch.frexp(mag.clamp_min(torch.finfo(torch.float32).tiny))
    return (got.float() - w_r).abs() / torch.ldexp(torch.ones_like(mag), e - 8)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖₂ / ‖want‖₂, in fp32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def within(got: torch.Tensor, want: torch.Tensor, key: str) -> bool:
    """``got`` matches ``want`` under ``TOLERANCES[key]``."""
    atol, rtol = TOLERANCES[key]
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):           # .cu and .cuh
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin directory on PATH)")


def build_library(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    ``libkernels.so``; returns its path.  Raises with nvcc's stderr."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        objs, errors = [], []
        for src, obj, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src.name}:\n{err}{out}")
            elif verbose and (err or out):
                print(f"[nvcc {src.name}]\n{err}{out}", flush=True)
            objs.append(str(obj))
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp_lib = tmp / "libkernels.so"
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *objs, "-o", str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}"
                               f"{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib)          # atomic: a reader sees all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p,                       # q, k, v, o
        i, i, i, i, i,                    # B, Hq, Hkv, S, D
        i64, i64, i64,                    # q strides (b, h, s)
        i64, i64, i64,                    # k strides
        i64, i64, i64,                    # v strides
        i64, i64, i64,                    # o strides
        f, i, i,                          # scale, causal, window
        p, p]                             # lse (B, Hq, S) fp32 or NULL, stream
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bwd.argtypes = [
        p, p, p, p, p, p,                 # q, k, v, o, do, lse
        p, p, p, p,                       # dq, dk, dv, (lse, Delta) scratch
        i, i, i, i, i,                    # B, Hq, Hkv, S, D
        *([i64] * 24),                    # (b, h, s) strides: q k v o do dq dk dv
        f, i, i, p]                       # scale, causal, window, stream
    lib.flash_attention_bwd.restype = i
    lib.flash_attention_bwd_rows.argtypes = []
    lib.flash_attention_bwd_rows.restype = i
    lib.cross_entropy_fwd.argtypes = [
        p, p, p,                          # x (T, D), w (D, V), labels (T,)
        p, p,                             # lse, label logit (T,) fp32
        p, p, p,                          # partial m, l, label logit scratch
        i, i, i, i, i,                    # T, D, V, n_valid, n_split
        p]                                # stream
    lib.cross_entropy_fwd.restype = i
    lib.cross_entropy_split.argtypes = []
    lib.cross_entropy_split.restype = i
    lib.decode_attention_fwd.argtypes = [
        p, p, p, p,                       # q, k, v, lengths
        p, p, p,                          # out, m_out, l_out (m, l: or NULL)
        p, p, p,                          # partial o, m, l scratch
        i, i, i, i, i, i,                 # B, Hq, Hkv, S, D, n_split
        i64, i64,                         # q strides (b, h)
        i64, i64, i64,                    # k strides (b, s, h)
        i64, i64, i64,                    # v strides (b, s, h)
        f, p]                             # scale, stream
    lib.decode_attention_fwd.restype = i
    lib.ssd_scan_fwd.argtypes = [
        p, p, p, p, p,                    # c, b, x, log_a, gate
        p, p,                             # y, s_final (B, H, N, P) fp32
        i, i, i, i, i,                    # B, H, S, N, P
        *([i64] * 18),                    # (b, h, s) strides: c b x y la g
        p]                                # stream
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_wide_fwd.argtypes = [
        p, p, p, p, p,                    # c, b, x, log_a, gate
        p, p, p,                          # y, s_final, the first pass's records
        i, i, i, i, i,                    # B, H, S, N, P
        *([i64] * 18),                    # (b, h, s) strides: c b x y la g
        p]                                # stream
    lib.ssd_scan_wide_fwd.restype = i
    lib.ssd_scan_wide_prep.argtypes = [
        p, p, p, p, p,                    # c, b, log_a, gate, records
        i, i, i,                          # B, H, S
        *([i64] * 12),                    # (b, h, s) strides: c b la g
        p]                                # stream
    lib.ssd_scan_wide_prep.restype = i
    lib.ssd_scan_bwd.argtypes = [
        p, p, p, p, p, p, p,              # c, b, x, dy, log_a, gate, ds_final
        p, p, p, p, p,                    # dc, db, dx, dlog_a, dgate
        p,                                # workspace
        i, i, i, i, i, i,                 # B, H, Hc, S, N, P
        *([i64] * 15),                    # (b, h, s) strides: c b x dy dx
        *([i64] * 12),                    # (b, h, s) strides: la g dla dg
        p]                                # stream
    lib.ssd_scan_bwd.restype = i
    lib.ssd_scan_bwd_workspace.argtypes = [i, i, i]
    lib.ssd_scan_bwd_workspace.restype = i64
    lib.ssd_scan_wide_workspace.argtypes = [i, i, i]
    lib.ssd_scan_wide_workspace.restype = i64
    lib.moe_gmm_fwd.argtypes = [
        p, p, p, p,                       # x, w, group_sizes, out
        i, i, i, i,                       # T, D, F, E
        p]                                # stream
    lib.moe_gmm_fwd.restype = i
    lib.moe_gmm_decode_fwd.argtypes = lib.moe_gmm_fwd.argtypes
    lib.moe_gmm_decode_fwd.restype = i
    lib.moe_gmm_bwd.argtypes = [
        p, p, p, p,                       # x, w, dy, group_sizes
        p, p,                             # dx, dw
        i, i, i, i,                       # T, D, F, E
        p]                                # stream
    lib.moe_gmm_bwd.restype = i
    lib.rmsnorm_bwd.argtypes = [
        p, p, p, p, p, p,                 # x, w, dy, dx, dw, dw partials
        i, i, i64, i64, i64,              # rows, D, row strides x dy dx
        f, i, i,                          # eps, kind, path
        i, i, i, i, i,                    # grid, threads, vpt, stages,
                                          # shared bytes
        p]                                # stream
    lib.rmsnorm_bwd.restype = i
    lib.decode_attention_chunk.argtypes = []
    lib.decode_attention_chunk.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            _declare(lib)
            _LIB = lib
    return _LIB


def check_status(name: str, status: int) -> None:
    """Raise if a C entry point reported a launch error."""
    if status != 0:
        msg = library().repro_cuda_error_string(status)
        raise RuntimeError(f"{name} launch failed: CUDA error {status} "
                           f"({msg.decode() if msg else '?'})")
