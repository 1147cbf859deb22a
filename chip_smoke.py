#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase (one card)
    python3 chip_smoke.py --phases device,build,kernels

Phases, each of which must pass:

1. device  — name and power limit (nvidia-smi); TF32 off for fp32 products.
2. build   — nvcc builds ``src/repro_torch/csrc/*.cu`` (one process a
             source, in parallel); Triton compiles the rmsnorm forward at a
             first launch.  Both are timed; each CUDA kernel's registers
             and spills are printed (``ptxas -v``; the full text goes to
             ``chiprun_out/ptxas.txt``).
3. kernels — each kernel against its plain PyTorch version on the card, bf16,
             at the serving path's shapes and at ragged ones, under the
             tolerance of ``repro_torch.kernels.common.TOLERANCES``; times of
             kernel, plain version and one library call (a yardstick the port
             never calls) at the path's shapes, and each one's bound.
4. consistency — full-width qwen2-7b, random weights from a seed: prefill
             1000 tokens + decode token 1000 against forward over 1001:
             the logits' rel L2 under a limit, and decode's token among the
             forward's best within the tie band that half an ulp of input
             rounding gives the forward (``consistency_phase``).
5. serve   — ``serve_demo("qwen2-7b", use_reduced=False, ...)``: 16 requests
             in two waves of 8 lanes, 1024-token prompts, 64 new tokens;
             the launch counts of every kernel must match the path exactly.
6. consistency_hybrid, serve_hybrid — phases 4 and 5 for zamba2-1.2b at
             its published width and depth (38 Mamba2 layers on the SSD
             kernel, the shared attention block at head dim 64 six times);
             the consistency check runs at 8 layers too, where the
             random-init model does not amplify rounding as it does at 38.
             Each SSD model's check also reads the same comparison with the
             plain fp32 scan in the kernel's place, and at 8 layers must
             reject a planted fault: a prefill state that misses the
             prompt's last token.
7. consistency_moe, serve_moe — phases 4 and 5 for granite-moe-3b-a800m at
             its published width and depth (32 layers, each a routed FFN of
             40 experts padded to 48, top-8, on the grouped-matmul kernel;
             attention at head dim 64, 24 q heads over 8 kv heads).  First
             one MoE FFN call of the published config on the card against
             the same call on the CPU in fp32, at a decode step's and a
             prefill wave's size, each with assignments dropped: both must
             keep and drop the same assignments.  The consistency check runs
             at B = 1, where a decode step drops no assignment, and records
             every layer's largest expert load against its capacity; serving
             reports the share of assignments dropped in prefill and decode,
             read in a second, untimed run of the same requests.
8. consistency_ssm, serve_ssm — phases 4 and 5 for xlstm-1.3b at its
             published width and depth (48 blocks: 6 segments of 7 mLSTM
             blocks on the wide SSD kernel, N 512 and P 513, and one sLSTM
             block, a sequential loop in plain torch); ``--profile`` adds the
             sLSTM blocks' share of a prefill wave.
9. consistency_starcoder2, serve_starcoder2 — phases 4 and 5 for
             starcoder2-15b at its published width and depth (40 layers,
             d_model 6144, 48 q heads over 4 kv heads of 128: decode
             attention at group 12; gelu MLP, q/k/v biases), nothing cut.
10. consistency_nemotron, serve_nemotron — phases 4 and 5 for
             nemotron-4-340b at its published widths (d_model 18432, 96 q
             heads over 8 kv heads of 192: flash and decode attention at
             head dim 192, group 12; squared-ReLU MLP of 73728; vocab
             256,000), depth cut 96 -> 4 layers (the only cut: 96 layers
             are 680 GB in bf16, 4 are 46.5 GB, 18.9 of them embedding and
             head).  ``serve_demo`` has no depth override, so the phase
             serves the same requests through ``serve_requests`` with the
             cut config.
11. consistency_llama3 — phase 4 for llama3-405b at its published widths
             (d_model 16384, 128 q heads over 8 kv heads of 128: decode
             attention at group 16), depth cut 126 -> 4 layers (33.9 GB).
12. train  — qwen2-7b at its published widths, cut to 4 layers (the only
             cut: 28 layers need 122 GB of training state), through
             ``init_params``, ``adamw`` and ``make_train_step``: 4 steps on
             one repeated batch of 2 microbatches of 4 x 2048 tokens from
             ``data/lm.py`` at a constant lr; the loss must fall at every step
             and every kernel's launches must match the path exactly.  Then
             ``build_trainer``'s ``TrainLoop`` at a small config (bf16, head
             dim 128) is preempted at step 2 and resumed from its checkpoint
             under ``build/``: its losses must equal an uninterrupted run's.
13. consistency_audio, serve_audio — phases 4 and 5 for musicgen-medium
             (audio: the dense stack fed by precomputed EnCodec-frame
             embeddings, no embedding table) at its published width and
             depth (48 layers, d_model 1536, 24 q heads over 24 kv heads of
             64, gelu MLP of 6144), nothing cut.  Prompts and each decode
             step's input are seeded N(0, 1) embeddings; the serve phase
             drives ``serve/step.py``'s ``make_prefill_step`` and
             ``make_decode_step`` over the same 16 requests in two waves (the
             frontend is a stub, so the chosen token is recorded, not fed
             back: each step is fed the next seeded embedding).
14. consistency_vlm, serve_vlm — the same for internvl2-76b (vlm: patch
             embeddings) at its published widths (d_model 8192, 64 q heads
             over 8 kv heads of 128, swiglu MLP of 28672, vocab 128,256),
             depth cut 80 -> 16 layers (the only cut).
15. tabular — the paper's main path: ``examples/quickstart.py``'s batch
             (3-fold CV of ridge and of a 20-tree GBT over
             ``table_vectorizer`` features) built from ``repro_torch``, at
             1,000,000 rows, through ``connect("local", ...)`` on the card
             (16 GiB budget, compiled_segments=False, hardware_threads=8),
             twice.  The plan must be the reference's (42 ops, 14 waves,
             31 torch and 11 python ops), every torch op's output but
             read's must live on the card, the second run must serve 40 ops
             from the cache with equal scores, the torch tier's CV scores
             at 100,000 rows must be within 1e-4 of the python tier's, two
             GBT fits on the card must be equal bit for bit, and no hand
             kernel may launch (none lies on this path).
16. agentic — the paper's agentic pipeline search at the client's defaults
             (compiled segments on: ``repro_torch.core.backends.
             torch_segment``, inductor's cache in a fresh temporary
             directory through ``jit_cache_dir``), on the tabular phase's
             1,000,000-row lake, 16 GiB, hardware_threads=8: (a) the
             quickstart batch twice — per-tier counts, waves, plan-cache
             misses and hits and the second run's cache hits the
             reference's, equal scores, within 1e-4 of the tabular phase's
             per-op scores; (b) the paper workload (``examples/
             agentic_search.py``'s run_sync): iteration 1's 8 pipelines,
             then the grid on the winner, counts the reference's for that
             winner; (c) one ridge pipeline at four alphas compiles once, a
             fan of alphas runs as one batched program and a second fan
             compiles nothing; (d) ``compile_async``: the first touch runs
             per-op, the next one hits; (e) ``analyze_batch`` pre-verifies
             every torch segment and the run after it traces nothing; (f)
             ``AsyncAIDESearch``, 2 rounds of 4.  On every run no segment
             is uncompilable, compiled ops' outputs live on the card, and
             no hand kernel launches.

Each path is driven with the launch counters set to 0 just before it and
read just after; the kernels line reports each kernel's launches in the
paths' runs (``launches``, and by path).

It imports torch and the port, never jax or the JAX package.  Without a CUDA
device, or without the port beside it, it exits non-zero before printing a
result.  The last line is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels; details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"
ARCH = "qwen2-7b"
HYBRID_ARCH = "zamba2-1.2b"
MOE_ARCH = "granite-moe-3b-a800m"
SSM_ARCH = "xlstm-1.3b"
STARCODER_ARCH = "starcoder2-15b"
NEMOTRON_ARCH = "nemotron-4-340b"
LLAMA_ARCH = "llama3-405b"
# depth cuts: nemotron-4-340b's 96 layers are 680 GB in bf16 and
# llama3-405b's 126 are 810 GB; at 4 layers they are 46.5 and 33.9 GB
NEMOTRON_LAYERS = 4
LLAMA_LAYERS = 4
AUDIO_ARCH = "musicgen-medium"
VLM_ARCH = "internvl2-76b"
# internvl2-76b's depth cut: a layer is 0.856 B parameters (1.71 GB in bf16)
# and the LM head 2.1 GB, so 80 layers are ~139 GB and 16 are ~29.5 GB;
# init_params draws one layer at a time, so the peak stays inside 80 GB
VLM_LAYERS = 16
PHASES = ("device", "build", "kernels", "consistency", "serve",
          "consistency_hybrid", "serve_hybrid", "consistency_moe",
          "serve_moe", "consistency_ssm", "serve_ssm",
          "consistency_starcoder2", "serve_starcoder2",
          "consistency_nemotron", "serve_nemotron", "consistency_llama3",
          "train", "consistency_audio", "serve_audio", "consistency_vlm",
          "serve_vlm", "tabular", "agentic")

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside them,
# device memory.  Bounds are stated against these.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Device time of one call between CUDA events, averaged over ``iters``
    calls.  Before each, the 50 MB L2 is flushed (the model's callers find
    it cold) and the stream is held busy by a ~2 ms sleep kernel, so the
    host's launch cost (Python, Triton's launcher, ctypes, autograd for the
    backward yardsticks) is enqueued behind it and not counted: the events
    bracket the device work."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(4_000_000)          # ~2 ms at 1.98 GHz
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def ptxas_summary(text: str) -> dict:
    """{"source kernel<D>": "N registers, spill stores/loads, smem"} from
    the ``-Xptxas=-v`` output of the build (the full text goes to
    chiprun_out/ptxas.txt)."""
    out, source, kernel = {}, "?", None
    for line in text.splitlines():
        m = re.match(r"\[nvcc (\S+)\]", line)
        if m:
            source = m.group(1)
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([A-Za-z_]+kernel)(?:I((?:L[ib]\d+E)+)E)?",
                          m.group(1))
            name = k.group(1) if k else m.group(1)
            targs = re.findall(r"L[ib](\d+)E", k.group(2) or "") if k else []
            kernel = f"{source} {name}" + (f"<{','.join(targs)}>" if targs
                                           else "")
            spill = ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and kernel:
            out[kernel] = f"{m.group(1)} registers, {spill}{m.group(2)}"
    return out


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, timer, report):
    import torch.nn.functional as F

    from repro_torch.kernels.common import (REL_L2, TOLERANCES, max_abs_err,
                                            rel_l2, within)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def check(name, case, got, want):
        key = f"{name}/card_bf16"
        err = max_abs_err(got, want)
        ok = within(got, want, key)
        atol, rtol = TOLERANCES[key]
        msg = (f"  {name:19s} {case:44s} max_abs_err={err:.3e} (tolerance "
               f"{atol:g} + {rtol:.4g}*|ref|)")
        if key in REL_L2:
            rel = rel_l2(got, want)
            ok = ok and rel <= REL_L2[key]
            msg += f" rel_l2={rel:.3e} (limit {REL_L2[key]:g})"
            report.setdefault("rel_l2", {})[f"{name} {case}"] = rel
        log(f"{msg} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            fail(f"{name} {case} disagrees with its plain version "
                 f"(max abs err {err})")
        return err

    rows = []
    eps = 1e-5

    # ---- rmsnorm ---------------------------------------------------------
    errs = []
    # the served models' widths: qwen2-7b 3584, zamba2-1.2b 2048,
    # granite-moe-3b-a800m and musicgen-medium 1536, starcoder2-15b 6144,
    # internvl2-76b 8192, nemotron-4-340b 18432, each at a prefill wave's
    # 8 x 1024 rows and a decode step's 8; llama3-405b's 16384 at the
    # consistency check's 2 x 1001
    for shape, dtype in (((8192, 3584), bf16), ((8, 3584), bf16),
                         ((8192, 2048), bf16), ((8, 2048), bf16),
                         ((8192, 1536), bf16), ((8, 1536), bf16),
                         ((8192, 8192), bf16), ((8, 8192), bf16),
                         ((8192, 6144), bf16), ((8, 6144), bf16),
                         ((8192, 18432), bf16), ((8, 18432), bf16),
                         ((2002, 16384), bf16),
                         ((2000, 3584), bf16), ((77, 1000), bf16),
                         ((300, 3584), torch.float32)):
        x = randn(*shape, dtype=dtype)
        w = 1.0 + 0.1 * randn(shape[-1], dtype=torch.float32)
        errs.append(check("rmsnorm", f"x{shape} {str(dtype)[6:]}",
                          rmsnorm(x, w, eps), rmsnorm_ref(x, w, eps)))
    x = randn(8192, 3584)
    w = 1.0 + 0.1 * randn(3584, dtype=torch.float32)
    n = x.numel()
    b_ms, b_by = bound(n * 2 * 2 + 3584 * 4, 4 * n, PEAK_FP32)
    w_lib = w.to(bf16)
    row = {"name": "rmsnorm", "route": "triton",
           "source": "src/repro_torch/kernels/rmsnorm/kernel.py",
           "replaces": "src/repro/kernels/rmsnorm/kernel.py:35",
           "max_abs_err": max(errs),
           "ms": timer.ms(lambda: rmsnorm(x, w, eps)),
           "plain_ms": timer.ms(lambda: rmsnorm_ref(x, w, eps)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": timer.ms(
               lambda: F.rms_norm(x, (3584,), w_lib, eps))}
    rows.append(row)

    # ---- flash attention ---------------------------------------------------
    def bshd(B, S, H, D):
        # the model's layout: (B, S, H, D) tensors seen as (B, H, S, D)
        return randn(B, S, H, D).transpose(1, 2)

    errs = []
    for (B, Hq, Hkv, S, D, causal, window) in (
            (8, 28, 4, 1024, 128, True, 0),       # the prefill path's shape
            (2, 28, 4, 1000, 128, True, 0),       # ragged S
            (1, 14, 2, 77, 128, True, 0),         # S below one tile
            (2, 28, 4, 1000, 128, True, 256),     # windowed
            (1, 14, 2, 300, 128, False, 0),       # not causal
            (1, 14, 2, 300, 128, True, 1),        # window 1: the diagonal
            (2, 14, 2, 1, 128, True, 0),          # one token
            (8, 32, 32, 1024, 64, True, 0),       # zamba2's prefill, D 64
            (2, 32, 32, 1001, 64, True, 0),       # ragged S, D 64
            (1, 32, 32, 77, 64, True, 0),         # below one tile, D 64
            (3, 4, 2, 300, 64, False, 0),         # GQA, not causal, D 64
            (8, 24, 8, 1024, 64, True, 0),        # granite's prefill, group 3
            (2, 24, 8, 1001, 64, True, 0),        # ragged S, group 3
            (8, 48, 4, 1024, 128, True, 0),       # starcoder2's prefill, G 12
            (2, 48, 4, 1000, 128, True, 0),       # ragged S, group 12
            (2, 128, 8, 1000, 128, True, 0),      # llama3's prompt, group 16
            (8, 96, 8, 1024, 192, True, 0),       # nemotron's prefill, D 192
            (2, 96, 8, 1000, 192, True, 0),       # ragged S, D 192
            (2, 96, 8, 1024, 192, True, 256),     # windowed, D 192
            (1, 24, 2, 77, 192, True, 0),         # below one tile, D 192
            (1, 24, 2, 77, 192, True, 16),        # windowed, below one tile
            (1, 12, 1, 300, 192, False, 0),       # not causal, D 192
            (2, 96, 8, 1000, 192, True, 256),     # ragged S, windowed, D 192
            (1, 32, 32, 129, 64, True, 0),        # one row past a q tile
            (1, 28, 4, 129, 128, True, 0),
            (1, 96, 8, 129, 192, True, 0),
            (8, 24, 24, 1024, 64, True, 0),       # musicgen's prefill, G 1
            (2, 24, 24, 1000, 64, True, 0),       # its consistency prompt
            (8, 64, 8, 1024, 128, True, 0),       # internvl2's prefill, G 8
            (2, 64, 8, 1000, 128, True, 0)):
        q, k, v = bshd(B, S, Hq, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
        case = (f"B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} "
                f"{'causal' if causal else 'full'} w{window}")
        errs.append(check("flash_attention", case,
                          flash_attention(q, k, v, causal=causal,
                                          window=window),
                          attention_ref(q, k, v, causal=causal,
                                        window=window)))
    def flash_timings(B, S, Hq, Hkv, D):
        q, k, v = bshd(B, S, Hq, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
        pairs = S * (S + 1) // 2                  # causal (q, k) pairs
        b_ms, b_by = bound(B * S * D * 2 * (2 * Hq + 2 * Hkv),
                           4 * B * Hq * D * pairs, PEAK_BF16)
        out = {
            "shape": f"B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} causal",
            "ms": timer.ms(lambda: flash_attention(q, k, v, causal=True)),
            "plain_ms": timer.ms(lambda: attention_ref(q, k, v, causal=True),
                                 iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=Hq != Hkv))}
        del q, k, v
        torch.cuda.empty_cache()
        return out

    # qwen2-7b's prefill wave; the other served models' (zamba2's shared
    # block 32 q heads over 32 kv heads of 64, granite 24 over 8 of 64,
    # starcoder2 48 over 4 of 128, nemotron 96 over 8 of 192, musicgen 24
    # over 24 of 64, internvl2 64 over 8 of 128)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "max_abs_err": max(errs), **flash_timings(8, 1024, 28, 4, 128),
        "shapes": {label: flash_timings(8, 1024, *heads) for label, heads in
                   (("D64", (32, 32, 64)), ("granite", (24, 8, 64)),
                    ("starcoder2", (48, 4, 128)),
                    ("nemotron", (96, 8, 192)), ("musicgen", (24, 24, 64)),
                    ("internvl2", (64, 8, 128)))}})

    # ---- decode attention ------------------------------------------------
    errs = []
    lens_path = torch.randint(1025, 1089, (8,), generator=gen,
                              device="cuda", dtype=torch.int32)
    # the served models' shapes at the decode path's lengths (qwen2-7b 28 q
    # heads over 4 of 128, zamba2's shared block 32 over 32 of 64, granite
    # 24 over 8 of 64, starcoder2-15b 48 over 4 of 128, llama3-405b 128 over
    # 8, nemotron-4-340b 96 over 8 of 192, musicgen-medium 24 over 24 of
    # 64, internvl2-76b 64 over 8 of 128), ragged lengths, and ragged
    # groups (1, 3, 5, 16 at D 64; 24, more than one block's 16, at D 128);
    # every head of each group is compared, those past the 8th too
    ragged = [1, 129, 2047, 2048, 128, 1000, 127, 1]
    for (B, S, Hq, Hkv, D, lens, lse) in (
            (8, 2048, 28, 4, 128, lens_path, False),
            (8, 1000, 28, 4, 128, [1, 1000, 127, 128, 129, 999, 500, 2],
             False),
            (8, 2048, 28, 4, 128, [1, 2048, 2047, 64, 1025, 1088, 129, 1],
             True),
            (8, 2048, 32, 32, 64, lens_path, False),
            (8, 1000, 32, 32, 64, [1, 1000, 127, 128, 129, 999, 500, 2],
             False),
            (8, 2048, 24, 8, 64, lens_path, False),
            (8, 1000, 24, 8, 64, [1, 1000, 127, 128, 129, 999, 500, 2],
             False),
            (8, 2048, 48, 4, 128, lens_path, False),
            (8, 2048, 128, 8, 128, lens_path, False),
            (8, 2048, 96, 8, 192, lens_path, False),
            (8, 2048, 24, 24, 64, lens_path, False),
            (8, 2048, 64, 8, 128, lens_path, False),
            (8, 2048, 48, 4, 128, ragged, True),
            (8, 2048, 96, 8, 192, ragged, True),
            (8, 2048, 4, 4, 64, ragged, False),
            (8, 2048, 6, 2, 64, ragged, False),
            (8, 2048, 10, 2, 64, ragged, False),
            (8, 2048, 16, 1, 64, ragged, False),
            (8, 2048, 24, 1, 128, ragged, True)):
        lengths = (lens if torch.is_tensor(lens) else
                   torch.tensor(lens, dtype=torch.int32, device="cuda"))
        q = randn(B, 1, Hq, D)[:, 0]
        k, v = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        G = Hq // Hkv
        case = (f"B{B} S{S} Hq{Hq} Hkv{Hkv} G{G} D{D} lengths "
                f"{lengths.min().item()}-{lengths.max().item()}"
                f"{' lse' if lse else ''}")
        got = decode_attention(q, k, v, lengths, return_lse=lse)
        want = decode_attention_ref(q, k, v, lengths, return_lse=lse)
        out, ref = (got[0], want[0]) if lse else (got, want)
        errs.append(check("decode_attention", case, out, ref))
        if G > 8:
            late = torch.arange(Hq, device="cuda") % G >= 8
            log(f"    heads 8..{G - 1} of each group: max_abs_err="
                f"{max_abs_err(out[:, late], ref[:, late]):.3e}")
        if lse:
            for name, g, w_ in (("m", got[1], want[1]), ("l", got[2],
                                                         want[2])):
                rel = float(((g - w_).abs() / w_.abs().clamp_min(1e-6))
                            .max())
                log(f"    {name}: max rel err {rel:.3e}")
                if rel > 1e-4:
                    fail(f"decode_attention {name} disagrees (rel {rel})")
        del q, k, v, got, want

    def decode_timings(B, S, Hq, Hkv, D, lengths):
        q = randn(B, 1, Hq, D)[:, 0]
        k, v = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        n_keys = int(lengths.sum())
        b_ms, b_by = bound(n_keys * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2
                           + 4 * B, 4 * n_keys * Hq * D, PEAK_FP32)
        mask = (torch.arange(S, device="cuda")[None, :] <
                lengths[:, None])[:, None, None, :]      # (B, 1, 1, S)
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        return {
            "shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D}, lengths "
                     f"{lengths.min().item()}-{lengths.max().item()}",
            "ms": timer.ms(lambda: decode_attention(q, k, v, lengths)),
            "plain_ms": timer.ms(lambda: decode_attention_ref(q, k, v,
                                                              lengths)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True))}

    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:82",
        "max_abs_err": max(errs),
        **decode_timings(8, 2048, 28, 4, 128, lens_path),
        "shapes": {label: decode_timings(8, 2048, *heads, lens_path)
                   for label, heads in (("D64", (32, 32, 64)),
                                        ("granite", (24, 8, 64)),
                                        ("starcoder2", (48, 4, 128)),
                                        ("llama3", (128, 8, 128)),
                                        ("nemotron", (96, 8, 192)),
                                        ("musicgen", (24, 24, 64)),
                                        ("internvl2", (64, 8, 128)))}})
    torch.cuda.empty_cache()
    rows += ssd_rows(torch, timer, randn, check, report)
    rows += moe_gmm_rows(torch, timer, randn, check, report)
    rows += train_kernel_rows(torch, timer, randn, check, gen, report)
    for r in rows:
        subs = [(f"{r['name']} {k}", t) for k, t in
                r.get("shapes", {}).items()]
        for label, t in [(r["name"], r)] + subs:
            lib = ("none" if t["library_ms"] is None else
                   f"{t['library_ms']:.4f} ms")
            if "matmul_ms" in t:
                lib += f"  matmul alone {t['matmul_ms']:.4f} ms"
            log(f"  {label:35s} kernel {t['ms']:.4f} ms  plain "
                f"{t['plain_ms']:.4f} ms  library {lib}  bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return rows


SSD_L = 128            # the planted fault's slice: a whole number of chunks


def ssd_case(torch, randn, B, H, S, gates, per_head=False):
    """Inputs of the SSD kernel as the Mamba2 block hands them over: bf16 c
    and b of shape (B, S, 64) seen as (B, H, S, 64) with a head stride of 0,
    x a (B, H, S, 64) view of a (B, S, H, 64) tensor, fp32 gates as
    (B, H, S) views of (B, S, H) tensors.  ``gates``: "path" is the model's
    at init (a_log = 0, dt_bias = 0, dt ~ N(0, 1): gate = softplus(dt),
    log_a = -gate, l falls by ~100 a chunk); "slow" keeps |log_a| ~ 0.01 so
    the carried state matters; "overflow" has log_a <= -1, so l falls by
    more than 128 within every chunk.  ``per_head``: c and b of their own
    for each head, (B, H, S, 64) views of (B, S, H, 64) tensors (the kernel
    then computes c·bᵀ per head)."""
    import torch.nn.functional as F
    if per_head:
        c, b = (randn(B, S, H, 64).transpose(1, 2) for _ in range(2))
    else:
        c, b = (randn(B, S, 64)[:, None].expand(B, H, S, 64)
                for _ in range(2))
    x = randn(B, S, H, 64).transpose(1, 2)
    dt = randn(B, S, H, dtype=torch.float32)
    gate = F.softplus(dt)
    if gates == "path":
        log_a = -gate
    elif gates == "slow":
        log_a = -0.01 * dt.abs()
    else:
        log_a = -1.0 - 0.5 * dt.abs()
    return c, b, x, log_a.transpose(1, 2), gate.transpose(1, 2)


# Each SSD kernel, its cases (B, H, S, gates[, layout]) and its
# planted-fault case.  zamba2's (N 64, P 64): the prefill path's shape, a
# ragged S at 192 heads (units of two heads that do not fill the grid), ragged
# S with the state carrying, l falling by > 128 in every chunk, exactly one
# 128-row chunk, one row, and per-head b and c (a non-zero head stride: c·bᵀ
# per head, not shared) at an odd H.  xlstm's (N 512, P 513): the prefill
# path's shape, the consistency prompt's ragged S, ragged S with the state
# carrying, one row, B 3, H 5, S 300 (units that do not divide the grid, a
# ragged last chunk), and c and b shared by the heads (a head stride of 0).
SSD_KERNELS = (
    ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu", 64, 64,
     ((8, 64, 1024, "path"), (3, 64, 1000, "path"), (2, 5, 200, "slow"),
      (1, 7, 1001, "overflow"), (1, 4, 128, "slow"), (2, 3, 1, "slow"),
      (2, 5, 300, "slow", "per-head")),
     (2, 5, 1000, "slow")),
    ("ssd_scan_wide", "src/repro_torch/csrc/ssd_scan_wide.cu", 512, 513,
     ((8, 4, 1024, "path"), (8, 4, 1000, "path"), (2, 4, 200, "slow"),
      (2, 4, 1, "path"), (3, 5, 300, "slow"), (2, 3, 300, "slow", "shared")),
     (2, 4, 1000, "slow")),
)


def ssd_rows(torch, timer, randn, check, report):
    """Each SSD kernel against the sequential plain recurrence under the
    ssd limits: y elementwise and by rel L2, s_final by rel L2; a planted
    fault; two calls equal bit for bit; times and bound at its prefill
    path's shape (the first case).  The wide kernel's first pass is held
    against its plain version (``ssd_chunk_m``) and has a row of its own."""
    from repro_torch.kernels.common import REL_L2, launches, rel_l2
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_ref

    state_key = "ssd_state/card_fp32"
    rows = []
    for name, source, N, P, cases, fault in SSD_KERNELS:
        make = ssd_case if N == 64 else ssd_wide_case
        errs = []
        for (B, H, S, gates, *layout) in cases:
            inputs = make(torch, randn, B, H, S, gates, *([True] if layout
                                                          else []))
            la = inputs[3]
            n = -(-S // SSD_L) * SSD_L
            drop = torch.nn.functional.pad(la, (0, n - S)).reshape(
                B, H, -1, SSD_L).sum(-1).neg().max().item()
            before = launches()[name]
            y, s = ssd_scan(*inputs)
            if launches()[name] != before + 1:
                fail(f"ssd_scan at ({N}, {P}) did not launch {name}")
            want_y, want_s = ssd_ref(*inputs)
            case = (f"N{N} P{P} B{B} H{H} S{S} {gates}"
                    f"{' ' + layout[0] if layout else ''} (l falls <= "
                    f"{drop:.0f} a 128-row chunk)")
            if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
                fail(f"{name} {case}: non-finite output")
            errs.append(check("ssd", case, y, want_y))
            rel = rel_l2(s, want_s)
            ok = rel <= REL_L2[state_key]
            log(f"  {name:19s} {case + ' s_final':44s} rel_l2={rel:.3e} "
                f"(limit {REL_L2[state_key]:g}) "
                f"{'ok' if ok else 'OUT OF TOLERANCE'}")
            report.setdefault("rel_l2", {})[f"{name} {case} s_final"] = rel
            if not ok:
                fail(f"{name} {case}: s_final disagrees with the plain "
                     "version")
            if gates == "overflow" and drop <= 88:
                fail("the overflow case does not make l fall by more than "
                     "88")
            del inputs, y, s, want_y, want_s

        B, H, S, gates = cases[0]
        inputs = make(torch, randn, B, H, S, gates)
        ssd_planted_fault(torch, report, name, inputs,
                          make(torch, randn, *fault))
        same_bits(torch, name, f"N{N} P{P} B{B} H{H} S{S}",
                  lambda: ssd_scan(*inputs))
        L = 64                 # the kernels' chunk length
        n_chunks = -(-S // L)
        # the four products over whole 64-row chunks
        flops = B * H * n_chunks * (2 * L * L * N + 2 * L * L * P
                                    + 4 * L * N * P)
        # c and b are read once: zamba2's are shared by all heads (head
        # stride 0), xlstm's q and k are per head
        c_heads = H if inputs[0].stride(1) else 1
        bytes_moved = (2 * B * S * H * P * 2 + 2 * B * H * S * 4
                       + 2 * B * S * c_heads * N * 2 + B * H * N * P * 4)
        b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "src/repro/kernels/ssd/kernel.py:92",
            "max_abs_err": max(errs),
            "ms": timer.ms(lambda: ssd_scan(*inputs)),
            "plain_ms": timer.ms(lambda: ssd_ref(*inputs), iters=2,
                                 warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,      # no one PyTorch call computes the scan
            "flop": flops, "bytes": bytes_moved})
        if N == 512:
            rows.append(ssd_wide_prep_row(torch, timer, randn, report,
                                          inputs))
        del inputs
        torch.cuda.empty_cache()
    return rows


def wide_records(torch, ws, B, H, S):
    """The wide kernel's first-pass records as (M, e, w, decay) in fp32: M
    (B, H, chunks, 64, 64) from its two swizzled bf16 tiles (high part and
    remainder; 16-byte chunk c of row i at c ^ (i % 8)), the gates after
    them (csrc/ssd_scan_wide.cu: REC_*)."""
    from repro_torch.kernels.ssd.kernel import WIDE_CHUNK, WIDE_RECORD
    nc = -(-S // WIDE_CHUNK)
    r = ws.view(B, H, nc, WIDE_RECORD)
    i = torch.arange(64, device=ws.device)[:, None]
    j = torch.arange(64, device=ws.device)[None, :]
    idx = i * 64 + ((j // 8) ^ (i % 8)) * 8 + j % 8
    tiles = r[..., :2 * 8192].contiguous().view(torch.bfloat16)
    m = (tiles[..., :4096][..., idx].float()
         + tiles[..., 4096:][..., idx].float())
    gts = r[..., 2 * 8192:].contiguous().view(torch.float32)
    return m, gts[..., :64], gts[..., 64:128], gts[..., 128]


def ssd_wide_prep_row(torch, timer, randn, report, inputs):
    """The wide kernel's first pass against ``ssd_chunk_m``: M, exp(l_i),
    w_j and exp(l_L) of every chunk by rel L2 under the state limit (fp32
    values; M keeps 16 bits in its two bf16 parts), at the prefill shape and
    at B 3, H 5, S 300; a planted fault (the decay off by one row) must
    fail it.  Its row: time, plain version's, bound."""
    from repro_torch.kernels.common import REL_L2, max_abs_err, rel_l2
    from repro_torch.kernels.ssd.kernel import (ssd_wide_prep_cuda,
                                                wide_workspace_bytes)
    from repro_torch.kernels.ssd.ref import ssd_chunk_m
    limit = REL_L2["ssd_state/card_fp32"]
    errs = []
    for case in (inputs, ssd_wide_case(torch, randn, 3, 5, 300, "slow")):
        c, b, _, la, g = case
        B, H, S, N = c.shape
        got = wide_records(torch, ssd_wide_prep_cuda(c, b, la, g), B, H, S)
        want = ssd_chunk_m(c, b, la, g, 64)
        rels = [rel_l2(x, y) for x, y in zip(got, want)]
        ok = all(r <= limit for r in rels)
        errs.append(max_abs_err(got[0], want[0]))
        log(f"  {'ssd_wide_prep':19s} {f'B{B} H{H} S{S} M, e, w, decay':44s} "
            f"rel_l2={', '.join(f'{r:.3e}' for r in rels)} (limit "
            f"{limit:g}) {'ok' if ok else 'OUT OF TOLERANCE'}")
        report.setdefault("rel_l2", {})[f"ssd_wide_prep B{B} H{H} S{S}"] = \
            rels
        if not ok:
            fail(f"ssd_wide_prep B{B} H{H} S{S} disagrees with ssd_chunk_m")
    # the planted fault: an exclusive cumulative sum of log_a where the
    # inclusive one belongs (every decay off by one row)
    c, b, _, la, g = inputs
    la_off = torch.nn.functional.pad(la[..., :-1], (1, 0))
    bad = wide_records(torch, ssd_wide_prep_cuda(c, b, la_off, g),
                       *c.shape[:3])
    want = ssd_chunk_m(c, b, la, g, 64)
    rels = [rel_l2(x, y) for x, y in zip(bad, want)]
    log(f"    planted fault (decay off by one row) ssd_wide_prep: M, e, w, "
        f"decay rel_l2={', '.join(f'{r:.3e}' for r in rels)} (limit "
        f"{limit:g})")
    if not rels[0] > limit:
        fail("the first-pass check does not reject a decay off by one row")
    B, H, S, N = c.shape
    n_chunks = -(-S // 64)
    bytes_moved = (2 * B * H * S * N * 2 + 2 * B * H * S * 4
                   + wide_workspace_bytes(B, H, S))
    flops = B * H * n_chunks * 2 * 64 * 64 * N
    b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16)
    return {"name": "ssd_wide_prep", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_wide.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:92",
            "max_abs_err": max(errs),
            "ms": timer.ms(lambda: ssd_wide_prep_cuda(c, b, la, g)),
            "plain_ms": timer.ms(lambda: ssd_chunk_m(c, b, la, g, 64),
                                 iters=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "flop": flops, "bytes": bytes_moved}


def ssd_planted_fault(torch, report, name, *cases):
    """The SSD check must reject a wrong kernel.  Launched on each 128-row
    slice alone (views of the inputs), the kernel starts every slice from a
    zero state: it runs as if its inter-chunk term were dropped at those
    boundaries, with no edit to its source.  y, and s_final where the
    state carries, must fail the check against the sound plain version."""
    from repro_torch.kernels.common import REL_L2, TOLERANCES, rel_l2, within
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_ref

    out = {}
    for inputs in cases:
        B, H, S = inputs[2].shape[:3]
        want_y, want_s = ssd_ref(*inputs)
        parts = [ssd_scan(*[t[:, :, i:i + SSD_L] for t in inputs])
                 for i in range(0, S, SSD_L)]
        y = torch.cat([p[0] for p in parts], dim=2)
        res = {"y_rel_l2": rel_l2(y, want_y),
               "y_elementwise_ok": within(y, want_y, "ssd/card_bf16"),
               "s_final_rel_l2": rel_l2(parts[-1][1], want_s)}
        case = f"B{B} H{H} S{S}"
        out[case] = res
        log(f"    planted fault (inter-chunk term dropped) {name} {case}: "
            f"y rel_l2={res['y_rel_l2']:.3e} (limit "
            f"{REL_L2['ssd/card_bf16']:g}), elementwise check "
            f"{'passes' if res['y_elementwise_ok'] else 'fails'} (tolerance "
            f"{TOLERANCES['ssd/card_bf16']}), s_final rel_l2="
            f"{res['s_final_rel_l2']:.3e} (limit "
            f"{REL_L2['ssd_state/card_fp32']:g})")
        if not (res["y_rel_l2"] > REL_L2["ssd/card_bf16"]
                and not res["y_elementwise_ok"]):
            fail(f"the SSD check does not reject a {name} that drops the "
                 "inter-chunk term")
    report[f"planted_fault {name}"] = out
    # the last case carries its state across chunks
    if not res["s_final_rel_l2"] > REL_L2["ssd_state/card_fp32"]:
        fail(f"the SSD state check does not reject a {name} that drops "
             "the inter-chunk term")


def ssd_wide_case(torch, randn, B, H, S, gates="path", shared=False):
    """Inputs of the wide SSD kernel as the mLSTM block hands them over
    (xlstm-1.3b: 4 heads of 512): c = q·512**-0.5 and b = k, (B, H, S, 512)
    views of (B, S, H, 512) bf16 tensors; x = v with its column of ones, a
    (B, H, S, 513) view of a (B, S, H, 520) buffer; fp32 gates as (B, H, S)
    views of (B, S, H) tensors.  ``gates``: "path" is the model's at init
    (log σ(f) with the forget bias 3, σ(i), f and i ~ N(0, 1)); "slow" keeps
    |log_a| ~ 0.01 so the carried state dominates.  ``shared``: one q and k
    for all heads, (B, S, 512) seen with a head stride of 0."""
    import torch.nn.functional as F
    from repro_torch.models.xlstm import _ones_augmented, _q_scale
    N = 512
    q, k = (randn(B, S, 1 if shared else H, N) for _ in range(2))
    q, k = (t.expand(B, S, H, N) for t in (q * _q_scale(N, q.dtype), k))
    v = randn(B, S, H, N)
    f = randn(B, S, H, dtype=torch.float32)
    i = randn(B, S, H, dtype=torch.float32)
    log_a = (F.logsigmoid(f + 3.0) if gates == "path"
             else -0.01 * f.abs())
    return (q.transpose(1, 2), k.transpose(1, 2),
            _ones_augmented(v).transpose(1, 2), log_a.transpose(1, 2),
            torch.sigmoid(i).transpose(1, 2))


# granite-moe-3b-a800m's expert products: 48 experts (40 padded), d_model
# 1536, expert width 512; C rows an expert (2048 in a prefill wave of 8 x
# 1024 tokens, 2 in a decode step of 8 lanes)
GMM_E, GMM_D, GMM_F = 48, 1536, 512
GMM_SHAPES = {"prefill gate/up": (2048, GMM_D, GMM_F),
              "prefill down": (2048, GMM_F, GMM_D),
              "decode gate/up": (2, GMM_D, GMM_F),
              "decode down": (2, GMM_F, GMM_D)}


def moe_gmm_rows(torch, timer, randn, check, report):
    """The grouped matmul against the plain loop over the experts' rows: at
    the serve path's four shapes (equal groups), and at ragged ones (empty
    experts, group starts off every tile boundary, a one-row expert, rows
    past the last group, K and N tails, one expert of 300 rows where the
    decode design is picked), each through the public call and through
    both designs; a planted fault; times, bound and torch.bmm at each path
    shape."""
    from repro_torch.kernels.moe_gmm.kernel import (DESIGNS, gmm_design,
                                                    moe_gmm_cuda)
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    import numpy as np

    def sizes_of(lst):
        return torch.tensor(lst, dtype=torch.int32, device="cuda")

    errs = []
    cases = [(f"{name}: T {GMM_E * c} = {GMM_E} x {c}, D {d}, F {f}",
              GMM_E * c, d, f, [c] * GMM_E)
             for name, (c, d, f) in GMM_SHAPES.items()]
    # group starts 0, 13, 83, 86, 287, 288, 385 (none a multiple of 64 past
    # 0) with a one-row expert, T 516 (not a multiple of 128)
    ragged7 = [13, 70, 3, 201, 1, 97, 131]
    cases += [
        ("ragged: 130 rows over 5 experts", 130, GMM_D, GMM_F,
         [31, 0, 47, 1, 51]),
        ("empty experts [0, 100, 0, 28]", 128, 64, 64, [0, 100, 0, 28]),
        ("rows past the groups: 72 of 200", 200, GMM_D, GMM_F,
         [0, 100, 0, 28]),
        ("48 experts, 1000 rows drawn", 1000, GMM_D, GMM_F,
         np.random.default_rng(0).multinomial(1000, [1 / GMM_E] * GMM_E)
         .tolist()),
        ("ragged starts, a one-row expert, T 516", 516, GMM_D, GMM_F,
         ragged7),
        ("D 72: a K tail past the last 64-deep slice", 516, 72, GMM_F,
         ragged7),
        ("F 200: an N tail", 516, GMM_D, 200, ragged7),
        ("T 700 over 48 (decode pick), one expert of 300 rows", 700, GMM_D,
         GMM_F, [300] + [8] * 40 + [80] + [0] * 6)]
    for case, T, d, f, sizes in cases:
        x, w = randn(T, d), (randn(len(sizes), d, f) * d ** -0.5).to(
            torch.bfloat16)
        g = sizes_of(sizes)
        want = moe_gmm_ref(x, w, g)
        # the public call (the design gmm_design picks), then each design
        picked = gmm_design(T, len(sizes))
        for design in (None, *DESIGNS):
            got = (moe_gmm(x, w, g) if design is None else
                   moe_gmm_cuda(x, w, g, design=design))
            label = f"{case} [{design or 'picked: ' + picked}]"
            errs.append(check("moe_gmm", label, got, want))
            if sum(sizes) < T and got[sum(sizes):].any():
                fail(f"moe_gmm {label}: rows past the groups are not zero")
        del x, w, got, want
    moe_gmm_planted_fault(torch, randn, report)

    shapes = {}
    for name, (c, d, f) in GMM_SHAPES.items():
        T = GMM_E * c
        x, w = randn(T, d), (randn(GMM_E, d, f) * d ** -0.5).to(
            torch.bfloat16)
        g = sizes_of([c] * GMM_E)
        xb = x.view(GMM_E, c, d)
        b_ms, b_by = bound(T * d * 2 + GMM_E * d * f * 2 + T * f * 2
                           + GMM_E * 4, 2 * T * d * f, PEAK_BF16)
        shapes[name] = {
            "shape": f"T {T} = {GMM_E} x {c}, D {d}, F {f}",
            "ms": timer.ms(lambda: moe_gmm(x, w, g)),
            "plain_ms": timer.ms(lambda: moe_gmm_ref(x, w, g), iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: torch.bmm(xb, w))}
        del x, w, xb
    torch.cuda.empty_cache()
    main = shapes.pop("prefill gate/up")
    return [{"name": "moe_gmm", "route": "cuda",
             "source": "src/repro_torch/csrc/moe_gmm.cu",
             "replaces": "src/repro/kernels/moe_gmm/kernel.py:61",
             "max_abs_err": max(errs), **main, "shapes": shapes}]


def moe_gmm_planted_fault(torch, randn, report):
    """The grouped matmul's check must reject a wrong kernel.  Launched with
    the offsets shifted by one row (expert e's last row handed to expert
    e + 1), the kernel computes that row with its neighbour's weights, with
    no edit to its source; the result must fail the check against the
    sound plain version."""
    from repro_torch.kernels.common import REL_L2, TOLERANCES, rel_l2, within
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    key = "moe_gmm/card_bf16"
    atol, rtol = TOLERANCES[key]
    out = {}
    for name, c in (("prefill", 2048), ("decode", 2)):
        T = GMM_E * c
        x = randn(T, GMM_D)
        w = (randn(GMM_E, GMM_D, GMM_F) * GMM_D ** -0.5).to(torch.bfloat16)
        sizes = torch.full((GMM_E,), c, dtype=torch.int32, device="cuda")
        shifted = sizes.clone()
        shifted[0] -= 1
        shifted[1] += 1
        want = moe_gmm_ref(x, w, sizes)
        got = moe_gmm(x, w, shifted)
        off = (got.float() - want.float()).abs() > atol + rtol * \
            want.float().abs()
        res = {"elementwise_ok": within(got, want, key),
               "rel_l2": rel_l2(got, want),
               "rows_off": int(off.any(-1).sum())}
        out[name] = res
        log(f"    planted fault (offsets shifted by one row) {name} T {T}: "
            f"rel_l2={res['rel_l2']:.3e} (limit {REL_L2[key]:g}), "
            f"elementwise check "
            f"{'passes' if res['elementwise_ok'] else 'fails'}, "
            f"{res['rows_off']} row(s) out of tolerance")
        if res["elementwise_ok"] or res["rel_l2"] <= REL_L2[key]:
            fail("the moe_gmm check does not reject a kernel that hands a "
                 "row to its neighbour's expert")
        del x, w, want, got
    report["moe_gmm_planted_fault"] = out


def train_kernel_rows(torch, timer, randn, check, gen, report):
    """The training path's kernels against their plain versions: the fused
    LM-head cross entropy, and the backward of flash attention and rmsnorm,
    at the train step's shapes and at ragged ones."""
    import torch.nn.functional as F

    from repro_torch.kernels.cross_entropy.kernel import ce_forward_cuda
    from repro_torch.kernels.cross_entropy.ref import ce_forward_chunked
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_bwd_cuda,
                                                    rmsnorm_bwd_launch_args)
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    bf16 = torch.bfloat16
    rows = []

    # ---- cross entropy forward -------------------------------------------
    T, D, V = 8192, 3584, 152064
    errs = []
    for (t_, d_, v_, n_valid, poison) in (
            (T, D, V, V, False),              # the train step's shape
            (1000, D, V, 151000, True),       # ragged T, padded head
            (77, D, 5000, 4999, True),        # a partial last tile
            # a last slice half past D (3616 = 56·64 + 32); n_valid cuts
            # column tile 15 of 256, tiles 16-19 lie wholly past it
            (129, 3616, 5000, 4000, True),
            (128, 256, 512, 512, False)):     # the TrainLoop check's shape
        x = randn(t_, d_)
        w = (randn(d_, v_) * d_ ** -0.5).to(bf16)
        if poison:
            w[:, n_valid:] = 100.0            # must be masked out exactly
        lab = torch.randint(0, n_valid, (t_,), generator=gen, device="cuda",
                            dtype=torch.int32)
        lse, ll = ce_forward_cuda(x, w, lab, n_valid)
        rl, rll = ce_forward_chunked(x, w, lab, n_valid)
        case = f"T{t_} D{d_} V{v_} n_valid {n_valid}"
        errs.append(check("cross_entropy", case + " lse", lse, rl))
        errs.append(check("cross_entropy", case + " label", ll, rll))
    x = randn(T, D)
    w = (randn(D, V) * D ** -0.5).to(bf16)
    lab = torch.randint(0, V, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    same_bits(torch, "cross_entropy", f"T{T} D{D} V{V}",
              lambda: ce_forward_cuda(x, w, lab, V))

    def library_ce():
        logits = (x @ w).float()
        return torch.logsumexp(logits, -1), logits.gather(
            1, lab.long()[:, None])

    b_ms, b_by = bound(T * D * 2 + D * V * 2 + T * 4 + 2 * T * 4,
                       2 * T * D * V, PEAK_BF16)
    rows.append({
        "name": "cross_entropy", "route": "cuda",
        "source": "src/repro_torch/csrc/cross_entropy.cu",
        "replaces": "src/repro/kernels/cross_entropy/kernel.py:76",
        "max_abs_err": max(errs),
        "ms": timer.ms(lambda: ce_forward_cuda(x, w, lab, V)),
        "plain_ms": timer.ms(lambda: ce_forward_chunked(x, w, lab, V),
                             iters=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(library_ce, iters=3),
        # a second yardstick: the bf16 GEMM alone, without the logsumexp
        "matmul_ms": timer.ms(lambda: x @ w, iters=3)})
    del x, w, lab

    # ---- flash attention backward ----------------------------------------
    def bshd(B, S, H, D):
        return randn(B, S, H, D).transpose(1, 2)

    errs = []
    for (B, Hq, Hkv, S, causal, window) in (
            (4, 28, 4, 2048, True, 0),        # the train step's shape
            (2, 28, 4, 1000, True, 0),        # ragged S
            (1, 14, 2, 300, True, 64),        # windowed
            (1, 14, 2, 300, False, 0),        # not causal
            (1, 7, 1, 77, True, 0),           # group 7 over one kv head
            (1, 14, 2, 129, True, 0),         # one row past a 128-row tile
            (1, 28, 4, 2048, True, 256)):     # windowed at the train S
        q, k, v = bshd(B, S, Hq, 128), bshd(B, S, Hkv, 128), \
            bshd(B, S, Hkv, 128)
        do = bshd(B, S, Hq, 128)
        opts = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **opts)
        _, rlse = attention_ref(q, k, v, return_lse=True, **opts)
        case = (f"B{B} Hq{Hq} Hkv{Hkv} S{S} "
                f"{'causal' if causal else 'full'} w{window}")
        rel = float(((lse - rlse).abs() / rlse.abs().clamp_min(1.0)).max())
        log(f"    forward lse {case}: max rel err {rel:.3e}")
        if rel > 1e-4:
            fail(f"flash forward lse disagrees ({case}, rel {rel})")
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **opts)
        want = attention_bwd_ref(q, k, v, o, lse, do, **opts)
        for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
            errs.append(check("flash_attention_bwd", f"{case} {name}", g,
                              w_))
        del q, k, v, do, o, lse, got, want
    B, Hq, Hkv, S, D = 4, 28, 4, 2048, 128
    q, k, v = bshd(B, S, Hq, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
    do = bshd(B, S, Hq, D)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    same_bits(torch, "flash_attention_bwd", f"B{B} Hq{Hq} Hkv{Hkv} S{S}",
              lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do))
    planted_fault(torch, report, q, k, v, o, lse, do)
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(B * S * D * 2 * (4 * Hq + 4 * Hkv) + B * Hq * S * 4,
                       5 * 2 * B * Hq * D * pairs, PEAK_BF16)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                        enable_gqa=True)
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "no Pallas counterpart: the JAX package cannot "
                    "differentiate flash_attention_pallas "
                    "(src/repro/kernels/flash_attention/kernel.py:103)",
        "max_abs_err": max(errs),
        "ms": timer.ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse,
                                                        do)),
        "plain_ms": timer.ms(lambda: attention_bwd_ref(q, k, v, o, lse, do),
                             iters=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))})
    del q, k, v, do, o, lse, lq, lk, lv, lo

    # ---- rmsnorm backward ------------------------------------------------
    # the train step's (8192, 3584) bf16 (the bulk path: two blocks an SM,
    # 2 slots each); nemotron-4-340b's width (8 vectors a thread, 2 slots
    # beside w); rows
    # of 1001 bf16, not 16-byte aligned, and of 65536 fp32, too wide for a
    # 2-slot ring (the second path); one row; ragged fp32 and fp16
    eps = 1e-5
    errs = []
    for shape, dtype in (((8192, 3584), bf16), ((77, 1000), bf16),
                         ((300, 3584), torch.float32),
                         ((1024, 18432), bf16), ((77, 1001), bf16),
                         ((1, 3584), bf16), ((5, 65536), torch.float32),
                         ((33, 4096), torch.float16)):
        x = randn(*shape, dtype=dtype)
        w = 1.0 + 0.1 * randn(shape[-1], dtype=torch.float32)
        dy = randn(*shape, dtype=dtype)
        dx, dw = rmsnorm_bwd_cuda(x, w, dy, eps)
        rdx, rdw = rmsnorm_bwd_ref(x, w, dy, eps)
        path = rmsnorm_bwd_launch_args(x, w, dy)[2]["path"]
        case = f"x{shape} {str(dtype)[6:]} ({path})"
        errs.append(check("rmsnorm_bwd", case + " dx", dx, rdx))
        errs.append(check("rmsnorm_bwd_dw", case + " dw", dw, rdw))
    x, dy = randn(8192, 3584), randn(8192, 3584)
    w = 1.0 + 0.1 * randn(3584, dtype=torch.float32)
    same_bits(torch, "rmsnorm_bwd", "x(8192, 3584) bf16",
              lambda: rmsnorm_bwd_cuda(x, w, dy, eps))
    n = x.numel()
    b_ms, b_by = bound(3 * n * 2 + 2 * 3584 * 4, 8 * n, PEAK_FP32)
    lx = x.detach().requires_grad_()
    lw = w.to(bf16).requires_grad_()
    ly = F.rms_norm(lx, (3584,), lw, eps)
    rows.append({
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm_bwd.cu",
        "replaces": "no Pallas counterpart: the JAX package cannot "
                    "differentiate rmsnorm_pallas "
                    "(src/repro/kernels/rmsnorm/kernel.py:35)",
        "max_abs_err": max(errs),
        "ms": timer.ms(lambda: rmsnorm_bwd_cuda(x, w, dy, eps)),
        "plain_ms": timer.ms(lambda: rmsnorm_bwd_ref(x, w, dy, eps)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: torch.autograd.grad(
            ly, (lx, lw), dy, retain_graph=True)),
        # a second yardstick: one elementwise kernel moving the same bytes
        # (reads two tensors, writes one), what a streaming pass reaches
        "add_ms": timer.ms(lambda: torch.add(x, dy)),
        "other_launches_ms": rmsnorm_bwd_other_launches(torch, timer, x, w,
                                                        dy, eps)})
    del x, dy, w, lx, lw, ly
    torch.cuda.empty_cache()
    return rows


def rmsnorm_bwd_other_launches(torch, timer, x, w, dy, eps) -> dict:
    """The rmsnorm backward's launch at the train shape against two other
    launches of the same kernel: one block an SM with 4 ring slots, and two
    blocks an SM with 3.  dx must equal the default launch's bit for bit
    (each row's arithmetic is the same; only dw's order of blocks moves)."""
    from repro_torch.kernels.common import check_status, library, stream_ptr
    from repro_torch.kernels.rmsnorm.kernel import (HEAD_BYTES,
                                                    rmsnorm_bwd_cuda,
                                                    rmsnorm_bwd_launch_args)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x2, dy2, a = rmsnorm_bwd_launch_args(x, w, dy, sms)
    rows, D = a["rows"], a["D"]
    want, _ = rmsnorm_bwd_cuda(x, w, dy, eps)
    out = {}
    for blocks, stages in ((1, 4), (2, 3)):
        grid = min(rows, blocks * sms)
        smem = HEAD_BYTES + 4 * D + stages * 2 * D * x.element_size()
        dx, dw = torch.empty_like(x), torch.empty(D, device="cuda")
        part = torch.empty(grid, D, device="cuda")

        def call():
            check_status("rmsnorm_bwd", library().rmsnorm_bwd(
                x2.data_ptr(), w.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
                dw.data_ptr(), part.data_ptr(), rows, D, a["sx"], a["sdy"],
                D, eps, a["kind"], 1, grid, a["threads"], a["vpt"], stages,
                smem, stream_ptr(x.device)))

        call()
        if not torch.equal(dx, want):
            fail(f"rmsnorm_bwd at {blocks} blocks an SM, {stages} slots: dx "
                 "differs from the default launch's")
        label = f"{blocks} block{'s' * (blocks > 1)} an SM, {stages} slots"
        out[label] = timer.ms(call)
        log(f"  rmsnorm_bwd launch {label}: {out[label]:.4f} ms")
    log(f"  rmsnorm_bwd launch {2 if a['vpt'] == 1 else 1} blocks an SM, "
        f"{a['stages']} slots (the default): see the kernel line below")
    return out


def same_bits(torch, name, case, call):
    """Two calls of a kernel on the same inputs must agree bit for bit:
    every output element is summed by one block in a fixed order (no
    atomics), which the TrainLoop's resume check relies on."""
    a, b = call(), call()
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"  {name:19s} {case:44s} two calls equal bit for bit: {equal}")
    if not equal:
        fail(f"{name} is not deterministic ({case})")


def planted_fault(torch, report, q, k, v, o, lse, do):
    """The flash backward's check must reject a wrong kernel.  Given o = 0,
    the kernel's Delta = rowsum(dO∘O) pass yields 0: the kernel runs as if
    that term were dropped, with no edit to its source.  dv does not use
    Delta; dq and dk must fail the check against the sound plain version."""
    from repro_torch.kernels.common import REL_L2, rel_l2, within
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    key = "flash_attention_bwd/card_bf16"
    want = attention_bwd_ref(q, k, v, o, lse, do)
    got = flash_attention_bwd_cuda(q, k, v, torch.zeros_like(o), lse, do)
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        out[name] = {"elementwise_ok": within(g, w, key),
                     "rel_l2": rel_l2(g, w),
                     "rms_ref": float(w.float().square().mean().sqrt())}
        log(f"    planted fault (Delta dropped) {name}: rel_l2="
            f"{out[name]['rel_l2']:.3e} (limit {REL_L2[key]:g}), elementwise "
            f"check {'passes' if out[name]['elementwise_ok'] else 'fails'}"
            f", rms of the sound {name} {out[name]['rms_ref']:.3e}")
    report["flash_bwd_planted_fault"] = out
    if not (out["dq"]["rel_l2"] > REL_L2[key] and
            out["dk"]["rel_l2"] > REL_L2[key]):
        fail("the flash backward's check does not reject a kernel that "
             "drops Delta")


# ---------------------------------------------------------------------------
# phase 4: decode against forward at full width
# ---------------------------------------------------------------------------


# prefill 1000 + decode 1 against forward 1001, rel L2 of the logits, by
# (arch, layers; None = the published depth).  Each limit is set from the
# bf16 noise floor that the run reports beside it: the same forward with
# the input embeddings perturbed by ~1/2 ulp.  On the H100: qwen2-7b reads
# 1.75e-2 against a floor of 2.14e-2; zamba2-1.2b 0.146 against 0.846 at
# 38 layers (random-init zamba2 amplifies a perturbation of its input with
# depth) and 1.61e-2 against 7.81e-2 at 8 layers.
# The hybrid limits lie at or below half the floor and at about twice the
# reading.  granite-moe-3b-a800m, held with drop-free routing (see
# consistency_moe_phase), reads 8.55e-3 against a floor of 1.14e-2; its
# limit sits just below the floor, as qwen2-7b's does.  xlstm-1.3b reads
# 9.70e-2 against a floor of 0.857 at 48 layers (random-init xlstm, too,
# amplifies its input with depth) and 1.52e-2 against 8.14e-2 at 8 layers
# (one segment); its limits follow the hybrid ones.  starcoder2-15b reads
# 1.289e-2 against a floor of 1.473e-2, nemotron-4-340b at 4 layers
# 1.064e-2 against 1.308e-2, llama3-405b at 4 layers 1.204e-2 against
# 1.679e-2; each limit sits just below its floor, as qwen2-7b's does.
# musicgen-medium (fed seeded embeddings; the floor perturbs them) reads
# 1.4134e-2 against a floor of 1.5148e-2, internvl2-76b at 16 layers
# 1.6974e-2 against 1.8978e-2; their limits sit just below the floors.
CONSISTENCY_LIMIT = {(ARCH, None): 2e-2, (HYBRID_ARCH, None): 0.3,
                     (SSM_ARCH, None): 0.3, (SSM_ARCH, 8): 4e-2,
                     (HYBRID_ARCH, 8): 4e-2, (MOE_ARCH, None): 1.1e-2,
                     (STARCODER_ARCH, None): 1.45e-2,
                     (NEMOTRON_ARCH, NEMOTRON_LAYERS): 1.3e-2,
                     (LLAMA_ARCH, LLAMA_LAYERS): 1.65e-2,
                     (AUDIO_ARCH, None): 1.5e-2,
                     (VLM_ARCH, VLM_LAYERS): 1.85e-2}


def perturb_half_ulp(torch, tok, seed: int = 2) -> None:
    """Multiply each entry of the (rows, D) embedding table or input
    embeddings ``tok`` by 1 + 2^-9·n, n
    ~ N(0, 1), in place: about half a bf16 ulp.  Row blocks of at most 2^26
    entries at a time, so the fp32 copies stay small beside a large table
    (nemotron-4-340b's is 4.7 G entries)."""
    gen = torch.Generator(device=tok.device).manual_seed(seed)
    rows = max(1, (1 << 26) // tok.shape[1])
    for i in range(0, tok.shape[0], rows):
        blk = tok[i:i + rows]
        noise = torch.randn(blk.shape, generator=gen, device=tok.device)
        blk.copy_((blk.float() * (1 + 2 ** -9 * noise)).to(tok.dtype))


@contextlib.contextmanager
def prefill_scan(fn):
    """The SSD models' chunked scan (prefill and forward) replaced by
    ``fn``; their decode step stays ``ssd_step``."""
    import repro_torch.models.ssm as ssm
    import repro_torch.models.xlstm as xlstm
    saved = ssm.ssd_scan, xlstm.ssd_scan
    ssm.ssd_scan = xlstm.ssd_scan = fn
    try:
        yield
    finally:
        ssm.ssd_scan, xlstm.ssd_scan = saved


def scan_state_misses_last_row(c, b, x, log_a, gate):
    """A planted fault for the consistency check: the scan's y, with the
    final state of the rows before the last (decode starts from a state
    that misses the prompt's last token)."""
    from repro_torch.kernels.ssd.ops import ssd_scan
    y, _ = ssd_scan(c, b, x, log_a, gate)
    _, s = ssd_scan(*(t[:, :, :-1] for t in (c, b, x, log_a, gate)))
    return y, s


def decode_vs_forward(torch, params, cfg, seq):
    """fp32 logits of position S+1 two ways: the forward over the S+1
    inputs, and prefill over S then one decode step.  ``seq`` is (B, S+1)
    tokens, or (B, S+1, D) embeddings for the families fed precomputed
    embeddings (vlm, audio)."""
    from repro_torch.models import decode_step, forward, prefill

    key = "tokens" if cfg.frontend == "none" else "embeds"
    S = seq.shape[1] - 1
    hidden, _ = forward(params, {key: seq}, cfg)
    full = (hidden[:, -1] @ params["lm_head"]).float()
    del hidden
    _, state = prefill(params, {key: seq[:, :S]}, cfg, max_len=1024)
    dec, _ = decode_step(params, state, seq[:, S:S + 1], cfg)
    return full, dec.float()


def token_verdict(torch, full, dec, band):
    """Per row: the forward's top two logits, the forward's logit at
    decode's token, their gap to the top in bf16 ulps of the top, and
    whether the gap lies within ``band`` (a tie: 0 when decode picks a
    maximiser of the forward)."""
    top2 = full.topk(2, dim=-1).values
    picked = full.gather(-1, dec.argmax(-1, keepdim=True))[:, 0]
    gap = top2[:, 0] - picked
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs())) - 7)
    rows = [{"top2": [float(a), float(b)], "picked": float(p),
             "gap_ulps": float(g / u), "band": float(w),
             "within": bool(g <= w)}
            for (a, b), p, g, u, w in zip(top2.tolist(), picked, gap, ulp,
                                          band)]
    return rows, bool((gap == 0).all()), all(r["within"] for r in rows)


def consistency_phase(torch, np, report, arch=ARCH, layers=None):
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.models import forward, init_params

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    limit = CONSISTENCY_LIMIT[arch, layers]
    ssd_model = arch in (HYBRID_ARCH, SSM_ARCH)
    embeds = cfg.frontend != "none"
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        rng = np.random.default_rng(1)
        B, S = 2, 1000
        if embeds:
            # seeded N(0, 1) embeddings in the model's dtype, so that the
            # half-ulp perturbation below is one of its inputs
            toks = torch.from_numpy(rng.standard_normal(
                (B, S + 1, cfg.d_model), dtype=np.float32)).cuda().to(
                    torch.bfloat16)
        else:
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, (B, S + 1)).astype(np.int64)).cuda()
        full, dec = decode_vs_forward(torch, params, cfg, toks)
        variants = {}
        if ssd_model:
            # the scan's share of the difference: the plain fp32 scan in the
            # kernel's place; and a wrong decode state the check must see
            with prefill_scan(ssd_ref):
                variants["plain fp32 scan"] = decode_vs_forward(
                    torch, params, cfg, toks)
            if layers is not None:
                with prefill_scan(scan_state_misses_last_row):
                    variants["planted fault (state misses the last token)"] \
                        = decode_vs_forward(torch, params, cfg, toks)
        # the bf16 noise floor: the same forward with the embedding table
        # (or the input embeddings) perturbed by about half an ulp (one
        # rounding at the input instead of the two paths' roundings in
        # every layer)
        if embeds:
            toks = toks.clone()
            perturb_half_ulp(torch, toks.view(-1, cfg.d_model))
        else:
            perturb_half_ulp(torch, params["embed"]["tok"])
        hidden, _ = forward(params, {"embeds" if embeds else "tokens": toks},
                            cfg)
        pert = (hidden[:, -1] @ params["lm_head"]).float()
        del hidden
    floor = float((pert - full).norm() / full.norm())
    # decode's next token must be the forward's.  The forward's own choice
    # is known only as far as its rounding decides it: the logits are bf16
    # products (ulp 2^-5 near the top, ~4), and half an ulp of input
    # rounding moves each by the rms of pert - full in its row, so the gap
    # between two of them by sqrt(2) times that.  Decode's token must lie
    # within that band of the forward's top; with no near-tie that is
    # argmax equality (reported as well).
    band = 2 ** 0.5 * (pert - full).pow(2).mean(-1).sqrt()

    def judge(label, full, dec):
        rel = float((dec - full).norm() / full.norm())
        rows, same, within = token_verdict(torch, full, dec, band)
        log(f"  {label}: rel L2 {rel:.4e} (limit {limit:g}), argmax equal "
            f"{same}, decode's token within the tie band {within}")
        for i, r in enumerate(rows):
            log(f"    row {i}: forward's top two {r['top2'][0]:.5g}, "
                f"{r['top2'][1]:.5g}; decode's token at {r['picked']:.5g} "
                f"({r['gap_ulps']:.3g} ulps below the top), band "
                f"{r['band']:.4g}")
        return {"rel_l2": rel, "argmax_equal": same, "within_band": within,
                "rows": rows, "passes": rel <= limit and within}

    res = judge(f"prefill {S} + decode 1 vs forward {S + 1}", full, dec)
    log(f"  forward vs forward with input embeddings perturbed by ~1/2 ulp:"
        f" rel L2 {floor:.4e}")
    res.update(limit=limit, half_ulp_input_rel_l2=floor)
    for name, (vf, vd) in variants.items():
        res[name] = judge(f"{name}", vf, vd)
    label = arch if layers is None else f"{arch} {layers} layers"
    report["consistency" if arch == ARCH else f"consistency {label}"] = res
    del params, full, dec, pert, variants
    torch.cuda.empty_cache()
    if not res["passes"]:
        fail(f"{label}: decode disagrees with forward at full width")
    fault = res.get("planted fault (state misses the last token)")
    if fault is not None and fault["passes"]:
        fail(f"{label}: the check passes a decode state that misses the "
             "prompt's last token")


# the MoE FFN calls of granite's serve path held card against CPU: a decode
# step of 8 lanes (T 8, C 2) and a prefill wave of 8 x 1024 tokens (T 8192,
# C 2048).  The last number is the weight of a component every token of the
# call shares: it skews the routing, as the model's hidden states do, so
# that some experts overflow C 2048.
MOE_FFN_CALLS = (("decode", 8, 1, 0.0), ("prefill", 8, 1024, 0.3))


def moe_ffn_check(torch, report):
    """One full-width MoE FFN call of granite's published config on the card
    (bf16, the moe_gmm kernel) against the same call on the CPU (the plain
    moe_gmm in fp32, on the same bf16 values), at the serve path's decode
    and prefill sizes, each with assignments dropped.  Both sides must keep
    and drop the same (token, expert) assignments.  The tokens are drawn in
    multiples of 2^-3 and the router in multiples of 2^-17, so each router
    logit is a sum of exact products that fp32 holds exactly: both devices
    compute the same logits in any summation order (checked), and a top-k
    near-tie cannot flip on one side only."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import (REL_L2, TOLERANCES, max_abs_err,
                                            rel_l2, within)
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH)
    D, E, Fe, k = (cfg.d_model, cfg.n_experts_padded, cfg.d_ff_expert,
                   cfg.top_k)
    key = "moe/card_bf16"
    atol, rtol = TOLERANCES[key]
    gen = torch.Generator().manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    router = torch.round(randn(D, E) * D ** -0.5 * 2 ** 17) * 2 ** -17
    p_cpu = {"router": router,
             "w_gate": (randn(E, D, Fe) * D ** -0.5).bfloat16().float(),
             "w_up": (randn(E, D, Fe) * D ** -0.5).bfloat16().float(),
             "w_down": (randn(E, Fe, D) * Fe ** -0.5).bfloat16().float()}
    p_card = {n: v.cuda() if n == "router" else v.bfloat16().cuda()
              for n, v in p_cpu.items()}

    def assignments(st):
        pair = (st["order"] // k) * E + st["expert"]
        return (torch.sort(pair[st["keep"]]).values.cpu(),
                torch.sort(pair[~st["keep"]]).values.cpu())

    out = {}
    for name, B, S, shared in MOE_FFN_CALLS:
        u = randn(1, 1, D)
        x = torch.round((shared * u + (1 - shared ** 2) ** 0.5
                         * randn(B, S, D)) * 8) / 8     # exact in bf16
        ys, routes, logits = {}, {}, {}
        with torch.inference_mode():
            for side, p, xs in (("card", p_card, x.cuda().bfloat16()),
                                ("cpu", p_cpu, x)):
                moe.ROUTING_STATS = []
                try:
                    ys[side] = moe.moe_ffn(p, xs, cfg).float().cpu()
                    st = moe.ROUTING_STATS[0]
                finally:
                    moe.ROUTING_STATS = None
                routes[side] = assignments(st)
                logits[side] = (xs.reshape(-1, D).float()
                                @ p["router"]).cpu()
        top = logits["cpu"][:, :cfg.n_experts].topk(k + 1, dim=-1).values
        margin = float((top[:, k - 1] - top[:, k]).min())
        same_logits = torch.equal(logits["card"], logits["cpu"])
        same_routes = all(torch.equal(a, b) for a, b in
                          zip(routes["card"], routes["cpu"]))
        n_drop = routes["cpu"][1].numel()
        err, rel = max_abs_err(ys["card"], ys["cpu"]), rel_l2(ys["card"],
                                                              ys["cpu"])
        ok = within(ys["card"], ys["cpu"], key) and rel <= REL_L2[key]
        out[name] = {"tokens": B * S, "capacity": moe.capacity(cfg, B * S),
                     "assigned": B * S * k, "dropped": n_drop,
                     "same_logits": same_logits,
                     "smallest_top_k_margin": margin,
                     "same_assignments": same_routes, "max_abs_err": err,
                     "rel_l2": rel}
        log(f"  moe_ffn {name}: T {B * S}, C {out[name]['capacity']}, "
            f"{n_drop} of {B * S * k} assignments dropped; card and CPU "
            f"logits equal {same_logits} (smallest k-th margin {margin:.3e}),"
            f" same kept and dropped assignments {same_routes}; card bf16 vs "
            f"CPU fp32 max_abs_err={err:.3e} (tolerance {atol:g} + "
            f"{rtol:.4g}*|ref|) rel_l2={rel:.3e} (limit {REL_L2[key]:g}) "
            f"{'ok' if ok else 'OUT OF TOLERANCE'}")
        if not (same_logits and margin > 0):
            fail(f"moe_ffn {name}: the router logits are not the same on "
                 "both devices or tie at the k-th place")
        if not same_routes or n_drop == 0:
            fail(f"moe_ffn {name}: the card and the CPU keep different "
                 "assignments, or none was dropped")
        if not ok:
            fail(f"moe_ffn {name}: the card disagrees with the CPU")
        del ys, logits, x
    report["moe_ffn card vs cpu"] = out
    del p_card
    torch.cuda.empty_cache()


def routing_counts(torch, stats):
    """Per MoE call recorded in ``moe.ROUTING_STATS``: tokens, capacity,
    the largest expert load, assignments and dropped assignments."""
    out = []
    for st in stats:
        load = torch.bincount(st["expert"])
        out.append({"tokens": st["tokens"], "capacity": st["capacity"],
                    "max_load": int(load.max()),
                    "assigned": st["keep"].numel(),
                    "dropped": int((~st["keep"]).sum())})
    return out


def same_routing(torch, fwd, pre, S, k) -> bool:
    """B = 1: the forward over S + 1 tokens keeps, among the first S
    tokens, exactly the (token, expert) assignments the prefill over S
    keeps, and keeps every assignment of token S (as the decode step does),
    in every layer."""
    for f, p in zip(fwd, pre):
        def kept(st, n_tok):
            tok = st["order"] // k
            sel = st["keep"] & (tok < n_tok)
            return torch.sort(tok[sel] * 4096 + st["expert"][sel]).values
        if not torch.equal(kept(f, S), kept(p, S)):
            return False
        if not bool(f["keep"][f["order"] // k == S].all()):
            return False
    return True


# prompts tried, longest first, for the MoE consistency check: it is held
# at the first where the two runs keep the same assignments (see
# consistency_moe_phase)
MOE_PROMPTS = (1000, 100, 10, 1)


def consistency_moe_phase(torch, np, report):
    """Full-width granite-moe-3b-a800m at B = 1: prefill S + decode 1 against
    forward S + 1.  A decode step of one token (C = 1) drops nothing, but
    each run routes its prompt under its own capacity (C = 250 for 1000
    tokens, 251 for 1001), so the two compute the same function only where
    they keep the same assignments.  Each prompt of MOE_PROMPTS is run with
    the routing recorded (the largest expert load against C in every layer
    of both runs); the check is held at the first whose routing agrees.
    Where none does, it is held with top_k = n_experts, the drop-free
    routing of the JAX package's own consistency test
    (tests/test_models.py), at the published widths and depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_params, moe,
                                    prefill)

    cfg = get_config(MOE_ARCH)
    out = {"tried": []}
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        rng = np.random.default_rng(1)
        toks_all = torch.from_numpy(rng.integers(
            0, cfg.vocab, (1, MOE_PROMPTS[0] + 1)).astype(np.int64)).cuda()

        def run(c, S):
            toks = toks_all[:, :S + 1]
            runs = {}
            for name in ("forward", "prefill", "decode"):
                moe.ROUTING_STATS = []
                if name == "forward":
                    hidden, _ = forward(params, {"tokens": toks}, c)
                    full = (hidden[:, -1] @ params["lm_head"]).float()
                    del hidden
                elif name == "prefill":
                    _, state = prefill(params, {"tokens": toks[:, :S]}, c,
                                       max_len=S + 8)
                else:
                    dec, _ = decode_step(params, state, toks[:, S:S + 1], c)
                runs[name] = moe.ROUTING_STATS
            moe.ROUTING_STATS = None
            return full, dec, runs

        def reading(full, dec):
            rel = float((dec - full).norm() / full.norm())
            same = bool((dec.argmax(-1) == full.argmax(-1)).all())
            top2 = full.topk(2, dim=-1).values
            return rel, same, float((top2[:, 0] - top2[:, 1]).min())

        held = None
        for S in MOE_PROMPTS:
            full, dec, runs = run(cfg, S)
            counts = {n: routing_counts(torch, st) for n, st in runs.items()}
            agree = same_routing(torch, runs["forward"], runs["prefill"], S,
                                 cfg.top_k)
            rel, same, margin = reading(full, dec)
            entry = {"prompt": S, "routing_agrees": agree, "rel_l2": rel,
                     "argmax_equal": same, "top2_margin": margin,
                     **{f"{n}_capacity": c[0]["capacity"]
                        for n, c in counts.items()},
                     **{f"{n}_max_load": [x["max_load"] for x in c]
                        for n, c in counts.items()},
                     **{f"{n}_dropped": sum(x["dropped"] for x in c)
                        for n, c in counts.items()}}
            out["tried"].append(entry)
            log(f"  prompt {S}: C forward {entry['forward_capacity']}, "
                f"prefill {entry['prefill_capacity']}, decode "
                f"{entry['decode_capacity']}; largest load forward "
                f"{max(entry['forward_max_load'])}, prefill "
                f"{max(entry['prefill_max_load'])}; dropped forward "
                f"{entry['forward_dropped']}, prefill "
                f"{entry['prefill_dropped']}, decode "
                f"{entry['decode_dropped']}; same assignments {agree}; "
                f"rel L2 {rel:.4e}, argmax equal {same}")
            if entry["decode_dropped"]:
                fail("a decode step of one token dropped an assignment")
            if agree:
                held = ("published routing", cfg, S, rel, same, margin)
                break
        if held is None:
            S = MOE_PROMPTS[0]
            c = dataclasses.replace(cfg, top_k=cfg.n_experts)
            log(f"  no prompt of {MOE_PROMPTS} keeps the same assignments in "
                f"both runs: held with top_k = n_experts = {c.top_k} "
                f"(drop-free), prompt {S}")
            full, dec, runs = run(c, S)
            dropped = sum(x["dropped"] for st in runs.values()
                          for x in routing_counts(torch, st))
            if dropped:
                fail(f"top_k = n_experts dropped {dropped} assignments")
            held = (f"top_k = n_experts = {c.top_k}", c, S,
                    *reading(full, dec))
        label, c, S, rel, same, margin = held
        # the bf16 noise floor: the same forward with the embedding table
        # perturbed by about half an ulp (its routing may differ too)
        toks = toks_all[:, :S + 1]
        hidden, _ = forward(params, {"tokens": toks}, c)
        full = (hidden[:, -1] @ params["lm_head"]).float()
        del hidden
        perturb_half_ulp(torch, params["embed"]["tok"])
        hidden, _ = forward(params, {"tokens": toks}, c)
        pert = (hidden[:, -1] @ params["lm_head"]).float()
        floor = float((pert - full).norm() / full.norm())
    limit = CONSISTENCY_LIMIT[MOE_ARCH, None]
    log(f"  held ({label}, prompt {S}): rel L2 {rel:.4e} (limit {limit:g}), "
        f"argmax equal {same} (top-2 margin {margin:.4f}); half-ulp input "
        f"floor {floor:.4e}")
    out.update({"held": label, "prompt": S, "rel_l2": rel, "limit": limit,
                "argmax_equal": same, "top2_margin": margin,
                "half_ulp_input_rel_l2": floor})
    report[f"consistency {MOE_ARCH}"] = out
    del params, hidden
    torch.cuda.empty_cache()
    if not (rel <= limit and same):
        fail(f"{MOE_ARCH}: decode disagrees with forward at full width")


# ---------------------------------------------------------------------------
# phase 5: serving, full width
# ---------------------------------------------------------------------------

EXPECTED = {"rmsnorm": 57 * (2 + 128), "flash_attention": 28 * 2,
            "decode_attention": 28 * 128, "cross_entropy": 0,
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_scan": 0,
            "ssd_scan_wide": 0, "ssd_wide_prep": 0, "moe_gmm": 0}
# zamba2-1.2b: 38 Mamba2 layers in 6 groups of 6 and a tail of 2, the shared
# block after each group.  A pass runs 51 rmsnorms (one per Mamba2 layer,
# two per shared block, the final one); a prefill wave 6 flash and 38 SSD
# launches, a decode step 6 decode-attention launches (its SSD step is plain
# torch, as in the JAX package).  Two waves and 128 decode steps.
HYBRID_EXPECTED = {"rmsnorm": (38 + 2 * 6 + 1) * (2 + 128),
                   "flash_attention": 6 * 2, "decode_attention": 6 * 128,
                   "ssd_scan": 38 * 2, "cross_entropy": 0,
                   "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "moe_gmm": 0,
                   "ssd_scan_wide": 0, "ssd_wide_prep": 0}
# granite-moe-3b-a800m: 32 layers, each 2 rmsnorms and 3 grouped matmuls (the
# experts' gate, up and down products), and the final norm: a pass (a
# prefill wave or a decode step) is 65 rmsnorm and 96 moe_gmm launches.
MOE_EXPECTED = {"rmsnorm": (2 * 32 + 1) * (2 + 128), "flash_attention": 32 * 2,
                "decode_attention": 32 * 128, "moe_gmm": 96 * (2 + 128),
                "ssd_scan": 0, "cross_entropy": 0, "flash_attention_bwd": 0,
                "rmsnorm_bwd": 0, "ssd_scan_wide": 0, "ssd_wide_prep": 0}
# xlstm-1.3b: 6 segments of 7 mLSTM blocks and one sLSTM block.  A pass (a
# prefill wave or a decode step) runs 49 rmsnorms (one per block, the final
# one); a prefill wave runs the wide SSD scan once per mLSTM block, 42, each
# call two kernels (the first pass, ssd_wide_prep, then ssd_scan_wide); a
# decode step none (its SSD step is plain torch, as in the JAX package), and
# the sLSTM is plain torch.  No attention, no MLP.
SSM_EXPECTED = {"rmsnorm": (48 + 1) * (2 + 128), "ssd_scan_wide": 42 * 2,
                "ssd_wide_prep": 42 * 2, "flash_attention": 0,
                "decode_attention": 0, "ssd_scan": 0, "cross_entropy": 0,
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "moe_gmm": 0}
# starcoder2-15b: 40 layers, each 2 rmsnorms, one flash launch a prefill wave
# and one decode launch a step, and the final norm.
STARCODER_EXPECTED = {"rmsnorm": (2 * 40 + 1) * (2 + 128),
                      "flash_attention": 40 * 2, "decode_attention": 40 * 128,
                      "cross_entropy": 0, "flash_attention_bwd": 0,
                      "rmsnorm_bwd": 0, "ssd_scan": 0, "ssd_scan_wide": 0,
                      "ssd_wide_prep": 0,
                      "moe_gmm": 0}
# nemotron-4-340b at NEMOTRON_LAYERS = 4 layers: the same per layer
NEMOTRON_EXPECTED = {**STARCODER_EXPECTED,
                     "rmsnorm": (2 * NEMOTRON_LAYERS + 1) * (2 + 128),
                     "flash_attention": NEMOTRON_LAYERS * 2,
                     "decode_attention": NEMOTRON_LAYERS * 128}
# musicgen-medium (48 layers) and internvl2-76b at VLM_LAYERS = 16: the same
# per layer, fed embeddings (no embedding lookup, which is no kernel)
AUDIO_EXPECTED = {**STARCODER_EXPECTED, "rmsnorm": (2 * 48 + 1) * (2 + 128),
                  "flash_attention": 48 * 2, "decode_attention": 48 * 128}
VLM_EXPECTED = {**STARCODER_EXPECTED,
                "rmsnorm": (2 * VLM_LAYERS + 1) * (2 + 128),
                "flash_attention": VLM_LAYERS * 2,
                "decode_attention": VLM_LAYERS * 128}


SERVE_TRAFFIC = dict(n_requests=16, n_lanes=8, prompt_len=1024, max_new=64,
                     max_len=2048)


def serve_cut(arch: str, layers: int) -> dict:
    """``serve_demo(arch, use_reduced=False, **SERVE_TRAFFIC)`` at a cut
    depth: the same seed, weights and requests, through ``serve_requests``
    with the published config at ``layers`` layers (``serve_demo``, like
    the JAX package's, has no depth override)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import init_params
    from repro_torch.serve.batcher import Request

    t = SERVE_TRAFFIC
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(0)
    requests = [Request(rid=rid, prompt=rng.integers(
        0, cfg.vocab, t["prompt_len"]).astype(np.int32),
        max_new_tokens=t["max_new"]) for rid in range(t["n_requests"])]
    stats, _ = serve_requests(params, cfg, requests, n_lanes=t["n_lanes"],
                              prompt_len=t["prompt_len"],
                              max_len=t["max_len"], device="cuda")
    return stats


def serve_embeds(arch: str, layers=None) -> dict:
    """The serve phases' traffic for a family fed precomputed embeddings
    (vlm, audio), through ``serve/step.py``'s ``make_prefill_step`` and
    ``make_decode_step`` (the JAX package's ``serve_demo`` feeds tokens
    only): 16 requests over 8 lanes in the ``Batcher``, two waves, each
    prefilled with a seeded N(0, 1) embedding of (8, 1024, D) and decoded
    64 steps, each step fed a seeded (8, 1, D) embedding (the frontend is a
    stub: no table embeds the chosen token, which is recorded).  The
    embeddings are made on the host and copied to the card before each
    wave's clock starts.  Returns ``serve_requests``' stats."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import check_card_config
    from repro_torch.models import init_params
    from repro_torch.serve.batcher import Batcher, Request
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    t = SERVE_TRAFFIC
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    check_card_config(cfg, "cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    prefill = make_prefill_step(cfg, max_len=t["max_len"])
    decode = make_decode_step(cfg)
    lanes, S, D = t["n_lanes"], t["prompt_len"], cfg.d_model
    rng = np.random.default_rng(0)
    batcher = Batcher(n_lanes=lanes, max_len=t["max_len"])
    for rid in range(t["n_requests"]):
        batcher.submit(Request(rid=rid, prompt=None,
                               max_new_tokens=t["max_new"]))
    steps = produced = 0
    prefill_s, decode_s = [], 0.0
    wall = 0.0
    while not batcher.idle:
        wave = batcher.admit()
        if not wave:
            break
        prompts = rng.standard_normal((lanes, S, D), dtype=np.float32)
        inputs = rng.standard_normal((t["max_new"], lanes, 1, D),
                                     dtype=np.float32)
        for lane, req in wave:
            req.prompt = prompts[lane]
        prompts_d = torch.from_numpy(prompts).cuda()
        inputs_d = torch.from_numpy(inputs).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, state = prefill(params, {"embeds": prompts_d})
            nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
            prefill_s.append(time.perf_counter() - t0)
            k = 0
            while batcher.active_lanes():
                produced += len(batcher.active_lanes())
                batcher.record_tokens(nxt)
                td = time.perf_counter()
                nxt_t, _, state = decode(params, state, inputs_d[k])
                nxt = nxt_t[:, 0].cpu().numpy()      # waits for the step
                decode_s += time.perf_counter() - td
                steps += 1
                k += 1
        wall += time.perf_counter() - t0
        del prompts_d, inputs_d, state, logits
    return {"requests": len(batcher.finished), "decode_steps": steps,
            "tokens": produced, "tok_per_s": produced / max(wall, 1e-9),
            "wall_s": wall, "prefill_s": prefill_s, "decode_s": decode_s}


def serve_phase(torch, report, arch=ARCH, expected=EXPECTED, layers=None):
    from repro_torch.configs import get_config
    from repro_torch.kernels.common import launches, reset_launches
    from repro_torch.launch.serve import serve_demo
    from repro_torch.models import moe

    def serve():
        if get_config(arch).frontend != "none":
            return serve_embeds(arch, layers)
        if layers is not None:
            return serve_cut(arch, layers)
        return serve_demo(arch, use_reduced=False, device="cuda",
                          **SERVE_TRAFFIC)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve()
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    routing = None
    if arch == MOE_ARCH:
        # the routing is recorded in a second run of the same requests
        # (the same seed, so the same routing), outside the timed and
        # counted one: the record keeps every call's routing tensors alive
        moe.ROUTING_STATS = []
        try:
            serve()
            routing = moe.ROUTING_STATS
        finally:
            moe.ROUTING_STATS = None
    steps = out["decode_steps"]
    log(f"  requests {out['requests']}  tokens {out['tokens']}  decode "
        f"steps {steps}")
    log(f"  prefill ms per wave {[round(s * 1e3, 3) for s in out['prefill_s']]}"
        f"  decode ms per step {out['decode_s'] / max(steps, 1) * 1e3:.3f}  "
        f"tok/s {out['tok_per_s']:.1f}  wall {out['wall_s']:.3f} s")
    log(f"  peak memory {peak / 2**30:.2f} GiB  launches {counts}")
    drops = {}
    if routing is not None:
        # the share of expert assignments dropped (past an expert's
        # capacity), in the prefill waves (C 2048) and the decode steps (C 2)
        counts_by = routing_counts(torch, routing)
        for name, T in (("prefill", 8 * 1024), ("decode", 8)):
            calls = [c for c in counts_by if c["tokens"] == T]
            n = sum(c["assigned"] for c in calls)
            d = sum(c["dropped"] for c in calls)
            drops[name] = {"calls": len(calls), "capacity":
                           calls[0]["capacity"], "assigned": n,
                           "dropped": d, "share": d / n,
                           "max_load": max(c["max_load"] for c in calls)}
            log(f"  {name}: {len(calls)} MoE calls at C "
                f"{calls[0]['capacity']}, {d} of {n} assignments dropped "
                f"(share {d / n:.4f}), largest expert load "
                f"{drops[name]['max_load']}")
        del routing
    report["serve" if arch == ARCH else f"serve {arch}"] = {
        **out, "layers": layers, "peak_bytes": peak, "launches": counts,
        "dropped": drops}
    if out["requests"] != 16 or out["tokens"] != 1024 or steps != 128:
        fail(f"served {out['requests']} requests / {out['tokens']} tokens / "
             f"{steps} steps; expected 16 / 1024 / 128")
    if counts != expected:
        fail(f"launch counts {counts}, expected {expected}")
    return counts


# ---------------------------------------------------------------------------
# phase 6: training, full width at 4 layers
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = 2048, 8, 2
TRAIN_STEPS = 4
# constant: on the H100 the loss on the repeated batch rose again at step 2
# for lr 3e-4, 5e-5 and 2e-5 and fell at every step for 1e-5, 5e-6 and 2e-6
# (this phase with TRAIN_LR set to each); 1e-5 is the largest of those.  The
# params are bf16, as in the JAX package: an update smaller than half a
# bf16 ulp of a weight rounds away.  At step 1 AdamW's update is ~lr·sign(g),
# so at 1e-5 no weight with |p| >= 2^-8 moves; the phase counts the bf16
# weights left unchanged by its first and last steps.
TRAIN_LR = 1e-5
# per step at L = 4, M = 2 (remat reruns each layer's 2 norms and 1 flash
# forward in the backward; the final norm and the CE head are not remat'd)
TRAIN_EXPECTED = {
    "rmsnorm": TRAIN_MB * (2 * TRAIN_LAYERS * 2 + 1),
    "rmsnorm_bwd": TRAIN_MB * (2 * TRAIN_LAYERS + 1),
    "flash_attention": TRAIN_MB * TRAIN_LAYERS * 2,
    "flash_attention_bwd": TRAIN_MB * TRAIN_LAYERS,
    "cross_entropy": TRAIN_MB,
    "decode_attention": 0,
    "ssd_scan": 0,
    "ssd_scan_wide": 0,
    "ssd_wide_prep": 0,
    "moe_gmm": 0,
}
# a small config the kernels take (bf16, head dim 128) for the TrainLoop
LOOP_OVERRIDES = dict(dtype="bfloat16", d_model=256, n_heads=2,
                      n_kv_heads=1)


def train_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)


def matmul_flop_per_step(cfg) -> float:
    """Matmul FLOP of one step: forward, remat forward and backward of the
    layers' projections (8·tokens·N_layers), and the LM head's forward, the
    CE backward's recompute and its two products (8·tokens·N_head)."""
    D, dh = cfg.d_model, cfg.d_head
    per_layer = D * cfg.n_heads * dh * 2 + D * cfg.n_kv_heads * dh * 2 \
        + 3 * D * cfg.d_ff
    tokens = TRAIN_SEQ * TRAIN_BATCH
    return 8.0 * tokens * (cfg.n_layers * per_layer + D * cfg.vocab_padded)


def _bf16_leaves(torch, params):
    from repro_torch.optim.optimizers import tree_leaves
    return [p.reshape(-1) for p in tree_leaves(params)
            if p.dtype == torch.bfloat16]


CHUNK = 1 << 26        # elements a comparison handles at once on the card


def share_at_least(torch, params, thr: float) -> float:
    """Share of the bf16 weights with |p| >= thr."""
    n = total = 0
    for p in _bf16_leaves(torch, params):
        for i in range(0, p.numel(), CHUNK):
            n += int((p[i:i + CHUNK].abs() >= thr).sum())
        total += p.numel()
    return n / total


def unchanged_share(torch, params, before) -> float:
    """Share of the bf16 weights equal to ``before`` (their host copies),
    compared chunk by chunk on the card."""
    same = total = 0
    for p, b in zip(_bf16_leaves(torch, params), before):
        for i in range(0, p.numel(), CHUNK):
            same += int((p[i:i + CHUNK] ==
                         b[i:i + CHUNK].to(p.device)).sum())
        total += p.numel()
    return same / total


def train_phase(torch, np, report):
    from repro_torch.data.lm import DataConfig, global_batch_at
    from repro_torch.kernels.common import launches, reset_launches
    from repro_torch.kernels.cross_entropy.ops import ce_forward
    from repro_torch.kernels.cross_entropy.ref import ce_backward_chunked
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = train_config()
    log(f"  qwen2-7b widths, {cfg.n_layers} layers (reduced from 28: "
        f"training keeps 16 B a parameter, and 28 layers are 122 GB on an "
        f"80 GB card); {cfg.params_count() / 1e9:.3f} B parameters, "
        f"remat={cfg.remat} ({cfg.remat_policy}), {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    step = make_train_step(cfg, adamw(lr=TRAIN_LR))
    opt_state = step.init_opt_state(params)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, microbatches=TRAIN_MB,
                      seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in global_batch_at(data, 0).items()}
    tokens = TRAIN_SEQ * TRAIN_BATCH
    # for |p| in [2^e, 2^(e+1)) the bf16 spacing is 2^(e-7), and a change
    # below half of it rounds away: from the least e with 2^(e-8) > lr up,
    # a step of ~lr moves no weight
    ulp_thr = 2.0 ** (int(np.floor(np.log2(TRAIN_LR))) + 9)
    above_thr = share_at_least(torch, params, ulp_thr)
    losses, times, norms, unchanged = [], [], [], {}
    torch.cuda.synchronize()
    reset_launches()
    for i in range(TRAIN_STEPS):
        before = ([p.to("cpu", copy=True)
                   for p in _bf16_leaves(torch, params)]
                  if i in (0, TRAIN_STEPS - 1) else None)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"].item()))
        norms.append(float(metrics["grad_norm"].item()))
        times.append(time.perf_counter() - t0)
        if before is not None:
            unchanged[i + 1] = unchanged_share(torch, params, before)
            del before
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(times[1:])) * 1e3
    flop = matmul_flop_per_step(cfg)

    # the CE backward's share: the chunked fp32 recompute at this shape,
    # timed alone on the last hidden-sized input and the LM head (the
    # timer's flush buffer exists only here, after the peak was read)
    timer = Timer(torch)
    x = torch.randn(tokens // TRAIN_MB, cfg.d_model, device="cuda",
                    dtype=torch.bfloat16)
    lab = batch["labels"][0].reshape(-1)
    valid = lab >= 0
    w = params["lm_head"].detach()
    lse, _ = ce_forward(x, w, lab, cfg.vocab)
    g = torch.ones((), device="cuda")
    ce_bwd_ms = timer.ms(lambda: ce_backward_chunked(x, w, lab, valid, lse,
                                                     g, cfg.vocab),
                         iters=2, warmup=1)
    del x, lse, timer
    share = TRAIN_MB * ce_bwd_ms / step_ms
    log(f"  lr {TRAIN_LR:g}  losses {[round(v, 4) for v in losses]}  grad "
        f"norms {[round(v, 3) for v in norms]}")
    log(f"  bf16 weights with |p| >= {ulp_thr:g} (half an ulp > lr) at "
        f"init: {above_thr:.4f}; unchanged by step "
        + ", step ".join(f"{k}: {v:.4f}" for k, v in unchanged.items()))
    log(f"  step ms {[round(t * 1e3, 1) for t in times]}  (median after the "
        f"first: {step_ms:.1f} ms)  tokens/s {tokens / step_ms * 1e3:.0f}  "
        f"matmul TFLOP a step {flop / 1e12:.1f} "
        f"({flop / step_ms / 1e9:.1f} TFLOP/s)")
    log(f"  CE backward {ce_bwd_ms:.1f} ms a microbatch: {share:.3f} of the "
        f"step  peak memory {peak / 2**30:.2f} GiB  launches {counts}")
    expected = {k: v * TRAIN_STEPS for k, v in TRAIN_EXPECTED.items()}
    report["train"] = {
        "layers": cfg.n_layers, "reduced": "depth 28 -> 4 (memory)",
        "lr": TRAIN_LR, "bf16_share_half_ulp_above_lr": above_thr,
        "bf16_share_unchanged_by_step": unchanged,
        "params": cfg.params_count(), "tokens_per_step": tokens,
        "losses": losses, "grad_norms": norms, "step_s": times,
        "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "matmul_flop_per_step": flop, "ce_bwd_ms_per_microbatch": ce_bwd_ms,
        "ce_bwd_share": share, "peak_bytes": peak, "launches": counts}
    del params, opt_state, batch, step, w
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"the loss did not fall at every step on a repeated batch: "
             f"{losses}")
    if counts != expected:
        fail(f"train launch counts {counts}, expected {expected}")
    loop_phase(torch, report)
    return counts


def loop_phase(torch, report):
    """TrainLoop on the card: an uninterrupted run against a run preempted
    at step 2 and resumed from its checkpoint."""
    from repro_torch.launch.train import build_trainer
    from repro_torch.train import PreemptionError

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(use_reduced=True, overrides=LOOP_OVERRIDES, seq_len=64,
              global_batch=4, microbatches=2, total_steps=5, ckpt_every=2,
              device="cuda")
    whole = build_trainer(ARCH, ckpt_dir=str(root / "whole"), **kw).run()
    first = build_trainer(ARCH, ckpt_dir=str(root / "preempted"),
                          inject_preemption_at=2, **kw)
    try:
        first.run()
        fail("the injected preemption at step 2 did not happen")
    except PreemptionError:
        pass
    resumed = build_trainer(ARCH, ckpt_dir=str(root / "preempted"),
                            **kw).run()
    got = first.state.losses + resumed.losses
    log(f"  TrainLoop (reduced, bf16, head dim 128): uninterrupted "
        f"{[round(v, 6) for v in whole.losses]}")
    log(f"  preempted at 2, resumed from {resumed.resumed_from}: "
        f"{[round(v, 6) for v in got]}  equal {got == whole.losses}")
    report["train_loop"] = {"whole": whole.losses, "preempted_resumed": got,
                            "resumed_from": resumed.resumed_from}
    shutil.rmtree(root, ignore_errors=True)
    if resumed.resumed_from != 2 or got != whole.losses:
        fail("the resumed TrainLoop's losses differ from the uninterrupted "
             "run's")


# ---------------------------------------------------------------------------
# optional: where the serving time goes (torch.profiler)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the tabular main path: examples/quickstart.py's batch on the card
# ---------------------------------------------------------------------------

TABULAR_ROWS = 1_000_000
TABULAR_CHECK_ROWS = 100_000      # the tier comparison's size
TABULAR_BUDGET = 16 << 30
# the scheduler shapes its waves by the thread count (os.cpu_count() when
# 0): fixed, so the plan is the reference's on any host
TABULAR_THREADS = 8
# the reference's plan for this batch at this size and budget
# (repro.client.connect("local", ...) with compiled_segments=False)
TABULAR_EXPECTED = {"submitted": 6, "planned": 42, "cse": 6, "pushed": 4,
                    "waves": 14, "inter_op": 6,
                    "tiers": {"torch": 31, "python": 11},
                    "second_run_cache_hits": 40}
TABULAR_TIER_RTOL = 1e-4


def tabular_batch(T, data, rows):
    """examples/quickstart.py's two pipelines, from the port: 3-fold CV of
    ridge and of a 20-tree GBT over table_vectorizer features."""
    from repro_torch.core import PipelineBatch

    feats, tgt = data.feature_target_indices()
    raw = T.read("uk_housing", n_rows=rows, seed=0)
    y = T.project(raw, [tgt])
    X = T.table_vectorizer(T.project(raw, feats), data.schema_dict(), feats)
    ridge = T.cv_score(X, y, {"name": "ridge_fit", "alpha": 1.0}, k=3,
                       seed=7)
    gbt = T.cv_score(X, y, {"name": "gbt_fit", "n_trees": 20}, k=3, seed=7)
    return PipelineBatch([ridge, gbt], ["ridge", "gbt"]), X, y


def tabular_client(enable=None):
    from repro_torch.client import StratumConfig, connect

    kw = {} if enable is None else {"enable": enable}
    return connect("local", StratumConfig.make(
        memory_budget_bytes=TABULAR_BUDGET, compiled_segments=False,
        hardware_threads=TABULAR_THREADS, **kw))


def tabular_phase(torch, np, report):
    import repro_torch.tabular as T
    from repro_torch.core import ALL_FEATURES, PipelineBatch
    from repro_torch.core.runtime import crossings, reset_crossings
    from repro_torch.data import tabular as data
    from repro_torch.kernels.common import launches, reset_launches
    from repro_torch.tabular import gbt

    t0 = time.perf_counter()
    for rows in (TABULAR_ROWS, TABULAR_CHECK_ROWS):
        data.ensure_files("uk_housing", rows, 0)
    lake_s = time.perf_counter() - t0
    log(f"  lake (CSV and .npy of {TABULAR_ROWS} and {TABULAR_CHECK_ROWS} "
        f"rows) written in {lake_s:.1f} s, before the clock")

    batch, X, y = tabular_batch(T, data, TABULAR_ROWS)
    client = tabular_client()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    runs = []
    for _ in range(2):
        reset_crossings()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, rep = client.run_batch(batch)
        torch.cuda.synchronize()
        runs.append((results, rep, time.perf_counter() - t0, crossings()))
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    (res1, rep1, wall1, cross1), (res2, rep2, wall2, cross2) = runs
    scores = {k: float(v) for k, v in res1.items()}
    got = {"submitted": rep1.ops_submitted, "planned": rep1.ops_planned,
           "cse": rep1.rewrites.cse_merged,
           "pushed": rep1.rewrites.projections_pushed,
           "waves": rep1.run.waves,
           "inter_op": rep1.plan.inter_op_parallelism,
           "tiers": dict(rep1.run.per_backend),
           "second_run_cache_hits": rep2.run.ops_from_cache}
    log(f"  {TABULAR_ROWS} rows, budget {TABULAR_BUDGET >> 30} GiB, "
        f"hardware_threads {TABULAR_THREADS}: scores {scores}")
    for line in rep1.summary().splitlines():
        log(f"    {line}")
    log(f"  first run {wall1:.3f} s (optimize_time_s "
        f"{rep1.optimize_time_s:.4f}), second run {wall2:.4f} s with "
        f"{rep2.run.ops_from_cache} ops from the cache; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    for label, cross in (("first", cross1), ("second", cross2)):
        log(f"  host<->device crossings, {label} run: {cross['to_device']} "
            f"to the card ({cross['to_device_bytes'] / 2**20:.1f} MiB), "
            f"{cross['to_host']} to the host "
            f"({cross['to_host_bytes'] / 2**20:.1f} MiB)")
    names = {op.signature: op.op_name for w in rep1.plan.waves
             for op in w.ops}
    off_card = sorted(
        (names[sig], where) for sig, where in rep1.run.placement.items()
        if rep1.run.sig_source[sig] == "torch" and names[sig] != "read"
        and not all(w.startswith("cuda") for w in where))
    read_out = [where for sig, where in rep1.run.placement.items()
                if names[sig] == "read"]
    log(f"  outputs of torch ops off the card: {off_card or 'none'} "
        f"(read's, host numpy as the reference's: {read_out})")
    same = {k: float(res2[k]) == v for k, v in scores.items()}
    log(f"  second run's scores equal the first's bit for bit: {same}")

    # the tiers against each other: the same batch at 100,000 rows through
    # the torch tier on the card and through the python tier alone
    tiers = {}
    for label, enable in (("torch", None), ("python", tuple(
            f for f in ALL_FEATURES if f != "selection"))):
        small, _, _ = tabular_batch(T, data, TABULAR_CHECK_ROWS)
        t0 = time.perf_counter()
        res, rep = tabular_client(enable).run_batch(small)
        torch.cuda.synchronize()
        tiers[label] = ({k: float(v) for k, v in res.items()},
                        dict(rep.run.per_backend),
                        time.perf_counter() - t0)
    rel = {k: abs(tiers["torch"][0][k] - v) / abs(v)
           for k, v in tiers["python"][0].items()}
    for label, (sc, per, wall) in tiers.items():
        log(f"  {TABULAR_CHECK_ROWS} rows, {label} tier: scores {sc}, "
            f"{per}, {wall:.2f} s")
    log(f"  torch tier on the card against the python tier, relative "
        f"difference: {rel} (limit {TABULAR_TIER_RTOL:g})")

    # two GBT fits on the card, on the first fold's training rows
    xtr, ytr, _, _ = T.kfold_split(X, y, 3, 0, seed=7)
    fold, _ = client.run_batch(PipelineBatch([xtr, ytr], ["x", "y"]))
    xt = torch.from_numpy(np.asarray(fold["x"])).cuda()
    yt = torch.from_numpy(np.asarray(fold["y"])).cuda()
    fits = [gbt.fit_torch(xt, yt, n_trees=20) for _ in range(2)]
    torch.cuda.synchronize()
    fits_equal = bool(torch.equal(*fits))
    log(f"  two GBT fits on the card ({tuple(xt.shape)}, 20 trees) equal "
        f"bit for bit: {fits_equal}")
    # the counters were zeroed before the two timed runs: ``counts`` is the
    # path's, ``counts_all`` adds the tier runs and the fits
    counts_all = launches()
    log(f"  launches {counts} (with the tier runs and the fits: "
        f"{counts_all})")
    del xt, yt, fits, fold

    report["tabular"] = {
        "rows": TABULAR_ROWS, "budget_bytes": TABULAR_BUDGET,
        "hardware_threads": TABULAR_THREADS, "lake_s": lake_s,
        "scores": scores, "plan": got, "wall_s": [wall1, wall2],
        "optimize_time_s": rep1.optimize_time_s, "peak_bytes": peak,
        "crossings": [cross1, cross2], "off_card": off_card,
        "second_run_equal": same, "tiers": {
            k: {"scores": v[0], "per_backend": v[1], "wall_s": v[2]}
            for k, v in tiers.items()},
        "tier_rel_diff": rel, "gbt_fits_equal": fits_equal,
        "launches": counts, "launches_with_checks": counts_all}
    if got != TABULAR_EXPECTED:
        fail(f"plan {got}, expected the reference's {TABULAR_EXPECTED}")
    if off_card or read_out != [("numpy",)]:
        fail(f"torch ops' outputs off the card: {off_card}; read's "
             f"{read_out}")
    if not all(same.values()):
        fail(f"the second run's scores differ from the first's: {same}")
    if tiers["torch"][1] != TABULAR_EXPECTED["tiers"] or \
            tiers["python"][1] != {"python": 42}:
        fail(f"tier runs {tiers['torch'][1]} / {tiers['python'][1]}")
    if not all(r <= TABULAR_TIER_RTOL for r in rel.values()):
        fail(f"torch tier against python tier {rel} > {TABULAR_TIER_RTOL}")
    if not fits_equal:
        fail("two GBT fits on the card differ")
    if any(counts.values()) or any(counts_all.values()):
        fail(f"a hand kernel launched on the tabular path: {counts}, "
             f"{counts_all}")
    return counts


# ---------------------------------------------------------------------------
# the agentic path: the paper's pipeline search at the client's defaults
# ---------------------------------------------------------------------------

AGENTIC_ROWS = TABULAR_ROWS
AGENTIC_BUDGET = 16 << 30
AGENTIC_THREADS = 8
AGENTIC_ALPHAS = (0.1, 1.0, 10.0, 123.0)
# the reference's counts at these rows, budget and threads, at the client's
# defaults (compiled segments on; repro on the CPU, "jax" read as "torch"):
# per-tier ops, waves, plan-cache misses and hits, ops from the cache
AGENTIC_QUICKSTART = (
    ({"torch": 17, "torch-seg": 14, "python": 11}, 14, 2, 0, 0),
    ({"python": 2}, 14, 0, 0, 40))
AGENTIC_ITER1 = ({"torch": 71, "torch-seg": 16, "python": 38}, 16, 2, 0, 0)
# iteration 2 depends on iteration 1's winner: the reference's counts for
# each of the 8 possible winners
AGENTIC_ITER2 = {
    "manual+elasticnet": ({"torch": 33, "torch-seg": 36, "python": 39,
                           "torch-vmap": 11}, 16, 3, 0, 0),
    "manual+ridge": ({"torch": 26, "torch-seg": 48, "python": 35}, 14, 3,
                     0, 0),
    "table_vectorizer+ridge": ({"torch": 18, "torch-seg": 45,
                                "python": 33}, 15, 3, 0, 7),
    "table_vectorizer+elasticnet": ({"torch": 31, "torch-seg": 34,
                                     "python": 37, "torch-vmap": 9}, 16, 3,
                                    0, 2),
    "manual+gbt_xgboost": ({"torch": 46, "torch-seg": 16, "python": 47}, 15,
                           2, 0, 0),
    "manual+gbt_lightgbm": ({"torch": 46, "torch-seg": 16, "python": 47},
                            15, 2, 0, 0),
    "table_vectorizer+gbt_xgboost": ({"torch": 41, "torch-seg": 15,
                                      "python": 45}, 16, 2, 0, 2),
    "table_vectorizer+gbt_lightgbm": ({"torch": 41, "torch-seg": 15,
                                       "python": 45}, 16, 2, 0, 2),
}


def _plan_counts(rep):
    return (dict(rep.run.per_backend), rep.run.waves,
            rep.run.plan_cache_misses, rep.run.plan_cache_hits,
            rep.run.ops_from_cache)


def agentic_client(cache_dir, **kw):
    """A local client at the client's defaults (compiled segments on) on
    the card, with inductor's cache in ``cache_dir``."""
    from repro_torch.client import StratumConfig, connect

    kw.setdefault("memory_budget_bytes", AGENTIC_BUDGET)
    return connect("local", StratumConfig.make(
        hardware_threads=AGENTIC_THREADS, jit_cache_dir=cache_dir, **kw))


def _segments_checked(client, rep, label, problems):
    """Every run of the phase: no uncompilable segment, and every compiled
    op's outputs on the card."""
    st = client.stratum
    unc = st.plan_cache.snapshot()["uncompilable"]
    off = sorted({where for sig, where in rep.run.placement.items()
                  if rep.run.sig_source.get(sig) == "torch-seg"
                  and not all(w.startswith("cuda") for w in where)})
    if unc or off:
        problems.append(f"{label}: uncompilable {unc}, torch-seg outputs "
                        f"off the card {off}")


def _ridge_fan(T, alphas, rows):
    from repro_torch.core import PipelineBatch

    x = T.read("uk_housing", rows, seed=0)
    y = T.project(x, [0])
    Xs = T.scale(T.impute(T.project(x, [10, 11, 12, 13])))
    sinks = [T.metric(y, T.predict(T.ridge_fit(Xs, y, alpha=a), Xs),
                      kind="rmse") for a in alphas]
    return PipelineBatch(sinks, [f"a{i}" for i in range(len(alphas))])


def agentic_phase(torch, np, report):
    import tempfile

    from repro_torch.data import tabular as data
    from repro_torch.kernels.common import launches, reset_launches

    card = report.get("card", "")
    t_phase = time.perf_counter()
    data.ensure_files("uk_housing", AGENTIC_ROWS, 0)
    cache_dir = tempfile.mkdtemp(prefix="inductor-")
    out = report["agentic"] = {"rows": AGENTIC_ROWS, "card": card}
    problems: list = []
    reset_launches()
    try:
        _agentic_checks(torch, np, report, out, problems, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    counts = launches()
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {counts}; phase {out['phase_s']:.1f} s ({card})")
    if any(counts.values()):
        problems.append(f"a hand kernel launched on the agentic path: "
                        f"{counts}")
    if problems:
        fail("agentic: " + "; ".join(problems))
    return counts


def _agentic_checks(torch, np, report, out, problems, cache_dir):
    """Checks (a)-(f) of the agentic phase; each failure is appended to
    ``problems``."""
    import repro_torch.tabular as T
    from repro_torch.agents import (AIDEAgent, AsyncAIDESearch,
                                    paper_workload_batches)
    from repro_torch.agents.aide import second_iteration_batch
    from repro_torch.core.runtime import crossings, reset_crossings
    from repro_torch.data import tabular as data

    card = out["card"]

    def stats(client):
        return client.stratum._backends["torch"].stats()

    # (a) the quickstart batch at the client's defaults, twice
    batch, _, _ = tabular_batch(T, data, AGENTIC_ROWS)
    client = agentic_client(cache_dir)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        reset_crossings()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, rep = client.run_batch(batch)
        torch.cuda.synchronize()
        runs.append((res, rep, time.perf_counter() - t0, crossings()))
        _segments_checked(client, rep, "quickstart", problems)
    peak = torch.cuda.max_memory_allocated()
    (res1, rep1, wall1, cross1), (res2, rep2, wall2, cross2) = runs
    scores = {k: float(v) for k, v in res1.items()}
    same = {k: float(res2[k]) == v for k, v in scores.items()}
    got = [_plan_counts(rep1), _plan_counts(rep2)]
    st = stats(client)
    per_op = report.get("tabular", {}).get("scores")
    if per_op is None:        # the tabular phase did not run: its per-op run
        res, _ = tabular_client().run_batch(batch)
        per_op = {k: float(v) for k, v in res.items()}
    rel = {k: abs(scores[k] - v) / abs(v) for k, v in per_op.items()}
    log(f"  (a) quickstart, {AGENTIC_ROWS} rows, compiled segments: "
        f"scores {scores}")
    log(f"      first run {wall1:.3f} s {got[0]}, second run {wall2:.4f} s "
        f"{got[1]} (reference: {list(AGENTIC_QUICKSTART)})")
    log(f"      traced {st['traces']} segment(s) in {st['trace_s']:.2f} s, "
        f"compiled {st['compiles']} in {st['compile_s']:.2f} s; peak device "
        f"memory {peak / 2**30:.2f} GiB; second run's scores equal bit for "
        f"bit: {same}")
    for label, cross in (("first", cross1), ("second", cross2)):
        log(f"      crossings, {label} run: {cross['to_device']} to the card "
            f"({cross['to_device_bytes'] / 2**20:.1f} MiB), "
            f"{cross['to_host']} to the host "
            f"({cross['to_host_bytes'] / 2**20:.1f} MiB)")
    log(f"      against the tabular phase's per-op scores: relative "
        f"difference {rel} (limit {TABULAR_TIER_RTOL:g}) ({card})")
    out["quickstart"] = {
        "scores": scores, "counts": got, "wall_s": [wall1, wall2],
        "segment_stats": st, "peak_bytes": peak,
        "crossings": [cross1, cross2], "second_run_equal": same,
        "per_op_rel_diff": rel}
    if tuple(got) != AGENTIC_QUICKSTART:
        problems.append(f"quickstart counts {got}, the reference's "
                        f"{AGENTIC_QUICKSTART}")
    if not all(same.values()):
        problems.append(f"quickstart second run differs: {same}")
    if not all(r <= TABULAR_TIER_RTOL for r in rel.values()):
        problems.append(f"quickstart against per-op {rel}")
    client.close()

    # (b) the paper workload as examples/agentic_search.py's run_sync
    # runs it: iteration 1, then the grid on its winner
    client = agentic_client(cache_dir)
    _n, batch1, ctx = next(iter(paper_workload_batches(
        n_rows=AGENTIC_ROWS, cv_k=3)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, rep = client.run_batch(batch1)
    torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t0
    _segments_checked(client, rep, "iteration 1", problems)
    scores1 = {k: float(v) for k, v in res.items()}
    best = min(scores1, key=scores1.get)
    batch2, specs2 = second_iteration_batch(ctx["specs"][best])
    t0 = time.perf_counter()
    res2, rep2 = client.run_batch(batch2)
    torch.cuda.synchronize()
    wall_2 = time.perf_counter() - t0
    _segments_checked(client, rep2, "iteration 2", problems)
    scores2 = {k: float(v) for k, v in res2.items()}
    it1, it2 = _plan_counts(rep), _plan_counts(rep2)
    want2 = AGENTIC_ITER2.get(best)
    st = stats(client)
    log(f"  (b) paper workload, iteration 1 (8 pipelines) {wall_1:.2f} s: "
        f"{it1} (reference {AGENTIC_ITER1}); winner {best}")
    for k, v in sorted(scores1.items(), key=lambda kv: kv[1]):
        log(f"      rmse {v:.6f}  {k}")
    log(f"      iteration 2 ({len(scores2)} grid points) {wall_2:.2f} s: "
        f"{it2} (reference for {best}: {want2}); best "
        f"{min(scores2.values()):.6f}; segments traced {st['traces']}, "
        f"compiled {st['compiles']} in {st['compile_s']:.2f} s ({card})")
    out["paper"] = {"iteration1": {"counts": it1, "scores": scores1,
                                   "wall_s": wall_1},
                    "winner": best,
                    "iteration2": {"counts": it2, "scores": scores2,
                                   "wall_s": wall_2},
                    "segment_stats": st}
    if it1 != AGENTIC_ITER1:
        problems.append(f"iteration 1 counts {it1}, reference "
                        f"{AGENTIC_ITER1}")
    if want2 is None:
        problems.append(f"no reference counts for winner {best}")
    elif it2 != want2:
        problems.append(f"iteration 2 counts {it2}, reference {want2}")
    if not all(np.isfinite(v) for v in (*scores1.values(),
                                        *scores2.values())):
        problems.append("a paper-workload score is not finite")
    client.close()

    # (c) reuse across hyperparameters: one ridge pipeline at four alphas,
    # the intermediate cache off; then a fan of alphas as one program
    no_cache = ("logical", "lowering", "selection", "parallel")
    client = agentic_client(cache_dir, enable=no_cache)
    compiles = []
    for alpha in AGENTIC_ALPHAS:
        res, rep = client.run_batch(_ridge_fan(T, (alpha,), AGENTIC_ROWS))
        _segments_checked(client, rep, f"alpha {alpha}", problems)
        compiles.append((client.stratum.plan_cache.snapshot()["compiles"],
                         stats(client)["traces"]))
    client.close()
    vb = agentic_client(cache_dir, enable=no_cache, batch_variants=True)
    fans = []
    for alphas in ((0.5, 1.0, 2.0), (3.0, 5.0, 7.0)):
        res, rep = vb.run_batch(_ridge_fan(T, alphas, AGENTIC_ROWS))
        _segments_checked(vb, rep, f"fan {alphas}", problems)
        fans.append((dict(rep.run.per_backend),
                     vb.stratum.plan_cache.snapshot()["compiles"]))
    batched = [p.batched for p in vb.stratum.plan_cache._entries.values()]
    vb.close()
    log(f"  (c) ridge at alphas {AGENTIC_ALPHAS}, cache off: (plan-cache "
        f"compiles, traces) after each {compiles}; batch_variants fans: "
        f"{fans}, programs batched {batched}")
    out["reuse"] = {"compiles": compiles, "fans": fans, "batched": batched}
    if len(set(compiles)) != 1 or compiles[0][0] < 1:
        problems.append(f"alphas recompiled: {compiles}")
    if fans[0][1] != fans[1][1] or not batched or not all(batched) or \
            "torch-seg" not in fans[0][0]:
        problems.append(f"fans {fans}, batched {batched}")

    # (d) compile_async: the first touch runs per-op, the next one hits
    client = agentic_client(cache_dir, enable=no_cache, compile_async=True)
    _, rep_a = client.run_batch(_ridge_fan(T, (0.5, 1.5), AGENTIC_ROWS))
    drained = client.stratum.plan_cache.executor.drain(timeout=600)
    _, rep_b = client.run_batch(_ridge_fan(T, (2.5, 3.5), AGENTIC_ROWS))
    _segments_checked(client, rep_b, "async", problems)
    snap = client.stratum.plan_cache.snapshot()
    client.close()
    log(f"  (d) compile_async: first touch {dict(rep_a.run.per_backend)}, "
        f"fallback rounds {rep_a.run.plan_cache_fallback_rounds}; after the "
        f"drain {dict(rep_b.run.per_backend)}, hits "
        f"{rep_b.run.plan_cache_hits}, background compile "
        f"{snap['compile_time_s']:.2f} s")
    out["async"] = {"first": dict(rep_a.run.per_backend),
                    "fallback_rounds": rep_a.run.plan_cache_fallback_rounds,
                    "second": dict(rep_b.run.per_backend),
                    "hits": rep_b.run.plan_cache_hits, "snapshot": snap}
    if not (drained and rep_a.run.plan_cache_fallback_rounds == 1
            and "torch-seg" not in rep_a.run.per_backend
            and rep_b.run.plan_cache_hits >= 1
            and "torch-seg" in rep_b.run.per_backend
            and snap["async_failures"] == 0):
        problems.append(f"compile_async {out['async']}")

    # (e) analyze_batch on iteration 1, then its run: no probe again
    client = agentic_client(cache_dir)
    t0 = time.perf_counter()
    analysis = client.analyze(batch1)
    analyze_s = time.perf_counter() - t0
    before = stats(client)
    _, rep = client.run_batch(batch1)
    after = stats(client)
    _segments_checked(client, rep, "after analysis", problems)
    n_seg = sum(1 for seg in rep.plan.segments if seg.kind == "torch")
    log(f"  (e) analyze_batch on iteration 1 in {analyze_s:.2f} s: "
        f"{len(analysis.errors)} errors, {analysis.preverified_segments} "
        f"segments pre-verified of the plan's {n_seg}; traces before the "
        f"run {before['traces']}, after {after['traces']}")
    out["analysis"] = {"errors": len(analysis.errors),
                       "preverified": analysis.preverified_segments,
                       "torch_segments": n_seg, "traces": [
                           before["traces"], after["traces"]],
                       "analyze_s": analyze_s}
    if analysis.errors or analysis.preverified_segments != n_seg or \
            after["traces"] != before["traces"]:
        problems.append(f"analysis {out['analysis']}")
    client.close()

    # (f) AsyncAIDESearch on a local session: 2 rounds of 4
    client = agentic_client(cache_dir)
    search = AsyncAIDESearch(client.session("aide"),
                             AIDEAgent(n_rows=AGENTIC_ROWS, seed=0),
                             batch_size=4, max_inflight=2)
    t0 = time.perf_counter()
    node = search.run(n_rounds=2)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    for rep in search.reports:
        _segments_checked(client, rep, "search", problems)
    client.close()
    ok = node is not None and np.isfinite(node.score)
    log(f"  (f) AsyncAIDESearch, 2 rounds of 4, {search_s:.2f} s: best "
        f"{node.spec.preproc + '+' + node.spec.model if node else None} "
        f"rmse {node.score if node else None}")
    out["search"] = {"best": None if node is None else node.score,
                     "wall_s": search_s, "rounds": len(search.reports)}
    if not ok:
        problems.append(f"search best {node}")


def profile_tabular(torch, np, report):
    """One cold run of the tabular batch (a new client: no cache) under
    torch.profiler: the device's busy share, the top device ops, and the
    share of the GBT's histogram kernels (the segment sum's index_add_ and
    the counts' bincount)."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.tabular as T
    from repro_torch.data import tabular as data

    batch, _, _ = tabular_batch(T, data, TABULAR_ROWS)
    client = tabular_client()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.run_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, busy, nk = _kernel_table(prof, 1)
    hist = sum(us for name, _, us in rows
               if any(k in name for k in HISTOGRAM_KERNELS))
    lines = _profile_lines(f"tabular batch, {TABULAR_ROWS} rows, cold",
                           wall, busy, nk, rows, report)
    lines.append(f"    GBT histogram kernels ({', '.join(HISTOGRAM_KERNELS)}"
                 f"): {hist / 1e3:.3f} ms, {hist / busy:.3f} of device time")
    report["profile"]["tabular_histogram_share"] = hist / busy
    return lines


def profile_agentic(torch, np, report):
    """The quickstart batch at the client's defaults under torch.profiler:
    a session whose compiled programs are warm (it shares the plan cache of
    a client that ran the batch once) and whose intermediate cache is
    cold: the device's busy share, the top device ops, and the share of
    inductor's Triton kernels (the compiled segments' fused code)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.tabular as T
    from repro_torch.client import LocalTarget, StratumConfig
    from repro_torch.core import Stratum
    from repro_torch.data import tabular as data

    batch, _, _ = tabular_batch(T, data, AGENTIC_ROWS)
    cache_dir = tempfile.mkdtemp(prefix="inductor-")
    try:
        warm = agentic_client(cache_dir)
        warm.run_batch(batch)
        cfg = StratumConfig.make(memory_budget_bytes=AGENTIC_BUDGET,
                                 hardware_threads=AGENTIC_THREADS,
                                 jit_cache_dir=cache_dir)
        client = LocalTarget(cfg, stratum=Stratum(
            **cfg.stratum_kwargs(), plan_cache=warm.stratum.plan_cache))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            client.run_batch(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    rows, busy, nk = _kernel_table(prof, 1)
    fused = sum(us for name, _, us in rows if name.startswith("triton_"))
    lines = _profile_lines(f"agentic quickstart, {AGENTIC_ROWS} rows, "
                           f"compiled segments warm, cache cold", wall,
                           busy, nk, rows, report)
    lines.append(f"    inductor's Triton kernels (the compiled segments): "
                 f"{fused / 1e3:.3f} ms, {fused / busy:.3f} of device time")
    report["profile"]["agentic_fused_share"] = fused / busy
    return lines


# the kernels of the GBT's per-level histogram: index_add_ of the fixed-point
# gradients and bincount of the counts
HISTOGRAM_KERNELS = ("indexFunc", "index_add", "Histogram", "histogram")


def _kernel_table(prof, n_calls: int):
    """(rows sorted by device time, device µs per call) from a profile:
    rows of (name, launches per call, device µs per call)."""
    rows = []
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = evt.self_cuda_time_total
        # host-side ranges (aten ops, autograd Functions such as
        # _FusedCrossEntropy, the profiler's own buffer requests) carry the
        # device time of kernels launched inside them: not kernels
        on_host = str(getattr(evt, "device_type", "CUDA")).endswith("CPU")
        if dev <= 0 or on_host or evt.key.startswith(("aten::", "cuda")) or \
                evt.key in ("Command Buffer Full", "Activity Buffer Request"):
            continue
        rows.append((evt.key, evt.count / n_calls, dev / n_calls))
    rows.sort(key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows), sum(r[1] for r in rows)


OURS = ("_rms_row", "flash_fwd_kernel", "decode_split_kernel",
        "decode_merge_kernel", "rms_bwd_ring_kernel", "rms_bwd_rows_kernel",
        "rms_dw_sum_kernel", "delta_kernel",
        "dkdv_kernel", "dq_kernel", "ce_tile_kernel", "ce_merge_kernel",
        "ssd_scan_kernel", "ssd_scan_wide_kernel", "ssd_wide_prep_kernel",
        "moe_gmm_kernel",
        "moe_gmm_decode_kernel")


# kernel families by name, for the breakdown of a profile
FAMILIES = (
    ("fp32 GEMMs (the CE backward's products; the MoE router)",
     ("f32f32", "sgemm")),
    ("bf16 GEMMs (cuBLAS)", ("nvjet", "splitKreduce")),
    ("ported kernels", OURS),
    ("elementwise, copies and the rest", ("",)),
)


def _families(rows):
    out = {}
    for name, cnt, us in rows:
        fam = next(f for f, keys in FAMILIES if any(k in name for k in keys))
        n, t = out.get(fam, (0.0, 0.0))
        out[fam] = (n + cnt, t + us)
    return out


def _profile_lines(label, wall, busy, nk, rows, report):
    lines = [f"{label}: wall {wall * 1e3:.3f} ms, device busy "
             f"{busy / 1e3:.3f} ms, idle share {1 - busy / 1e6 / wall:.3f}, "
             f"{nk:.0f} kernel launches"]
    fams = _families(rows)
    for fam, (cnt, us) in fams.items():
        lines.append(f"    {fam}: {us / 1e3:.3f} ms ({us / busy:.3f} of "
                     f"device time), {cnt:.0f} launches")
    for name, cnt, us in rows[:15]:
        lines.append(f"    {us:10.1f} us {cnt:7.1f}x  {name[:90]}")
    for name, cnt, us in rows:
        if any(k in name for k in OURS):
            lines.append(f"    ported kernel {name[:48]}: {cnt:.0f} "
                         f"launches, {us / cnt:.2f} us each")
    report.setdefault("profile", {})[label] = {
        "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
        "kernel_launches": nk, "families_us": {f: t for f, (_, t) in
                                               fams.items()},
        "kernels": rows}
    return lines


def profile_train_step(torch, report):
    """One train step at the train phase's configuration under
    torch.profiler, after one warm step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.lm import DataConfig, global_batch_at
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = train_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    step = make_train_step(cfg, adamw(lr=TRAIN_LR))
    opt_state = step.init_opt_state(params)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, microbatches=TRAIN_MB)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in global_batch_at(data, 0).items()}
    params, opt_state, m = step(params, opt_state, batch)      # warm
    m["loss"].item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        m["loss"].item()
        wall = time.perf_counter() - t0
    rows, busy, nk = _kernel_table(prof, 1)
    del params, opt_state, batch, step
    torch.cuda.empty_cache()
    return _profile_lines(f"train step ({cfg.n_layers} layers, "
                          f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens)", wall, busy,
                          nk, rows, report)


def profile_serving(torch, np, report, arch, layers=None):
    """One prefill wave (B=8, S=1024) and 8 decode steps at full width (at
    ``layers`` layers where given) under torch.profiler, after a warm wave
    and 3 warm steps; for qwen2-7b also the host cost of one call of a few
    kinds.  The families fed embeddings (vlm, audio) take seeded N(0, 1)
    ones, a (8, 1, D) embedding at each step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serve.step import make_decode_step

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    lines = []
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        rng = np.random.default_rng(0)
        key = "tokens" if cfg.frontend == "none" else "embeds"
        if key == "tokens":
            toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                 (8, 1024))).cuda()
        else:
            toks, step_in = (torch.from_numpy(rng.standard_normal(
                (8, s, cfg.d_model), dtype=np.float32)).cuda()
                for s in (1024, 1))
        decode = make_decode_step(cfg)
        prefill(params, {key: toks}, cfg, max_len=2048)        # warm
        torch.cuda.synchronize()
        if arch == SSM_ARCH:          # before the profiler, which slows
            lines.append(slstm_share(torch, params, toks, cfg, report))
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, state = prefill(params, {key: toks}, cfg,
                                    max_len=2048)
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t0
        rows_p, busy_p, nk_p = _kernel_table(prof, 1)

        def step(nxt, state):
            out, _, state = decode(params, state,
                                   nxt if key == "tokens" else step_in)
            return out, state

        for _ in range(3):                                     # warm
            nxt, state = step(nxt, state)
        torch.cuda.synchronize()
        n = 8
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                nxt, state = step(nxt, state)
                nxt.cpu()                                      # as serving
            wall_d = (time.perf_counter() - t0) / n
        rows_d, busy_d, nk_d = _kernel_table(prof, n)
        host = {}
        if arch == ARCH:
            # host cost of one call (enqueue only), at the decode shapes
            from repro_torch.kernels import decode_attention, rmsnorm
            xd = torch.randn(8, 1, cfg.d_model, device="cuda",
                             dtype=torch.bfloat16)
            wn = params["final_norm"]["w"]
            kc, vc = state["kv"]["k"][0], state["kv"]["v"][0]
            qd = torch.randn(8, 28, 128, device="cuda", dtype=torch.bfloat16)
            lens = state["len"].clamp(max=2047) + 1
            wq = params["layers"]["attn"]["wq"][0]
            for label, fn in (("rmsnorm (Triton)", lambda: rmsnorm(xd, wn)),
                              ("decode_attention (ctypes)",
                               lambda: decode_attention(qd, kc, vc, lens)),
                              ("x @ wq (cuBLAS)", lambda: xd @ wq),
                              ("x + x (elementwise)", lambda: xd + xd)):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                host[label] = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
    del params, state
    torch.cuda.empty_cache()
    if host:
        lines.append("host cost per call (enqueue, us): " + ", ".join(
            f"{k} {v:.1f}" for k, v in host.items()))
        report.setdefault("profile", {})["host_us_per_call"] = host
    name = arch if layers is None else f"{arch} ({layers} layers)"
    for label, wall, busy, nk, rows in (
            (f"{name} prefill B=8 S=1024", wall_p, busy_p, nk_p, rows_p),
            (f"{name} decode step B=8 len~1030", wall_d, busy_d, nk_d,
             rows_d)):
        lines += _profile_lines(label, wall, busy, nk, rows, report)
    return lines


def slstm_share(torch, params, toks, cfg, report) -> str:
    """The sLSTM blocks' share of one prefill wave, outside the profiler:
    each sLSTM block is bracketed by synchronisations and timed on the
    host clock (its loop of 1024 steps is host-bound), against the wave's
    own wall time."""
    import repro_torch.models.model as model_mod

    spent = []
    inner = model_mod.slstm_block

    def timed_block(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    model_mod.slstm_block = timed_block
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_mod.prefill(params, {"tokens": toks}, cfg, max_len=2048)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        model_mod.slstm_block = inner
    share = sum(spent) / wall
    report.setdefault("profile", {})["slstm_prefill"] = {
        "wall_ms": wall * 1e3, "slstm_ms": [t * 1e3 for t in spent],
        "share": share}
    return (f"{cfg.name} prefill B=8 S=1024 (synchronised at each sLSTM "
            f"block): wall {wall * 1e3:.3f} ms, {len(spent)} sLSTM blocks "
            f"{sum(spent) * 1e3:.3f} ms (each "
            f"{[round(t * 1e3, 3) for t in spent]}), share {share:.3f}")


def profile_phase(torch, np, report, phases):
    lines = []
    if "train" in phases:
        lines += profile_train_step(torch, report)
    if "serve" in phases:
        lines += profile_serving(torch, np, report, ARCH)
    if "serve_hybrid" in phases:
        lines += profile_serving(torch, np, report, HYBRID_ARCH)
    if "serve_moe" in phases:
        lines += profile_serving(torch, np, report, MOE_ARCH)
    if "serve_ssm" in phases:
        lines += profile_serving(torch, np, report, SSM_ARCH)
    if "serve_starcoder2" in phases:
        lines += profile_serving(torch, np, report, STARCODER_ARCH)
    if "serve_nemotron" in phases:
        lines += profile_serving(torch, np, report, NEMOTRON_ARCH,
                                 NEMOTRON_LAYERS)
    if "serve_audio" in phases:
        lines += profile_serving(torch, np, report, AUDIO_ARCH)
    if "serve_vlm" in phases:
        lines += profile_serving(torch, np, report, VLM_ARCH, VLM_LAYERS)
    if "tabular" in phases:
        lines += profile_tabular(torch, np, report)
    if "agentic" in phases:
        lines += profile_agentic(torch, np, report)
    for line in lines:
        log("  " + line)
    with open(OUT / "profile.txt", "w") as f:
        f.write("\n".join(lines) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one prefill and a few decode steps "
                    "of each served model, and a train step, at full width "
                    "(torch.profiler) after the phases")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port is not beside this script ({SRC / 'repro_torch'})")
    sys.path.insert(0, str(SRC))
    OUT.mkdir(exist_ok=True)
    report: dict = {"phases": phases}
    t_start = time.perf_counter()

    # ---- 1: device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi failed: {smi.stderr.strip()}"
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()
    log(f"[device] {card}; sm clock, max sm clock, power draw, temperature: "
        f"{clocks}")
    report["clocks_at_start"] = clocks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; python {sys.version.split()[0]}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    report["card"] = card
    report["torch"] = torch.__version__

    # ---- 2: build --------------------------------------------------------
    if set(phases) - {"device"}:
        from repro_torch.kernels.common import build_library, library
        from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
        t0 = time.perf_counter()
        nvcc_out = io.StringIO()
        with contextlib.redirect_stdout(nvcc_out):
            lib_path = build_library(verbose=True)
        library()
        report["build_s"] = time.perf_counter() - t0
        (OUT / "ptxas.txt").write_text(nvcc_out.getvalue())
        report["ptxas"] = ptxas_summary(nvcc_out.getvalue())
        for kernel, usage in report["ptxas"].items():
            log(f"[build] ptxas {kernel}: {usage}")
        t0 = time.perf_counter()
        one = torch.ones(1, 3584, device="cuda", dtype=torch.bfloat16)
        rmsnorm_triton(one, torch.ones(3584, device="cuda"))  # Triton compiles
        torch.cuda.synchronize()
        report["triton_compile_s"] = time.perf_counter() - t0
        log(f"[build] nvcc: {lib_path.relative_to(ROOT)} in "
            f"{report['build_s']:.1f} s; Triton rmsnorm forward (the only "
            f"Triton kernel) compiled in {report['triton_compile_s']:.1f} s")

    phase_s = report["phase_s"] = {}

    phase_peak = report["phase_peak_bytes"] = {}

    def timed(name, fn, *fn_args):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*fn_args)
        phase_s[name] = time.perf_counter() - t0
        phase_peak[name] = torch.cuda.max_memory_allocated()
        log(f"  ({name}: {phase_s[name]:.1f} s, peak memory "
            f"{phase_peak[name] / 2**30:.2f} GiB)")
        return out

    rows = []
    if "kernels" in phases:
        log("[kernels] kernel vs plain version on the card (bf16)")
        rows = timed("kernels", kernel_phase, torch, Timer(torch), report)
    if "consistency" in phases:
        log("[consistency] full-width qwen2-7b, B=2")
        timed("consistency", consistency_phase, torch, np, report)
    by_path = {}
    if "serve" in phases:
        log("[serve] serve_demo qwen2-7b full width")
        by_path["serve"] = timed("serve", serve_phase, torch, report)
    if "consistency_hybrid" in phases:
        log(f"[consistency_hybrid] full-width {HYBRID_ARCH}, B=2")
        timed("consistency_hybrid", consistency_phase, torch, np, report,
              HYBRID_ARCH)
        # random-init zamba2 is chaotic at 38 layers (the half-ulp floor is
        # ~0.85), which leaves that check little room; at 8 layers (one
        # group of 6, the shared block, a tail of 2) it is not
        log(f"  the same at 8 layers (one group, the shared block, the "
            f"tail):")
        timed("consistency_hybrid 8 layers", consistency_phase, torch, np,
              report, HYBRID_ARCH, 8)
    if "serve_hybrid" in phases:
        log(f"[serve_hybrid] serve_demo {HYBRID_ARCH} full width")
        by_path["serve_hybrid"] = timed("serve_hybrid", serve_phase, torch,
                                        report, HYBRID_ARCH, HYBRID_EXPECTED)
    if "consistency_moe" in phases:
        log(f"[consistency_moe] {MOE_ARCH}: one MoE FFN call, card "
            f"against CPU")
        timed("moe_ffn", moe_ffn_check, torch, report)
        log(f"  full-width {MOE_ARCH}, B=1")
        timed("consistency_moe", consistency_moe_phase, torch, np, report)
    if "serve_moe" in phases:
        log(f"[serve_moe] serve_demo {MOE_ARCH} full width")
        by_path["serve_moe"] = timed("serve_moe", serve_phase, torch, report,
                                     MOE_ARCH, MOE_EXPECTED)
    if "consistency_ssm" in phases:
        log(f"[consistency_ssm] full-width {SSM_ARCH}, B=2")
        timed("consistency_ssm", consistency_phase, torch, np, report,
              SSM_ARCH)
        log("  the same at 8 layers (one segment: 7 mLSTM blocks, 1 sLSTM):")
        timed("consistency_ssm 8 layers", consistency_phase, torch, np,
              report, SSM_ARCH, 8)
    if "serve_ssm" in phases:
        log(f"[serve_ssm] serve_demo {SSM_ARCH} full width")
        by_path["serve_ssm"] = timed("serve_ssm", serve_phase, torch, report,
                                     SSM_ARCH, SSM_EXPECTED)
    if "consistency_starcoder2" in phases:
        log(f"[consistency_starcoder2] full-width {STARCODER_ARCH}, B=2")
        timed("consistency_starcoder2", consistency_phase, torch, np, report,
              STARCODER_ARCH)
    if "serve_starcoder2" in phases:
        log(f"[serve_starcoder2] serve_demo {STARCODER_ARCH} full width")
        by_path["serve_starcoder2"] = timed(
            "serve_starcoder2", serve_phase, torch, report, STARCODER_ARCH,
            STARCODER_EXPECTED)
    if "consistency_nemotron" in phases:
        log(f"[consistency_nemotron] {NEMOTRON_ARCH} full width, "
            f"{NEMOTRON_LAYERS} layers, B=2")
        timed("consistency_nemotron", consistency_phase, torch, np, report,
              NEMOTRON_ARCH, NEMOTRON_LAYERS)
    if "serve_nemotron" in phases:
        log(f"[serve_nemotron] serve_requests {NEMOTRON_ARCH} full width, "
            f"{NEMOTRON_LAYERS} layers")
        by_path["serve_nemotron"] = timed(
            "serve_nemotron", serve_phase, torch, report, NEMOTRON_ARCH,
            NEMOTRON_EXPECTED, NEMOTRON_LAYERS)
    if "consistency_llama3" in phases:
        log(f"[consistency_llama3] {LLAMA_ARCH} full width, {LLAMA_LAYERS} "
            f"layers, B=2")
        timed("consistency_llama3", consistency_phase, torch, np, report,
              LLAMA_ARCH, LLAMA_LAYERS)
    if "train" in phases:
        log("[train] make_train_step qwen2-7b full width, 4 layers")
        by_path["train"] = timed("train", train_phase, torch, np, report)
    if "consistency_audio" in phases:
        log(f"[consistency_audio] full-width {AUDIO_ARCH}, B=2, embeddings")
        timed("consistency_audio", consistency_phase, torch, np, report,
              AUDIO_ARCH)
    if "serve_audio" in phases:
        log(f"[serve_audio] make_prefill_step / make_decode_step "
            f"{AUDIO_ARCH} full width, embeddings")
        by_path["serve_audio"] = timed("serve_audio", serve_phase, torch,
                                       report, AUDIO_ARCH, AUDIO_EXPECTED)
    if "consistency_vlm" in phases:
        log(f"[consistency_vlm] {VLM_ARCH} full width, {VLM_LAYERS} layers, "
            f"B=2, embeddings")
        timed("consistency_vlm", consistency_phase, torch, np, report,
              VLM_ARCH, VLM_LAYERS)
    if "serve_vlm" in phases:
        log(f"[serve_vlm] make_prefill_step / make_decode_step {VLM_ARCH} "
            f"full width, {VLM_LAYERS} layers, embeddings")
        by_path["serve_vlm"] = timed("serve_vlm", serve_phase, torch, report,
                                     VLM_ARCH, VLM_EXPECTED, VLM_LAYERS)
    if "tabular" in phases:
        log(f"[tabular] examples/quickstart.py's batch through "
            f"connect(\"local\"), {TABULAR_ROWS} rows, on the card")
        by_path["tabular"] = timed("tabular", tabular_phase, torch, np,
                                   report)
    if "agentic" in phases:
        log(f"[agentic] the paper's pipeline search through "
            f"connect(\"local\") at the client's defaults (compiled "
            f"segments), {AGENTIC_ROWS} rows, on the card")
        by_path["agentic"] = timed("agentic", agentic_phase, torch, np,
                                   report)
    if args.profile:
        log("[profile] full width, torch.profiler")
        profile_phase(torch, np, report, phases)

    for r in rows:
        # registers and spills of the row's kernels (ptxas -v of the build)
        r["ptxas"] = {k: v for k, v in report.get("ptxas", {}).items()
                      if k.split()[0] == Path(r["source"]).name}
        r["launches_by_path"] = {p: c.get(r["name"], 0)
                                 for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if phases == list(PHASES) and r["launches"] == 0:
            fail(f"{r['name']} was launched no time on the paths driven")
    report["kernels"] = rows
    report["seconds"] = time.perf_counter() - t_start
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['seconds']:.1f} s")
    log(card)
    if phases != list(PHASES):
        log("partial run: no result line")
        return
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path", "ptxas")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
