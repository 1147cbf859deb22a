#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase (one card)
    python3 chip_smoke.py --phases device,build,kernels

Phases, each of which must pass:

1. device  — name and power limit (nvidia-smi); TF32 off for fp32 products.
2. build   — nvcc builds ``src/repro_torch/csrc/*.cu`` (one process a
             source, in parallel); Triton compiles the rmsnorm kernel at a
             first launch.  Both are timed.
3. kernels — each kernel against its plain PyTorch version on the card, bf16,
             at the serving path's shapes and at ragged ones, under the
             tolerance of ``repro_torch.kernels.common.TOLERANCES``; times of
             kernel, plain version and one library call (a yardstick the port
             never calls) at the path's shapes, and each one's bound.
4. consistency — full-width qwen2-7b, random weights from a seed: prefill
             1000 tokens + decode token 1000 against forward over 1001.
5. serve   — ``serve_demo("qwen2-7b", use_reduced=False, ...)``: 16 requests
             in two waves of 8 lanes, 1024-token prompts, 64 new tokens;
             the launch counts of every kernel must match the path exactly.

It imports torch and the port, never jax or the JAX package.  Without a CUDA
device, or without the port beside it, it exits non-zero before printing a
result.  The last line is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels; details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"
ARCH = "qwen2-7b"
PHASES = ("device", "build", "kernels", "consistency", "serve")

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
    it cold) and the stream is held busy by a ~0.5 ms sleep kernel, so the
    host's launch cost (Python, Triton's launcher, ctypes) is enqueued
    behind it and not counted: the events bracket the device work."""

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
            torch.cuda._sleep(1_000_000)          # ~0.5 ms at 1.98 GHz
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, timer, report):
    import torch.nn.functional as F

    from repro_torch.kernels.common import TOLERANCES, max_abs_err, within
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
        log(f"  {name:17s} {case:44s} max_abs_err={err:.3e} (tolerance "
            f"{atol:g} + {rtol:.4g}*|ref|) {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            fail(f"{name} {case} disagrees with its plain version "
                 f"(max abs err {err})")
        return err

    rows = []
    eps = 1e-5

    # ---- rmsnorm ---------------------------------------------------------
    errs = []
    for shape, dtype in (((8192, 3584), bf16), ((8, 3584), bf16),
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
            (2, 14, 2, 1, 128, True, 0)):         # one token
        q, k, v = bshd(B, S, Hq, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
        case = (f"B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} "
                f"{'causal' if causal else 'full'} w{window}")
        errs.append(check("flash_attention", case,
                          flash_attention(q, k, v, causal=causal,
                                          window=window),
                          attention_ref(q, k, v, causal=causal,
                                        window=window)))
    B, Hq, Hkv, S, D = 8, 28, 4, 1024, 128
    q, k, v = bshd(B, S, Hq, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
    pairs = S * (S + 1) // 2                      # causal (q, k) pairs
    b_ms, b_by = bound(B * S * D * 2 * (2 * Hq + 2 * Hkv),
                       4 * B * Hq * D * pairs, PEAK_BF16)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:103",
        "max_abs_err": max(errs),
        "ms": timer.ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": timer.ms(lambda: attention_ref(q, k, v, causal=True),
                             iters=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))})

    # ---- decode attention ------------------------------------------------
    errs = []
    lens_path = torch.randint(1025, 1089, (8,), generator=gen,
                              device="cuda", dtype=torch.int32)
    for (B, S, lens, lse) in (
            (8, 2048, lens_path, False),           # the decode path's shape
            (8, 1000, [1, 1000, 127, 128, 129, 999, 500, 2], False),
            (8, 2048, [1, 2048, 2047, 64, 1025, 1088, 129, 1], True)):
        lengths = (lens if torch.is_tensor(lens) else
                   torch.tensor(lens, dtype=torch.int32, device="cuda"))
        q = randn(B, 1, 28, 128)[:, 0]
        k, v = randn(B, S, 4, 128), randn(B, S, 4, 128)
        case = f"B{B} S{S} lengths {lengths.min().item()}-" \
               f"{lengths.max().item()}{' lse' if lse else ''}"
        got = decode_attention(q, k, v, lengths, return_lse=lse)
        want = decode_attention_ref(q, k, v, lengths, return_lse=lse)
        if lse:
            errs.append(check("decode_attention", case, got[0], want[0]))
            for name, g, w_ in (("m", got[1], want[1]), ("l", got[2],
                                                         want[2])):
                rel = float(((g - w_).abs() / w_.abs().clamp_min(1e-6))
                            .max())
                log(f"    {name}: max rel err {rel:.3e}")
                if rel > 1e-4:
                    fail(f"decode_attention {name} disagrees (rel {rel})")
        else:
            errs.append(check("decode_attention", case, got, want))
    B, S, Hq, Hkv, D = 8, 2048, 28, 4, 128
    q = randn(B, 1, Hq, D)[:, 0]
    k, v = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    lengths = lens_path
    n_keys = int(lengths.sum())
    b_ms, b_by = bound(n_keys * Hkv * D * 2 * 2 + 2 * B * Hq * D * 2 + 4 * B,
                       4 * n_keys * Hq * D, PEAK_FP32)
    mask = (torch.arange(S, device="cuda")[None, :] <
            lengths[:, None])[:, None, None, :]          # (B, 1, 1, S)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:82",
        "max_abs_err": max(errs),
        "ms": timer.ms(lambda: decode_attention(q, k, v, lengths)),
        "plain_ms": timer.ms(lambda: decode_attention_ref(q, k, v, lengths)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))})
    for r in rows:
        log(f"  {r['name']:17s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 4: decode against forward at full width
# ---------------------------------------------------------------------------


def consistency_phase(torch, np, report):
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    cfg = get_config(ARCH)
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        rng = np.random.default_rng(1)
        B, S = 2, 1000
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int64)).cuda()
        hidden, _ = forward(params, {"tokens": toks}, cfg)
        full = (hidden[:, -1] @ params["lm_head"]).float()
        del hidden
        _, state = prefill(params, {"tokens": toks[:, :S]}, cfg,
                           max_len=1024)
        dec, _ = decode_step(params, state, toks[:, S:S + 1], cfg)
        rel = float((dec - full).norm() / full.norm())
        same = bool((dec.argmax(-1) == full.argmax(-1)).all())
        top2 = full.topk(2, dim=-1).values
        margin = float((top2[:, 0] - top2[:, 1]).min())
        # the bf16 noise floor for comparison: the same forward with the
        # embedding table perturbed by about half an ulp (one rounding at
        # the input instead of the two paths' roundings in every layer)
        tok = params["embed"]["tok"]
        noise = torch.randn(tok.shape, generator=torch.Generator(
            device="cuda").manual_seed(2), device="cuda")
        params["embed"]["tok"] = (tok.float() * (1 + 2 ** -9 * noise)).to(
            tok.dtype)
        del noise
        hidden, _ = forward(params, {"tokens": toks}, cfg)
        pert = (hidden[:, -1] @ params["lm_head"]).float()
        floor = float((pert - full).norm() / full.norm())
    log(f"  prefill {S} + decode 1 vs forward {S + 1}: rel L2 {rel:.4e} "
        f"(limit 2e-2), argmax equal {same} (top-2 margin {margin:.4f})")
    log(f"  forward vs forward with input embeddings perturbed by ~1/2 ulp:"
        f" rel L2 {floor:.4e}")
    report["consistency"] = {"rel_l2": rel, "argmax_equal": same,
                             "top2_margin": margin,
                             "half_ulp_input_rel_l2": floor}
    del params, state, hidden
    torch.cuda.empty_cache()
    if not (rel <= 2e-2 and same):
        fail("decode disagrees with forward at full width")


# ---------------------------------------------------------------------------
# phase 5: serving, full width
# ---------------------------------------------------------------------------

EXPECTED = {"rmsnorm": 57 * (2 + 128), "flash_attention": 28 * 2,
            "decode_attention": 28 * 128}


def serve_phase(torch, report):
    from repro_torch.kernels.common import launches, reset_launches
    from repro_torch.launch.serve import serve_demo

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve_demo(ARCH, use_reduced=False, n_requests=16, n_lanes=8,
                     prompt_len=1024, max_new=64, max_len=2048,
                     device="cuda")
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    steps = out["decode_steps"]
    log(f"  requests {out['requests']}  tokens {out['tokens']}  decode "
        f"steps {steps}")
    log(f"  prefill ms per wave {[round(s * 1e3, 3) for s in out['prefill_s']]}"
        f"  decode ms per step {out['decode_s'] / max(steps, 1) * 1e3:.3f}  "
        f"tok/s {out['tok_per_s']:.1f}  wall {out['wall_s']:.3f} s")
    log(f"  peak memory {peak / 2**30:.2f} GiB  launches {counts}")
    report["serve"] = {**out, "peak_bytes": peak, "launches": counts}
    if out["requests"] != 16 or out["tokens"] != 1024 or steps != 128:
        fail(f"served {out['requests']} requests / {out['tokens']} tokens / "
             f"{steps} steps; expected 16 / 1024 / 128")
    if counts != EXPECTED:
        fail(f"launch counts {counts}, expected {EXPECTED}")
    return counts


# ---------------------------------------------------------------------------
# optional: where the serving time goes (torch.profiler)
# ---------------------------------------------------------------------------


def _kernel_table(prof, n_calls: int):
    """(rows sorted by device time, device µs per call) from a profile:
    rows of (name, launches per call, device µs per call)."""
    rows = []
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = evt.self_cuda_time_total
        if dev <= 0 or evt.key.startswith(("aten::", "cuda")) or \
                evt.key == "Command Buffer Full":       # not a kernel
            continue
        rows.append((evt.key, evt.count / n_calls, dev / n_calls))
    rows.sort(key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows), sum(r[1] for r in rows)


OURS = ("_rms_row", "flash_fwd_kernel", "decode_split_kernel",
        "decode_merge_kernel")


def profile_phase(torch, np, report):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.serve.step import make_decode_step

    cfg = get_config(ARCH)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    lines = []
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1024))).cuda()
        decode = make_decode_step(cfg)
        prefill(params, {"tokens": toks}, cfg, max_len=2048)   # warm
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, state = prefill(params, {"tokens": toks}, cfg,
                                    max_len=2048)
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t0
        rows_p, busy_p, nk_p = _kernel_table(prof, 1)
        for _ in range(3):                                     # warm
            nxt, _, state = decode(params, state, nxt)
        torch.cuda.synchronize()
        n = 8
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                nxt, _, state = decode(params, state, nxt)
                nxt.cpu()                                      # as serving
            wall_d = (time.perf_counter() - t0) / n
        rows_d, busy_d, nk_d = _kernel_table(prof, n)
        # host cost of one call (enqueue only), at the decode shapes
        from repro_torch.kernels import decode_attention, rmsnorm
        xd = torch.randn(8, 1, cfg.d_model, device="cuda",
                         dtype=torch.bfloat16)
        wn = params["final_norm"]["w"]
        kc, vc = state["kv"]["k"][0], state["kv"]["v"][0]
        qd = torch.randn(8, 28, 128, device="cuda", dtype=torch.bfloat16)
        lens = state["len"].clamp(max=2047) + 1
        wq = params["layers"]["attn"]["wq"][0]
        host = {}
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
    lines.append("host cost per call (enqueue, us): " + ", ".join(
        f"{k} {v:.1f}" for k, v in host.items()))
    report.setdefault("profile", {})["host_us_per_call"] = host
    for label, wall, busy, nk, rows in (
            ("prefill B=8 S=1024", wall_p, busy_p, nk_p, rows_p),
            ("decode step B=8 len~1030", wall_d, busy_d, nk_d, rows_d)):
        lines.append(f"{label}: wall {wall * 1e3:.3f} ms, device busy "
                     f"{busy / 1e3:.3f} ms, idle share "
                     f"{1 - busy / 1e6 / wall:.3f}, {nk:.0f} kernel "
                     "launches")
        for name, cnt, us in rows[:15]:
            lines.append(f"    {us:10.1f} us {cnt:7.1f}x  {name[:90]}")
        for name, cnt, us in rows:
            if any(k in name for k in OURS):
                lines.append(f"    ported kernel {name[:48]}: {cnt:.0f} "
                             f"launches, {us / cnt:.2f} us each")
        report.setdefault("profile", {})[label] = {
            "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "kernel_launches": nk, "kernels": rows}
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
                    "at full width (torch.profiler) after the phases")
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
    if "build" in phases or "kernels" in phases or "serve" in phases:
        from repro_torch.kernels.common import build_library, library
        from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
        t0 = time.perf_counter()
        lib_path = build_library(verbose=True)
        library()
        report["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rmsnorm_triton(torch.ones(1, 3584, device="cuda",
                                  dtype=torch.bfloat16),
                       torch.ones(3584, device="cuda"))   # Triton compiles
        torch.cuda.synchronize()
        report["triton_compile_s"] = time.perf_counter() - t0
        log(f"[build] nvcc: {lib_path.relative_to(ROOT)} in "
            f"{report['build_s']:.1f} s; Triton rmsnorm compiled in "
            f"{report['triton_compile_s']:.1f} s")

    rows = []
    if "kernels" in phases:
        log("[kernels] kernel vs plain version on the card (bf16)")
        rows = kernel_phase(torch, Timer(torch), report)
    if "consistency" in phases:
        log("[consistency] full-width qwen2-7b, B=2")
        consistency_phase(torch, np, report)
    counts = {}
    if "serve" in phases:
        log("[serve] serve_demo qwen2-7b full width")
        counts = serve_phase(torch, report)
    if args.profile:
        log("[profile] full-width qwen2-7b, torch.profiler")
        profile_phase(torch, np, report)

    for r in rows:
        r["launches"] = counts.get(r["name"], 0)
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
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
