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
12b. train_moe — granite-moe-3b-a800m at its published width and depth
             (32 layers: 3.98 B parameters, 63.7 GB of training state at
             16 B a parameter; the depth is cut, and the cut logged, only
             where state and room exceed the card), through
             ``init_params``, ``adamw`` and ``make_train_step`` with remat:
             the train phase's batch (2 microbatches of 4 x 2048 tokens) 4
             times at a constant lr; the loss must fall at every step and
             each kernel's launches match the path exactly (the grouped
             matmul and its backward, the flash backward at head dim 64).
             It reports the step time, tokens/s, peak memory and the share
             of a training microbatch's assignments dropped.  Then, at 2
             layers with every expert chosen (no assignment dropped), the
             card's loss and each gradient leaf against the CPU's fp32 run
             on the same parameters, within twice the CPU's own bf16 run's
             distance from it.
12c. train_hybrid — zamba2-1.2b at its published width and depth (38
             Mamba2 layers in 6 groups of 6, the shared attention+MLP block
             after each group, a tail of 2: 1.17 B parameters, 18.7 GB of
             training state), through ``init_params``, ``adamw`` and
             ``make_train_step`` with the layer-granular remat: the train
             phase's batch 4 times at a constant lr; the loss must fall at
             every step and each kernel's launches match the path exactly
             (the SSD scan and its backward kernel at N = P = 64, the flash
             backward at head dim 64, group 1).  It reports the step time,
             tokens/s and peak memory.  Then, at 7 layers (one group, the
             shared block once, a tail of 1), the card's loss and each
             gradient leaf against the CPU's fp32 run, within twice the
             CPU's own bf16 run's distance from it.
12d. train_ssm — xlstm-1.3b at its published width and depth (48 blocks:
             6 segments of 7 mLSTM blocks on the wide SSD scan, N 512 and P
             513, and one sLSTM block; 1.415 B parameters, 22.6 GB of
             training state), through ``init_params``, ``adamw`` and
             ``make_train_step`` with the remat of each mLSTM block: the
             train phase's batch 4 times at a constant lr; the loss must
             fall at every step and each kernel's launches match the path
             exactly (the wide SSD scan and its backward kernel, 84
             launches a step).  It reports the step time, tokens/s and peak
             memory.  Then, with nothing else running before that, two
             gradient checks, the card's loss and each gradient leaf
             against the CPU's fp32 run, within twice the CPU's own bf16
             run's distance from it (the CPU's runs on threads of their
             own beside the card's): at 8 blocks (one segment), and at 2
             blocks (one segment cut to 1 mLSTM block and its sLSTM
             block), where the bf16 floors are small enough that the check
             must also reject a planted fault in the training path (the
             wide backward's dx without its w∘(B G) term; at 8 blocks the
             same fault is reported, not judged).  ``--profile`` adds one
             segment's profiled step and the sLSTM's share.
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
17. service — the paper's N concurrent agents through the single-process
             service (``repro_torch.service``) at the client's defaults (2
             executors, compiled segments, a fresh ``jit_cache_dir``), on
             the same 1,000,000-row lake, 16 GiB, hardware_threads=8: (a)
             iteration 1 split by model over four tenants, queued before
             ``start()``: one super-batch, each job coalesced with 3 and
             sharing 45 ops, 135 executions deduped, per-tier counts the
             reference's, each tenant's scores its batch's alone on the
             local target within 1e-4; (b) ``examples/agentic_search.py``'s
             service mode (4 agents x 3 rounds of ``AsyncAIDESearch`` on
             threads, ``connect("service")``, traced to a JSONL log): every
             job done, each best its spec's score on the local target,
             work shared across agents, the log replayed to ``completed``,
             the ``top`` view printed; (c) one executor: iteration 1 as a
             SCAVENGER sweep preempted by an INTERACTIVE quickstart probe
             at 20,000 rows, resumed from its salvage with the unpreempted
             scores; (d) a host-side poisoned batch coalesced with an
             innocent one, a ``verify=True`` submission refused by the
             analysis, then one more job.  Uncompilable 0 and no hand
             kernel launches throughout; ``--profile`` adds the idle share
             and device time by family of a warm pass of (b).
18. fabric — the paper's agents across the sharded fabric
             (``repro_torch.service.fabric``) on the same 1,000,000-row
             lake at the client's defaults (compiled segments, a fresh
             ``jit_cache_dir``, hardware_threads=8): (a) ``examples/
             agentic_search.py --target fabric --shards 4``: 4 agents x 3
             rounds of ``AsyncAIDESearch(shard_affinity=True)`` through
             ``connect("fabric")``, 4 in-process shards of 4 GiB each:
             every job done, each agent's jobs on one shard, locality 1.0,
             every result a host numpy array, each best within 1e-4 of its
             spec on the local target, uncompilable 0; then iteration 1
             and (c)'s flood on the same fabric; (b) ``benchmarks/
             e2e_agentic.py``'s cohort workload (16 agents in 4 cohorts, a
             TableVectorizer prefix a cohort and a unique tail a job, one
             executor a shard, per-op dispatch, the cache at 1.3 cohort
             working sets read off a probe run) on 1 shard and on 4: equal
             scores (1e-9 relative), locality 1.0 on 4, both walls and the
             throughput ratio; (c) ``processes=True`` with 2 worker
             processes on the card: iteration 1 within 1e-4 of the
             in-process fabric's, a worker SIGKILLed with an 8-job flood in
             flight (no job lost, every result the unkilled run's, one
             failover), a new worker and the survivor's drain with its warm
             cache hand-off (entries imported, a resubmitted job hits
             them), a graceful stop (every surviving worker exits 0, none
             left alive, the workers' process groups emptied); each
             worker's start-up, compile seconds and largest heartbeat gap,
             and the card's memory.used against the parent's reserved
             memory.  No hand kernel launches.
19. distributed — the LM substrate sharded over 4 ranks sharing the card
             (one ``repro_torch.distributed.spawn`` of 4 processes over
             gloo: NCCL refuses two ranks on one device), bf16, seeded
             weights each rank draws only its shards of, one layer at a
             time; meshes built per part from the one world.  First the
             single-process references in this process.  (a) qwen2-7b at
             full width, cut to 2 layers, on (1, 4), tp on: prefill 8 x
             1024 into a 2048 cache sharded by sequence, then 16 decode
             steps fed the reference's greedy tokens; every call's logits
             within rel L2 2e-2 of one process and the tokens within its
             tie band; rank 3's slice empty (local length 0).  (b) granite-moe-3b-a800m at
             full width and depth on (1, 4), EP (12 local experts a rank):
             the same, within twice the run's own bf16 floor; beside it,
             measured with no verdict (ROADMAP.md C8), the same at 2
             layers: per call, the tokens whose top-k sets differ from one
             process, each side's capacity, and the lanes that route alike
             against the call's limit.  (c) qwen2-7b
             at 2 layers on (2, 2), tp and fsdp, on the train phase's
             batch: 2 steps within a band of ``make_train_step``'s loss and
             grad norm; the params checkpointed on (2, 2) (the files
             written beside the next steps) and restored on (1, 4) with
             equal leaf sums; 4 steps with grad_compress, the loss falling
             at each.  (d) ``vocab_parallel_ce`` at qwen2's
             vocab (T 8192) against the CE kernel's loss and the plain
             backward's dx.  (e) Adafactor under ZeRO: qwen2-7b at 2
             layers on (2, 2), tp and fsdp, 2 steps within (c)'s band of
             ``make_train_step``'s on one process, and rank 0's moments
             within a limit of the single-process ones, which a planted
             control (per-shard means and update RMS) must exceed.  Each
             rank's launches
             of every kernel are exact in every part; the phase reports
             each part's wall, each rank's peak memory and the bytes each
             collective sent.
20. dryrun — the multi-pod dry run, counted on the host beside the
             phases after serve_vlm (started then, so no time that (b)
             reads is taken beside it): (a) ``python -m
             repro_torch.launch.dryrun`` in one subprocess a cell, in two
             lanes, with the card hidden from them, for qwen2-7b,
             granite-moe-3b-a800m and llama3-405b (Adafactor) at train_4k
             and decode_32k, and zamba2-1.2b and xlstm-1.3b at decode_32k,
             on the 16x16 mesh: every record ``ok``, each one's dominant
             term and step time printed; (b) meanwhile, the counting pass
             on fake tensors at the exact shapes of the train phase's step
             and each served model's prefill wave and decode step, its
             roofline on one H100's datasheet peaks (the count's FLOPs,
             ``analytic_memory_bytes`` less the input embedding rows a
             serving step does not gather) against the times those phases
             measured: every ratio of measured time to bound >= 1.  No
             kernel launches: each counting process reads its own.

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
import gc
import io
import json
import os
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
          "train", "train_moe", "train_hybrid", "train_ssm",
          "consistency_audio",
          "serve_audio", "consistency_vlm", "serve_vlm", "tabular",
          "agentic", "service", "fabric", "distributed", "dryrun")

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
    # the wide backward first: its autograd check is the process's first
    # backward on the card
    rows += ssd_bwd_wide_rows(torch, timer, randn, report)
    rows += ssd_bwd_rows(torch, timer, randn, report)
    rows += moe_gmm_rows(torch, timer, randn, check, report)
    rows += moe_gmm_bwd_rows(torch, timer, randn, check)
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


# The SSD backward's cases (B, H, S, gates[, layout], ds_final): the train
# step's shape (B 4, H 64, S 2048, b and c shared by the heads), a ragged S
# with the state carrying and a nonzero ds_final, l falling by > 128 in
# every chunk, per-head b and c at an odd H, one row.  Shared b and c come
# with a head dim of 1, as the Mamba2 block hands them over (the kernel sums
# their gradients over the heads); dy is a (B, H, S, 64) view of a
# (B, S, H, 64) tensor, as autograd hands it back through the block's
# transpose.
SSD_BWD_CASES = ((4, 64, 2048, "path", None, False),
                 (2, 5, 1000, "slow", None, True),
                 (1, 7, 1001, "overflow", None, False),
                 (2, 5, 300, "slow", "per-head", True),
                 (2, 3, 1, "slow", None, True))
SSD_BWD_OUT = ("dc", "db", "dx", "dlog_a", "dgate")
# autograd's gradients of the shared c and b against the step-by-step
# oracle's summed over the heads: this many times the rel L2 that casting
# the oracle's per-head gradients to bf16 and folding them makes alone
SSD_BWD_FOLD_FACTOR = 2.0


def ssd_bwd_case(torch, randn, B, H, S, gates, layout, ds):
    """(inputs, dy, ds_final) of the SSD backward (``ssd_case``'s inputs,
    shared c and b with their head dim of 1)."""
    inputs = ssd_case(torch, randn, B, H, S, gates, layout == "per-head")
    if layout != "per-head":
        inputs = (inputs[0][:, :1], inputs[1][:, :1], *inputs[2:])
    dy = randn(B, S, H, 64).transpose(1, 2)
    return inputs, dy, (randn(B, H, 64, 64, dtype=torch.float32) if ds
                        else None)


def ssd_bwd_limits(name: str, rows: int = 0) -> str:
    """The key of an SSD backward output's limits: dx, dc and db (bf16)
    are held in bf16 ulps, dlog_a, a reverse sum over the rows, has limits
    of its own, and others again at S 1 (``rows``), where it is rounding
    alone."""
    if name in ("dc", "db", "dx"):
        return "ssd_scan_bwd/card_bf16"
    if name == "dlog_a":
        return ("ssd_scan_bwd_dlog_a_s1/card_fp32" if rows == 1
                else "ssd_scan_bwd_dlog_a/card_fp32")
    return "ssd_scan_bwd/card_fp32"


def ssd_bwd_limit_text(name: str, rows: int = 0) -> str:
    from repro_torch.kernels.common import BF16_ULPS, REL_L2
    key = ssd_bwd_limits(name, rows)
    if key in BF16_ULPS:
        return f"one ulp, in at most {BF16_ULPS[key][1]:g}"
    return f"rel_l2 {REL_L2[key]:g}"


def ssd_bwd_check(torch, case, got, want, quiet=False, name="ssd_scan_bwd"):
    """Each of the backward's five outputs against the plain version's
    under its limits; {output: (within the limits, elementwise ok, measure,
    max abs err)}.  dx, dc and db (bf16) against the plain fp32 values
    rounded to bf16 (``BF16_ULPS``): elementwise ok where no element is
    more than one ulp off, the measure the share that is one ulp off.
    dlog_a and dgate (fp32): elementwise under ``TOLERANCES``, the measure
    their rel L2, which divides by ‖want‖ or by the elementwise atol's norm
    over the tensor, whichever is larger: dlog_a's first row is 0 in exact
    arithmetic (S before the first row is 0), so at S 1 the plain version's
    dlog_a is rounding alone, which the atol holds, under limits of its own
    (``ssd_bwd_limits``)."""
    from repro_torch.kernels.common import (BF16_ULPS, REL_L2, TOLERANCES,
                                            bf16_ulps, max_abs_err, within)
    label, out = name, {}
    for name, g, w in zip(SSD_BWD_OUT, got, want):
        key = ssd_bwd_limits(name, want[3].shape[-1])
        if key in BF16_ULPS:
            u = bf16_ulps(g, w, key)
            worst, share = float(u.max()), float((u > 0).float().mean())
            elem = worst <= 1.0
            out[name] = (elem and share <= BF16_ULPS[key][1], elem, share,
                         max_abs_err(g, w))
            detail = (f"max {worst:.3g} ulp, {share:.5f} one ulp off "
                      f"(limit one ulp, in at most {BF16_ULPS[key][1]:g})")
        else:
            scale = max(float(w.norm()),
                        TOLERANCES[key][0] * w.numel() ** 0.5)
            elem, rel = within(g, w, key), float((g - w).norm()) / scale
            out[name] = (elem and rel <= REL_L2[key], elem, rel,
                         max_abs_err(g, w))
            atol, rtol = TOLERANCES[key]
            detail = (f"max_abs_err={out[name][3]:.3e} (tolerance {atol:g} "
                      f"+ {rtol:.4g}*|ref|) rel_l2={rel:.3e} (limit "
                      f"{REL_L2[key]:g})")
        if not quiet:
            verdict = "ok" if out[name][0] else "OUT OF TOLERANCE"
            log(f"  {label:19s} {case + ' ' + name:44s} {detail} "
                f"{verdict}")
    return out


def ssd_bwd_rows(torch, timer, randn, report):
    """The SSD backward kernel against its plain twin
    ``ssd_chunked_bwd_ref`` on the same inputs: dx, dc, db in bf16 ulps,
    dlog_a and dgate elementwise and by rel L2; ``ssd_scan`` under autograd
    launches it once and takes its gradients as they are (c's and b's summed
    over the heads by the kernel, against the step-by-step oracle's folded);
    two calls equal bit for bit; two planted faults; time and bound at the
    train step's shape (the first case), beside the twin's and the oracle's
    time."""
    from repro_torch.kernels.common import launches, rel_l2
    from repro_torch.kernels.ssd.kernel import (broadcast_heads,
                                                ssd_scan_bwd_cuda)
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_bwd_ref, ssd_chunked_bwd_ref

    errs = []
    for B, H, S, gates, layout, ds in SSD_BWD_CASES:
        inputs, dy, ds_final = ssd_bwd_case(torch, randn, B, H, S, gates,
                                            layout, ds)
        case = (f"B{B} H{H} S{S} {gates}{' ' + layout if layout else ''}"
                f"{' ds_final' if ds else ''}")
        got = ssd_scan_bwd_cuda(*inputs, dy, ds_final)
        if not all(torch.isfinite(g).all() for g in got):
            fail(f"ssd_scan_bwd {case}: non-finite output")
        res = ssd_bwd_check(torch, case, got,
                            ssd_chunked_bwd_ref(*inputs, dy, ds_final))
        report.setdefault("rel_l2", {}).update(
            {f"ssd_scan_bwd {case} {k}": v[2] for k, v in res.items()})
        errs += [v[3] for v in res.values()]
        bad = [k for k, v in res.items() if not v[0]]
        if bad:
            fail(f"ssd_scan_bwd {case}: {bad} disagree with the plain "
                 "version")
        del inputs, dy, ds_final, got

    B, H, S, gates, layout, ds = SSD_BWD_CASES[0]
    inputs, dy, _ = ssd_bwd_case(torch, randn, B, H, S, gates, layout, ds)
    full = (*broadcast_heads(inputs[0], inputs[1], inputs[2]), *inputs[2:])
    got = ssd_scan_bwd_cuda(*inputs, dy)
    # ssd_scan under autograd as the Mamba2 block calls it: c and b (B, 1,
    # S, 64) leaves.  One launch of the backward kernel, and every leaf's
    # gradient is the kernel's output bit for bit: no cast or fold follows
    # it.  c's and b's, summed over the heads in the kernel, are held
    # against the step-by-step oracle's per-head gradients summed over the
    # heads, within twice the rel L2 that casting those to bf16 and folding
    # them makes alone
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    before = launches()["ssd_scan_bwd"]
    y, _ = ssd_scan(*leaves)
    y.backward(dy)
    n = launches()["ssd_scan_bwd"] - before
    same = all(t.grad.dtype == g.dtype and torch.equal(t.grad, g)
               for t, g in zip(leaves, got))
    want = ssd_bwd_ref(*full, dy)
    folds = {}
    for name, t, w in zip(SSD_BWD_OUT, leaves[:2], want):
        w1 = w.sum(1, keepdim=True)
        rel, floor = (rel_l2(t.grad, w1),
                      rel_l2(w.to(t.dtype).sum(1, keepdim=True), w1))
        folds[name] = (rel, floor)
        ok = rel <= SSD_BWD_FOLD_FACTOR * floor
        log(f"  {'ssd_scan_bwd':19s} {'autograd, folded ' + name:44s} "
            f"rel_l2={rel:.3e} (limit {SSD_BWD_FOLD_FACTOR:g} x the bf16 "
            f"fold's {floor:.3e}) {'ok' if ok else 'OUT OF TOLERANCE'}")
    report["ssd_scan_bwd folded"] = folds
    log(f"  {'ssd_scan_bwd':19s} {'autograd through ssd_scan':44s} launches "
        f"{n}, every gradient the kernel's output: {same}")
    if n != 1 or not same:
        fail("ssd_scan under autograd did not take the backward kernel's "
             "gradients as they are")
    # ROADMAP.md C9: the kernel encodes TMA maps on the host; called as the
    # first CUDA call of a thread of its own (no context is current there
    # until csrc/hopper.cuh:encode_bf16 makes the device's so), its outputs
    # must be the main thread's, bit for bit
    import threading
    box: dict = {}

    def on_thread():
        try:
            box["got"] = ssd_scan_bwd_cuda(*inputs, dy)
            torch.cuda.synchronize()
        except Exception as exc:        # reported below, on the main thread
            box["error"] = repr(exc)

    th = threading.Thread(target=on_thread)
    th.start()
    th.join()
    fresh = "got" in box and all(torch.equal(a, b)
                                 for a, b in zip(box["got"], got))
    err = f" {box['error']}" if "error" in box else ""
    log(f"  {'ssd_scan_bwd':19s} {'first CUDA call of a new thread':44s} "
        f"equal bit for bit: {fresh}{err}")
    report["ssd_scan_bwd new thread"] = fresh
    if not fresh:
        fail(f"ssd_scan_bwd on a thread with no current context: "
             f"{box.get('error', 'outputs differ')}")
    del box
    if any(rel > SSD_BWD_FOLD_FACTOR * floor for rel, floor in folds.values()):
        fail("ssd_scan under autograd: the folded gradients of the shared c "
             "and b disagree with the oracle's")
    del leaves, y, got, want
    same_bits(torch, "ssd_scan_bwd", f"B{B} H{H} S{S}",
              lambda: ssd_scan_bwd_cuda(*inputs, dy))
    ssd_bwd_planted_faults(torch, randn, report)
    N = P = L = 64
    # the chunked form on the tensor cores, over whole 64-row chunks: each
    # of the forward's products (c bᵀ, its masked product with x, c S and
    # the state's update bᵀ x) has two of its size in the backward, which
    # also computes c bᵀ and the chunks' states again from its inputs
    fwd = 2 * L * L * N + 2 * L * L * P + 4 * L * N * P
    flops = B * H * -(-S // L) * (2 * fwd + 2 * L * L * N + 2 * L * N * P)
    # x and dy read and dx written in bf16; c and b read and dc, db written
    # in bf16 once (shared by the heads: the kernel sums the gradient); the
    # gates read and dlog_a, dgate written in fp32
    c_heads = inputs[0].shape[1] if inputs[0].stride(1) else 1
    bytes_moved = (3 * B * H * S * P * 2 + 4 * B * c_heads * S * N * 2
                   + 4 * B * H * S * 4)
    b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16)
    row = {"name": "ssd_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
           "replaces": "no Pallas counterpart: the JAX package cannot "
                       "differentiate ssd_scan_pallas "
                       "(src/repro/kernels/ssd/kernel.py:92)",
           "max_abs_err": max(errs),
           "ms": timer.ms(lambda: ssd_scan_bwd_cuda(*inputs, dy)),
           "plain_ms": timer.ms(lambda: ssd_chunked_bwd_ref(*inputs, dy),
                                iters=3, warmup=1),
           # the step-by-step oracle (ssd_bwd_ref), the last design's twin
           "oracle_ms": timer.ms(lambda: ssd_bwd_ref(*full, dy), iters=2,
                                 warmup=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None,   # no one PyTorch call computes it
           "flop": flops, "bytes": bytes_moved}
    log(f"  {'ssd_scan_bwd':19s} {'the step-by-step oracle ssd_bwd_ref':44s}"
        f" {row['oracle_ms']:.4f} ms")
    del inputs, dy, full
    torch.cuda.empty_cache()
    return [row]


def ssd_bwd_planted_faults(torch, randn, report):
    """The backward's check must reject a wrong kernel, at the ragged case
    whose state carries (B 2, H 5, S 1000, slow decay, a nonzero ds_final).
    (1) Launched on each 128-row slice alone, the kernel starts every
    slice's state and G from 0: it runs as if the carried terms were
    dropped at those boundaries, with no edit to its source.  (2) The
    kernel's dlog_a less <ds_final, S_last>: the term a kernel that forgot
    it would lack.  (3) At S 1, the carry one row late
    (``ssd_bwd_carry_late``)."""
    from repro_torch.kernels.ssd.kernel import ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref, ssd_ref

    inputs, dy, ds = ssd_bwd_case(torch, randn, *SSD_BWD_CASES[1])
    S = inputs[2].shape[2]
    want = ssd_chunked_bwd_ref(*inputs, dy, ds)
    parts = [ssd_scan_bwd_cuda(*[t[:, :, i:i + SSD_L] for t in inputs],
                               dy[:, :, i:i + SSD_L],
                               ds if i + SSD_L >= S else None)
             for i in range(0, S, SSD_L)]
    sliced = [torch.cat([p[k] for p in parts], dim=2) for k in range(5)]
    res1 = ssd_bwd_check(torch, "", sliced, want, quiet=True)
    got = list(ssd_scan_bwd_cuda(*inputs, dy, ds))
    s_last = ssd_ref(*inputs)[1]
    got[3] = got[3] - (ds * s_last).sum((-2, -1))[..., None]
    res2 = ssd_bwd_check(torch, "", got, want, quiet=True)
    res3 = ssd_bwd_carry_late(torch, randn, ssd_bwd_case, SSD_BWD_CASES[4],
                              "ssd_scan_bwd")
    for label, res, rows in (
            ("(carried terms dropped at 128-row slices)", res1, S),
            ("(<ds_final, S_last> dropped from dlog_a)", res2, S),
            ("(S 1: dlog_a's carry one row late)", res3, 1)):
        log(f"    planted fault {label}: " + ", ".join(
            f"{k} {v[2]:.3e} (limit {ssd_bwd_limit_text(k, rows)}), "
            f"elementwise {'passes' if v[1] else 'fails'}"
            for k, v in res.items()))
    report["planted_fault ssd_scan_bwd"] = {"slices": res1, "ds_term": res2,
                                            "s1_dlog_a": res3}
    if any(v[0] for v in res1.values()):
        fail("the SSD backward's check does not reject a kernel that drops "
             "the carried terms")
    if res2["dlog_a"][0]:
        fail("the SSD backward's check does not reject a dlog_a without "
             "<ds_final, S_last>")
    if res3["dlog_a"][0]:
        fail("the SSD backward's check at S 1 does not reject a dlog_a whose "
             "carry comes one row late")


def ssd_bwd_carry_late(torch, randn, make, case, name):
    """The control of dlog_a's limits at S 1 (``case``, with ds_final,
    inputs from ``make``): the kernel's dlog_a plus <ds_final, S>, the
    carry taken after the row's update and not before it, one row late."""
    from repro_torch.kernels.ssd.kernel import ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref, ssd_ref

    inputs, dy, ds = make(torch, randn, *case)
    got = list(ssd_scan_bwd_cuda(*inputs, dy, ds))
    got[3] = got[3] + (ds * ssd_ref(*inputs)[1]).sum((-2, -1))[..., None]
    return ssd_bwd_check(torch, "", got, ssd_chunked_bwd_ref(*inputs, dy, ds),
                         quiet=True, name=name)


# The wide SSD backward's cases (B, H, S, gates, shared, ds_final): the
# train step's shape (B 4, H 4, S 2048, per-head q and k as c and b) with
# ds_final zero and given, a ragged S with the state carrying, one row, and
# q and k shared by the heads (a head stride of 0) at a ragged S.  x is v
# with its column of ones as the mLSTM block makes it, and dy a (B, H, S,
# 513) view of a dense (B, S, H, 513) tensor, as autograd may hand it back:
# its 1,026-byte rows are not 16-byte aligned, so the wrapper copies them
# into rows of a pitch of 520.
SSD_BWD_WIDE_CASES = ((4, 4, 2048, "path", False, False),
                      (4, 4, 2048, "path", False, True),
                      (2, 4, 1000, "slow", False, True),
                      (2, 3, 1, "slow", False, True),
                      (2, 3, 300, "slow", True, True))


def ssd_bwd_wide_case(torch, randn, B, H, S, gates, shared, ds):
    """(inputs, dy, ds_final) of the wide SSD backward (``ssd_wide_case``'s
    inputs)."""
    inputs = ssd_wide_case(torch, randn, B, H, S, gates, shared)
    dy = randn(B, S, H, 513).transpose(1, 2)
    return inputs, dy, (randn(B, H, 512, 513, dtype=torch.float32) if ds
                        else None)


def ssd_bwd_wide_rows(torch, timer, randn, report):
    """The wide SSD backward (N 512, P 513) against its plain twin
    ``ssd_chunked_bwd_ref`` on the same inputs, under ``ssd_bwd_check``'s
    limits (dx, dc, db in bf16 ulps, dlog_a and dgate elementwise and by rel
    L2).  First ``ssd_scan`` under autograd as the mLSTM block calls it, the
    process's first backward on the card: the wide backward is the first
    CUDA call of autograd's device thread (ROADMAP.md C9); one launch, and
    every leaf's gradient is the kernel's output bit for bit.  Then the
    cases, two calls equal bit for bit, three planted faults, and time and
    bound at the train step's shape (the first case) beside the twin's
    time, and each of its five kernels' device time there
    (``ssd_bwd_wide_split``)."""
    from repro_torch.kernels.common import launches
    from repro_torch.kernels.ssd.kernel import (padded_like,
                                                ssd_scan_bwd_cuda)
    from repro_torch.kernels.ssd.ops import ssd_scan
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    inputs, dy, _ = ssd_bwd_wide_case(torch, randn, *SSD_BWD_WIDE_CASES[2])
    # leaves in the layouts the block hands over: q and k (B, H, S, 512)
    # views, x with rows of a pitch of 520, the gates (B, H, S) views
    leaves = [t.detach().clone() if i != 2 else padded_like(t).copy_(t)
              for i, t in enumerate(inputs)]
    for t in leaves:
        t.requires_grad_()
    before = launches()["ssd_scan_bwd_wide"]
    y, _ = ssd_scan(*leaves)
    y.backward(dy)
    n = launches()["ssd_scan_bwd_wide"] - before
    got = ssd_scan_bwd_cuda(*inputs, dy)
    same = all(t.grad.dtype == g.dtype and torch.equal(t.grad, g)
               for t, g in zip(leaves, got))
    log(f"  {'ssd_scan_bwd_wide':19s} "
        f"{'autograd through ssd_scan, first on its thread':44s} launches "
        f"{n}, every gradient the kernel's output: {same}")
    report["ssd_scan_bwd_wide autograd"] = {"launches": n, "same": same}
    if n != 1 or not same:
        fail("ssd_scan under autograd did not take the wide backward "
             "kernel's gradients as they are")
    del leaves, y, got

    errs = []
    for B, H, S, gates, shared, ds in SSD_BWD_WIDE_CASES:
        inputs, dy, ds_final = ssd_bwd_wide_case(torch, randn, B, H, S,
                                                 gates, shared, ds)
        case = (f"N512 P513 B{B} H{H} S{S} {gates}"
                f"{' shared' if shared else ''}{' ds_final' if ds else ''}")
        got = ssd_scan_bwd_cuda(*inputs, dy, ds_final)
        if not all(torch.isfinite(g).all() for g in got):
            fail(f"ssd_scan_bwd_wide {case}: non-finite output")
        res = ssd_bwd_check(torch, case, got,
                            ssd_chunked_bwd_ref(*inputs, dy, ds_final),
                            name="ssd_scan_bwd_wide")
        report.setdefault("rel_l2", {}).update(
            {f"ssd_scan_bwd_wide {case} {k}": v[2] for k, v in res.items()})
        errs += [v[3] for v in res.values()]
        bad = [k for k, v in res.items() if not v[0]]
        if bad:
            fail(f"ssd_scan_bwd_wide {case}: {bad} disagree with the plain "
                 "version")
        del inputs, dy, ds_final, got

    ssd_bwd_wide_planted_faults(torch, randn, report)
    B, H, S, gates, shared, ds = SSD_BWD_WIDE_CASES[0]
    inputs, dy, _ = ssd_bwd_wide_case(torch, randn, B, H, S, gates, shared,
                                      ds)
    same_bits(torch, "ssd_scan_bwd_wide", f"N512 P513 B{B} H{H} S{S}",
              lambda: ssd_scan_bwd_cuda(*inputs, dy))
    N, P, L = 512, 513, 64
    # the chunked form over whole 64-row chunks: five products of 2·L·N·P
    # (the two state passes, dY S_inᵀ, X Gᵀ, B G) and five of a 64 x 64
    # matrix (C Bᵀ, dY Xᵀ, Mᵀ dY, (dM∘D) B, (dM∘D)ᵀ C), at the bf16 peak
    flops = B * H * -(-S // L) * (5 * 2 * L * N * P
                                  + 2 * L * L * (3 * N + 2 * P))
    # c, b read and dc, db written (per head), x, dy read and dx written, in
    # bf16; the gates read and dlog_a, dgate written in fp32
    bytes_moved = (4 * B * H * S * N * 2 + 3 * B * H * S * P * 2
                   + 4 * B * H * S * 4)
    b_ms, b_by = bound(bytes_moved, flops, PEAK_BF16)
    row = {"name": "ssd_scan_bwd_wide", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_scan_bwd_wide.cu",
           "replaces": "no Pallas counterpart: the JAX package cannot "
                       "differentiate ssd_scan_pallas "
                       "(src/repro/kernels/ssd/kernel.py:92)",
           "max_abs_err": max(errs),
           "ms": timer.ms(lambda: ssd_scan_bwd_cuda(*inputs, dy)),
           "plain_ms": timer.ms(lambda: ssd_chunked_bwd_ref(*inputs, dy),
                                iters=3, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None,   # no one PyTorch call computes it
           "flop": flops, "bytes": bytes_moved}
    split = ssd_bwd_wide_split(torch, timer,
                               lambda: ssd_scan_bwd_cuda(*inputs, dy))
    log(f"  {'ssd_scan_bwd_wide':19s} split at N512 P513 B{B} H{H} S{S} "
        f"(torch.profiler, L2 flushed, µs a call): " +
        ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    row["split_us"] = split
    del inputs, dy
    torch.cuda.empty_cache()
    return [row]


# the wide backward's kernels by their profiler names, in launch order
WIDE_BWD_KERNELS = (("wide_bwd_prep_kernel", "prep"),
                    ("wide_bwd_band_kernel<0>", "dc pass"),
                    ("wide_bwd_band_kernel<1>", "db pass"),
                    ("wide_bwd_band_kernel<2>", "dx pass"),
                    ("wide_bwd_finish_kernel", "finish"))


def ssd_bwd_wide_split(torch, timer, call, n=5):
    """Device µs of each kernel of one wide-backward call, from
    torch.profiler over ``n`` calls, each after the L2 flush (the Timer's
    cold start): {label: µs a call} in launch order."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            timer.flush_buf.zero_()
            call()
        torch.cuda.synchronize()
    rows, _, _ = _kernel_table(prof, n)
    return {label: sum(us for name, _, us in rows if key in name)
            for key, label in WIDE_BWD_KERNELS}


def chunk_local_dx(inputs, dy):
    """The wide backward's dx with each 64-row chunk launched alone and no
    ds_final: G is 0 in every chunk, so dx is M^T dY alone, without its
    w∘(B G) term."""
    import torch

    from repro_torch.kernels.ssd.kernel import ssd_scan_bwd_cuda
    S = inputs[2].shape[2]
    return torch.cat([ssd_scan_bwd_cuda(*[t[:, :, i:i + 64] for t in inputs],
                                        dy[:, :, i:i + 64])[2]
                      for i in range(0, S, 64)], dim=2)


def ssd_bwd_wide_planted_faults(torch, randn, report):
    """The wide backward's check must reject a wrong kernel, with no edit to
    the kernel's source.  At the ragged case whose state carries (B 2, H 4,
    S 1000, slow decay, a nonzero ds_final): (1) launched on each 128-row
    slice alone, the kernel starts every slice's S_in and G from 0: the
    carried terms dropped at those boundaries; (2) launched on each 64-row
    chunk alone without ds_final, G is 0 in every chunk, so its dx is M^T
    dY alone: dx without its w∘(B G) term (``chunk_local_dx``).  At S 1
    with ds_final, where dlog_a is 0 in exact arithmetic and has limits of
    its own: (3) dlog_a plus <ds_final, S>, the carry taken one row late
    (after the row's update), the control of those limits."""
    from repro_torch.kernels.ssd.kernel import ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    inputs, dy, ds = ssd_bwd_wide_case(torch, randn, *SSD_BWD_WIDE_CASES[2])
    S = inputs[2].shape[2]
    want = ssd_chunked_bwd_ref(*inputs, dy, ds)
    parts = [ssd_scan_bwd_cuda(*[t[:, :, i:i + SSD_L] for t in inputs],
                               dy[:, :, i:i + SSD_L],
                               ds if i + SSD_L >= S else None)
             for i in range(0, S, SSD_L)]
    name = "ssd_scan_bwd_wide"
    res1 = ssd_bwd_check(torch, "", [torch.cat([p[k] for p in parts], dim=2)
                                     for k in range(5)], want, quiet=True,
                         name=name)
    got = list(ssd_scan_bwd_cuda(*inputs, dy, ds))
    got[2] = chunk_local_dx(inputs, dy)
    res2 = ssd_bwd_check(torch, "", got, want, quiet=True, name=name)
    res3 = ssd_bwd_carry_late(torch, randn, ssd_bwd_wide_case,
                              SSD_BWD_WIDE_CASES[3], name)
    for label, res, rows in (
            ("(carried terms dropped at 128-row slices)", res1, S),
            ("(dx without w∘(B G))", res2, S),
            ("(S 1: dlog_a's carry one row late)", res3, 1)):
        log(f"    planted fault {label}: " + ", ".join(
            f"{k} {v[2]:.3e} (limit {ssd_bwd_limit_text(k, rows)}), "
            f"elementwise "
            f"{'passes' if v[1] else 'fails'}"
            for k, v in res.items()))
    report["planted_fault ssd_scan_bwd_wide"] = {"slices": res1, "dx": res2,
                                                 "s1_dlog_a": res3}
    if any(v[0] for v in res1.values()):
        fail("the wide SSD backward's check does not reject a kernel that "
             "drops the carried terms")
    if res2["dx"][0]:
        fail("the wide SSD backward's check does not reject a dx without "
             "its w∘(B G) term")
    if res3["dlog_a"][0]:
        fail("the wide SSD backward's check at S 1 does not reject a dlog_a "
             "whose carry comes one row late")


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


# granite-moe-3b-a800m's training shapes: a microbatch of 4 x 2048 tokens at
# top-8 over 40 experts gives C = 2048 rows an expert, T = 48 x 2048
GMM_BWD_SHAPES = {"gate/up": (2048, GMM_D, GMM_F),
                  "down": (2048, GMM_F, GMM_D)}


def moe_gmm_bwd_rows(torch, timer, randn, check):
    """The grouped matmul's backward against the plain backward: dx and dw
    at the train step's two shapes (equal groups) and at ragged ones (an
    empty expert, sizes that sum to less than T, T not a multiple of the
    128-row tile, K and N tails, 48 experts of sizes drawn around 2048 at
    full width, so that most experts end inside a 64-row slice of dw); a
    planted tail (moe_gmm_bwd_planted_tail); two calls equal bit for bit at
    both train shapes; times, bound and torch.bmm on the equal-group views
    at each train shape."""
    import numpy as np

    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_bwd_cuda
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref

    def sizes_of(lst):
        return torch.tensor(lst, dtype=torch.int32, device="cuda")

    errs = []
    cases = [(f"{name}: T {GMM_E * c} = {GMM_E} x {c}, D {d}, F {f}",
              GMM_E * c, d, f, [c] * GMM_E)
             for name, (c, d, f) in GMM_BWD_SHAPES.items()]
    ragged7 = [13, 70, 3, 201, 1, 97, 131]
    cases += [
        ("ragged: 130 rows over 5, an empty expert", 130, GMM_D, GMM_F,
         [31, 0, 47, 1, 51]),
        ("rows past the groups: 72 of 200", 200, GMM_D, GMM_F,
         [0, 100, 0, 28]),
        ("ragged starts, T 516 (not a multiple of 128)", 516, GMM_F, GMM_D,
         ragged7),
        ("D 72, F 200: K and N tails, 16 rows past", 532, 72, 200, ragged7),
        ("48 experts, 1000 rows drawn, 5 empty", 1000, GMM_D, GMM_F,
         [0] * 5 + np.random.default_rng(0).multinomial(
             1000, [1 / (GMM_E - 5)] * (GMM_E - 5)).tolist())]
    # full width, 48 experts of 1800..2299 rows: 47 of the 48 ends fall
    # inside a 64-row slice
    drawn = np.random.default_rng(1).integers(1800, 2300, GMM_E).tolist()
    cases += [(f"48 experts of {min(drawn)}..{max(drawn)} rows, T "
               f"{sum(drawn)}, D {d}, F {f}", sum(drawn), d, f, drawn)
              for d, f in ((GMM_D, GMM_F), (GMM_F, GMM_D))]
    for case, T, d, f, sizes in cases:
        x, dy = randn(T, d), randn(T, f)
        w = (randn(len(sizes), d, f) * d ** -0.5).to(torch.bfloat16)
        g = sizes_of(sizes)
        dx, dw = moe_gmm_bwd_cuda(x, w, dy, g)
        rdx, rdw = moe_gmm_bwd_ref(x, w, dy, g)
        errs.append(check("moe_gmm_bwd", f"{case} dx", dx, rdx))
        errs.append(check("moe_gmm_bwd", f"{case} dw", dw, rdw))
        n = sum(sizes)
        if dx[n:].any():
            fail(f"moe_gmm_bwd {case}: rows past the groups have dx != 0")
        empty = [e for e, c in enumerate(sizes) if c == 0]
        if empty and dw[empty].any():
            fail(f"moe_gmm_bwd {case}: an empty expert has dw != 0")
        del x, dy, w, dx, dw, rdx, rdw
    errs += moe_gmm_bwd_planted_tail(torch, randn, check)

    shapes = {}
    for name, (c, d, f) in GMM_BWD_SHAPES.items():
        T = GMM_E * c
        x, dy = randn(T, d), randn(T, f)
        w = (randn(GMM_E, d, f) * d ** -0.5).to(torch.bfloat16)
        g = sizes_of([c] * GMM_E)
        same_bits(torch, "moe_gmm_bwd", f"T {T}, D {d}, F {f}",
                  lambda: moe_gmm_bwd_cuda(x, w, dy, g))
        xb, dyb = x.view(GMM_E, c, d), dy.view(GMM_E, c, f)
        wt = w.transpose(1, 2)

        def library():
            return torch.bmm(dyb, wt), torch.bmm(xb.transpose(1, 2), dyb)

        b_ms, b_by = bound(2 * T * d * 2 + T * f * 2 + 2 * GMM_E * d * f * 2
                           + GMM_E * 4, 2 * 2 * T * d * f, PEAK_BF16)
        shapes[name] = {
            "shape": f"T {T} = {GMM_E} x {c}, D {d}, F {f}",
            "ms": timer.ms(lambda: moe_gmm_bwd_cuda(x, w, dy, g)),
            "plain_ms": timer.ms(lambda: moe_gmm_bwd_ref(x, w, dy, g),
                                 iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(library)}
        del x, dy, w, xb, dyb, wt
    torch.cuda.empty_cache()
    main = shapes.pop("gate/up")
    return [{"name": "moe_gmm_bwd", "route": "cuda",
             "source": "src/repro_torch/csrc/moe_gmm_bwd.cu",
             "replaces": "no Pallas counterpart: the JAX package cannot "
                         "differentiate moe_gmm_pallas "
                         "(src/repro/kernels/moe_gmm/kernel.py:61)",
             "max_abs_err": max(errs), **main, "shapes": shapes}]


def moe_gmm_bwd_planted_tail(torch, randn, check):
    """dw's last slice of an expert holds its neighbour's first rows, which
    the kernel must zero.  At full width, expert 0 ends 6 rows into a
    64-row slice and expert 1's x and dy rows are +-1e3: a tail read would
    add ~1e6 an element to dw[0], whose elements are ~10.  dw and dx must
    match the plain backward; a plain control that also sums expert 1's
    first row into dw[0] must fail the same check.  w is +-2^-6 and the
    large rows +-1e3, so that every product and sum of expert 1's dx and dw
    is exact in fp32 (the check's atol is absolute, and a rounding at 1e6
    would show as an error there); the other experts' rows are N(0, 1)."""
    from repro_torch.kernels.common import REL_L2, rel_l2, within
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_bwd_cuda
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref

    key = "moe_gmm_bwd/card_bf16"
    sizes = [70, 130, 45, 67]
    T, E, lo, hi = sum(sizes), len(sizes), sizes[0], sum(sizes[:2])
    x, dy = randn(T, GMM_D), randn(T, GMM_F)
    for t in (x, dy):
        t[lo:hi] = torch.sign(randn(hi - lo, t.shape[1])) * 1e3
    w = torch.sign(randn(E, GMM_D, GMM_F)) * 2.0 ** -6
    g = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    case = f"planted tail: sizes {sizes}, expert 1 at +-1e3"
    dx, dw = moe_gmm_bwd_cuda(x, w, dy, g)
    rdx, rdw = moe_gmm_bwd_ref(x, w, dy, g)
    errs = [check("moe_gmm_bwd", f"{case} dx", dx, rdx),
            check("moe_gmm_bwd", f"{case} dw", dw, rdw)]
    control = rdw.clone()
    control[0] = (x[:lo + 1].float().T @ dy[:lo + 1].float()).to(rdw.dtype)
    ok, rel = within(control, rdw, key), rel_l2(control, rdw)
    log(f"    planted control (dw[0] also sums expert 1's first row): "
        f"rel_l2={rel:.3e} (limit {REL_L2[key]:g}), elementwise check "
        f"{'passes' if ok else 'fails'}")
    if ok or rel <= REL_L2[key]:
        fail("the moe_gmm_bwd check does not reject a dw that reads the "
             "next expert's first row")
    return errs


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
    for (B, Hq, Hkv, S, D, causal, window) in (
            (4, 28, 4, 2048, 128, True, 0),   # the train step's shape
            (2, 28, 4, 1000, 128, True, 0),   # ragged S
            (1, 14, 2, 300, 128, True, 64),   # windowed
            (1, 14, 2, 300, 128, False, 0),   # not causal
            (1, 7, 1, 77, 128, True, 0),      # group 7 over one kv head
            (1, 14, 2, 129, 128, True, 0),    # one row past a 128-row tile
            (1, 28, 4, 2048, 128, True, 256),  # windowed at the train S
            (4, 24, 8, 2048, 64, True, 0),    # granite's train step, D 64
            (2, 24, 8, 1001, 64, True, 0),    # ragged S, group 3
            (1, 24, 8, 129, 64, True, 0),     # one row past a tile, D 64
            (1, 6, 2, 300, 64, False, 0),     # not causal, D 64
            (1, 24, 8, 300, 64, True, 64),    # windowed, D 64
            (4, 32, 32, 2048, 64, True, 0)):  # zamba2's train step, group 1
        q, k, v = bshd(B, S, Hq, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
        do = bshd(B, S, Hq, D)
        opts = dict(causal=causal, window=window)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **opts)
        _, rlse = attention_ref(q, k, v, return_lse=True, **opts)
        case = (f"B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} "
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
    def flash_bwd_timings(B, Hq, Hkv, S, D, planted=False):
        q, k, v = bshd(B, S, Hq, D), bshd(B, S, Hkv, D), bshd(B, S, Hkv, D)
        do = bshd(B, S, Hq, D)
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        same_bits(torch, "flash_attention_bwd",
                  f"B{B} Hq{Hq} Hkv{Hkv} S{S} D{D}",
                  lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do))
        if planted:
            planted_fault(torch, report, q, k, v, o, lse, do)
        pairs = S * (S + 1) // 2
        b_ms, b_by = bound(B * S * D * 2 * (4 * Hq + 4 * Hkv)
                           + B * Hq * S * 4, 5 * 2 * B * Hq * D * pairs,
                           PEAK_BF16)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            enable_gqa=True)
        out = {
            "shape": f"B{B} Hq{Hq} Hkv{Hkv} S{S} D{D} causal",
            "ms": timer.ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse,
                                                            do)),
            "plain_ms": timer.ms(lambda: attention_bwd_ref(q, k, v, o, lse,
                                                           do),
                                 iters=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer.ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), do, retain_graph=True))}
        del q, k, v, do, o, lse, lq, lk, lv, lo
        torch.cuda.empty_cache()
        return out

    # qwen2-7b's train step (D 128, group 7), granite-moe-3b-a800m's (D 64,
    # 24 q heads over 8) and zamba2-1.2b's (D 64, 32 over 32)
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "no Pallas counterpart: the JAX package cannot "
                    "differentiate flash_attention_pallas "
                    "(src/repro/kernels/flash_attention/kernel.py:103)",
        "max_abs_err": max(errs),
        **flash_bwd_timings(4, 28, 4, 2048, 128, planted=True),
        "shapes": {"granite D64": flash_bwd_timings(4, 24, 8, 2048, 64),
                   "zamba2 D64": flash_bwd_timings(4, 32, 32, 2048, 64)}})

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
            "ssd_scan_wide": 0, "ssd_wide_prep": 0, "moe_gmm": 0,
            "moe_gmm_bwd": 0, "ssd_scan_bwd": 0, "ssd_scan_bwd_wide": 0}
# zamba2-1.2b: 38 Mamba2 layers in 6 groups of 6 and a tail of 2, the shared
# block after each group.  A pass runs 51 rmsnorms (one per Mamba2 layer,
# two per shared block, the final one); a prefill wave 6 flash and 38 SSD
# launches, a decode step 6 decode-attention launches (its SSD step is plain
# torch, as in the JAX package).  Two waves and 128 decode steps.
HYBRID_EXPECTED = {"rmsnorm": (38 + 2 * 6 + 1) * (2 + 128),
                   "flash_attention": 6 * 2, "decode_attention": 6 * 128,
                   "ssd_scan": 38 * 2, "cross_entropy": 0,
                   "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "moe_gmm": 0,
                   "ssd_scan_wide": 0, "ssd_wide_prep": 0, "moe_gmm_bwd": 0,
                   "ssd_scan_bwd": 0, "ssd_scan_bwd_wide": 0}
# granite-moe-3b-a800m: 32 layers, each 2 rmsnorms and 3 grouped matmuls (the
# experts' gate, up and down products), and the final norm: a pass (a
# prefill wave or a decode step) is 65 rmsnorm and 96 moe_gmm launches.
MOE_EXPECTED = {"rmsnorm": (2 * 32 + 1) * (2 + 128), "flash_attention": 32 * 2,
                "decode_attention": 32 * 128, "moe_gmm": 96 * (2 + 128),
                "ssd_scan": 0, "cross_entropy": 0, "flash_attention_bwd": 0,
                "rmsnorm_bwd": 0, "ssd_scan_wide": 0, "ssd_wide_prep": 0,
                "moe_gmm_bwd": 0, "ssd_scan_bwd": 0, "ssd_scan_bwd_wide": 0}
# xlstm-1.3b: 6 segments of 7 mLSTM blocks and one sLSTM block.  A pass (a
# prefill wave or a decode step) runs 49 rmsnorms (one per block, the final
# one); a prefill wave runs the wide SSD scan once per mLSTM block, 42, each
# call two kernels (the first pass, ssd_wide_prep, then ssd_scan_wide); a
# decode step none (its SSD step is plain torch, as in the JAX package), and
# the sLSTM is plain torch.  No attention, no MLP.
SSM_EXPECTED = {"rmsnorm": (48 + 1) * (2 + 128), "ssd_scan_wide": 42 * 2,
                "ssd_wide_prep": 42 * 2, "flash_attention": 0,
                "decode_attention": 0, "ssd_scan": 0, "cross_entropy": 0,
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "moe_gmm": 0,
                "moe_gmm_bwd": 0, "ssd_scan_bwd": 0, "ssd_scan_bwd_wide": 0}
# starcoder2-15b: 40 layers, each 2 rmsnorms, one flash launch a prefill wave
# and one decode launch a step, and the final norm.
STARCODER_EXPECTED = {"rmsnorm": (2 * 40 + 1) * (2 + 128),
                      "flash_attention": 40 * 2, "decode_attention": 40 * 128,
                      "cross_entropy": 0, "flash_attention_bwd": 0,
                      "rmsnorm_bwd": 0, "ssd_scan": 0, "ssd_scan_wide": 0,
                      "ssd_wide_prep": 0, "moe_gmm": 0, "moe_gmm_bwd": 0,
                      "ssd_scan_bwd": 0, "ssd_scan_bwd_wide": 0}
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


def train_launches(layers: int, moe: bool = False) -> dict:
    """Launches of one step at ``layers`` layers and M = TRAIN_MB (remat
    reruns each layer's 2 norms, 1 flash forward and, for a MoE layer, its 3
    grouped products in the backward; the final norm and the CE head are
    not remat'd).  A MoE layer's backward runs one grouped-matmul backward
    (dx and dw) for each of its 3 products."""
    return {"rmsnorm": TRAIN_MB * (2 * layers * 2 + 1),
            "rmsnorm_bwd": TRAIN_MB * (2 * layers + 1),
            "flash_attention": TRAIN_MB * layers * 2,
            "flash_attention_bwd": TRAIN_MB * layers,
            "cross_entropy": TRAIN_MB, "decode_attention": 0, "ssd_scan": 0,
            "ssd_scan_wide": 0, "ssd_wide_prep": 0,
            "moe_gmm": TRAIN_MB * 3 * layers * 2 if moe else 0,
            "moe_gmm_bwd": TRAIN_MB * 3 * layers if moe else 0,
            "ssd_scan_bwd": 0, "ssd_scan_bwd_wide": 0}


# per step at L = 4, M = 2
TRAIN_EXPECTED = train_launches(TRAIN_LAYERS)
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


# ---------------------------------------------------------------------------
# phase 12b: training granite-moe-3b-a800m, full width and depth
# ---------------------------------------------------------------------------

# Bytes a parameter of the train step holds: the bf16 weight and its bf16
# gradient, the fp32 accumulator, AdamW's two fp32 moments.
TRAIN_STATE_B = 16
# Room the step needs beside that state at the phase's batch (remat: one
# layer's activations and dispatch buffers at a time, 48 x 2048 x 1536 bf16
# = 302 MB a grouped product; the 32 layer inputs, 25 MB each; the stacked
# gradients' unbind; the LM head's chunked CE).  A depth whose state and
# this exceed the card's memory is cut.
TRAIN_MOE_ROOM = 10 << 30
# constant lr, as TRAIN_LR: on the H100 the loss on the repeated batch rose
# again at step 3 for lr 1e-4 and fell at every step for 5e-5, 2e-5 and
# 1e-5 (4 steps each at this phase's config and batch); 1e-5 is kept, the
# steadiest (~0.2 a step, where 5e-5 fell 2.45 and then 0.19).
TRAIN_MOE_LR = 1e-5
# the card-against-CPU gradient check: 2 layers, every expert chosen
# (top_k = n_experts: no assignment dropped, so the routing cannot differ
# between the two), 2 x 256 tokens; each gradient leaf's rel L2 against the
# CPU's fp32 run must stay within TRAIN_MOE_FLOOR_FACTOR times the rel L2 of
# the CPU's own bf16 run (the floor), the loss within that factor of its
# floor or of half a bf16 ulp, whichever is larger
TRAIN_MOE_CHECK = dict(layers=2, seq=256, batch=2)
TRAIN_MOE_FLOOR_FACTOR = 2.0


def train_moe_config(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                         n_layers=layers)


def allocated_params(cfg) -> int:
    """The parameters ``init_params`` allocates for ``cfg`` (the padding
    experts included, which ``params_count`` leaves out), from their meta
    shapes."""
    from repro_torch.models.model import param_specs
    from repro_torch.optim.optimizers import tree_leaves
    return sum(t.numel() for t in tree_leaves(param_specs(cfg)))


def train_moe_depth(torch) -> tuple:
    """The published depth, or the deepest that fits the card with
    TRAIN_MOE_ROOM beside its state; (layers, the reckoning's text)."""
    total = torch.cuda.get_device_properties(0).total_memory
    layers = train_moe_config().n_layers
    while layers > 1 and (allocated_params(train_moe_config(layers))
                          * TRAIN_STATE_B + TRAIN_MOE_ROOM > total):
        layers -= 1
    n = allocated_params(train_moe_config(layers))
    text = (f"{layers} of {train_moe_config().n_layers} layers: {n / 1e9:.3f}"
            f" B parameters (48 experts a layer, 40 of them routed) x "
            f"{TRAIN_STATE_B} B = {n * TRAIN_STATE_B / 1e9:.1f} GB of state "
            f"+ {TRAIN_MOE_ROOM / 2**30:.0f} GiB of room against "
            f"{total / 1e9:.1f} GB on the card")
    return layers, text


def train_moe_phase(torch, np, report):
    from repro_torch.data.lm import DataConfig, global_batch_at
    from repro_torch.kernels.common import launches, reset_launches
    from repro_torch.models import init_params, moe
    from repro_torch.models.model import forward
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    layers, reckoning = train_moe_depth(torch)
    cfg = train_moe_config(layers)
    cut = layers != train_moe_config().n_layers
    log(f"  {MOE_ARCH} published widths, {reckoning}"
        f"{' (depth cut: the state does not fit)' if cut else ''}; "
        f"remat={cfg.remat} ({cfg.remat_policy}), {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    step = make_train_step(cfg, adamw(lr=TRAIN_MOE_LR))
    opt_state = step.init_opt_state(params)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, microbatches=TRAIN_MB,
                      seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in global_batch_at(data, 0).items()}
    tokens = TRAIN_SEQ * TRAIN_BATCH
    losses, times, norms = [], [], []
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"].item()))
        norms.append(float(metrics["grad_norm"].item()))
        times.append(time.perf_counter() - t0)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(times[1:])) * 1e3

    # the drop share of a training microbatch: one untimed forward of
    # microbatch 0 at the trained parameters, the routing recorded
    moe.ROUTING_STATS = []
    with torch.no_grad():
        forward(params, {"tokens": batch["tokens"][0]}, cfg)
    routing = routing_counts(torch, moe.ROUTING_STATS)
    moe.ROUTING_STATS = None
    assigned = sum(r["assigned"] for r in routing)
    dropped = sum(r["dropped"] for r in routing)
    drop_share = dropped / assigned
    log(f"  lr {TRAIN_MOE_LR:g}  losses {[round(v, 4) for v in losses]}  "
        f"grad norms {[round(v, 3) for v in norms]}")
    log(f"  step ms {[round(t * 1e3, 1) for t in times]}  (median after the "
        f"first: {step_ms:.1f} ms)  tokens/s {tokens / step_ms * 1e3:.0f}  "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"  a training microbatch ({TRAIN_BATCH // TRAIN_MB} x {TRAIN_SEQ} "
        f"tokens, C {routing[0]['capacity']}): {dropped} of {assigned} "
        f"assignments dropped over {len(routing)} layers, share "
        f"{drop_share:.4f}")
    log(f"  launches {counts}")
    expected = {k: v * TRAIN_STEPS for k, v in
                train_launches(layers, moe=True).items()}
    report["train_moe"] = {
        "layers": layers, "reckoning": reckoning, "lr": TRAIN_MOE_LR,
        "params": allocated_params(cfg), "tokens_per_step": tokens,
        "losses": losses, "grad_norms": norms, "step_s": times,
        "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "peak_bytes": peak, "drop_share": drop_share,
        "routing": routing, "launches": counts}
    del params, opt_state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        fail(f"non-finite MoE training loss {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"the MoE loss did not fall at every step on a repeated batch: "
             f"{losses}")
    if counts != expected:
        fail(f"train_moe launch counts {counts}, expected {expected}")
    train_moe_grad_check(torch, np, report)
    return counts


def train_moe_grad_check(torch, np, report):
    """At TRAIN_MOE_CHECK's 2 layers with every expert chosen, the card's
    loss and every gradient leaf against the CPU's fp32 run (``grad_check``)."""
    c = TRAIN_MOE_CHECK
    cfg = dataclasses.replace(train_moe_config(c["layers"]),
                              top_k=train_moe_config().n_experts)
    grad_check(torch, report, "train_moe_grad_check", cfg, c,
               TRAIN_MOE_FLOOR_FACTOR,
               f"2 layers, top_k {cfg.top_k}", {"top_k": cfg.top_k})


def grad_check(torch, report, key, cfg, c, factor, what, extra=None):
    """The card's loss and every gradient leaf of ``cfg`` (bf16) on
    ``c["batch"]`` x ``c["seq"]`` tokens against the CPU's fp32 run on the
    same parameters and tokens, each within ``factor`` times the CPU's own
    bf16 run's distance from that fp32 run (the floor); the loss within
    that factor of its floor or of half a bf16 ulp, whichever is larger
    (:func:`grad_check_start`, then :func:`grad_check_finish`)."""
    grad_check_finish(torch, report, key, grad_check_start(torch, cfg, c),
                      factor, what, extra)


def grad_check_start(torch, cfg, c) -> dict:
    """``cfg``'s parameters drawn on the card (seed 1) and the tokens, then
    the CPU's fp32 and bf16 runs started on a thread of their own, so that
    a caller may run the card's work meanwhile.  The CPU's two runs go
    without the remat, which changes no number there and would run every
    layer's forward twice on the host; the card runs ``cfg`` as it is."""
    import threading

    from repro_torch.data.lm import DataConfig, global_batch_at
    from repro_torch.distributed.policy import tree_leaves_with_path
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    data = DataConfig(vocab=cfg.vocab, seq_len=c["seq"],
                      global_batch=c["batch"], microbatches=1, seed=1)
    host = {k: torch.from_numpy(v[0]) for k, v in
            global_batch_at(data, 0).items()}
    t0 = time.perf_counter()
    card = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                       device="cuda")
    cpu16 = tree_map(lambda t: t.detach().cpu(), card)
    cpu32 = tree_map(lambda t: t.float(), cpu16)

    def run(params, run_cfg, device):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(params, {k: v.to(device) for k, v in host.items()},
                       run_cfg)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), [g.detach().float().cpu()
                                      for g in grads]

    state = {"cfg": cfg, "c": c, "run": run, "card": card,
             "names": [path for path, _ in tree_leaves_with_path(card)],
             "walls": {"draw": time.perf_counter() - t0}}

    def references():
        try:
            for name, params, run_cfg in (
                    ("cpu_fp32", cpu32, dataclasses.replace(
                        cfg, dtype="float32", remat=False)),
                    ("cpu_bf16", cpu16, dataclasses.replace(cfg,
                                                            remat=False))):
                t1 = time.perf_counter()
                state[name] = run(params, run_cfg, "cpu")
                state["walls"][name] = time.perf_counter() - t1
        except BaseException as exc:    # re-raised by grad_check_finish
            state["error"] = exc

    state["thread"] = threading.Thread(target=references, daemon=True)
    state["thread"].start()
    return state


def grad_check_finish(torch, report, key, state, factor, what, extra=None,
                      planted=None):
    """The card's run of :func:`grad_check_start`'s parameters, then the
    CPU's runs waited for, and every comparison (``grad_check``).
    ``planted``: (label, a context manager factory that plants a fault in
    the card's path, whether the check must reject it): the card's run
    again under the fault, held to the same limits; where it must be
    rejected, the check fails if it passes, and else it is reported."""
    from repro_torch.kernels.common import rel_l2

    cfg, c = state["cfg"], state["c"]
    t0 = time.perf_counter()
    got_loss, got = state["run"](state["card"], cfg, "cuda")
    faulty = None
    if planted is not None:
        with planted[1]():
            faulty = state["run"](state["card"], cfg, "cuda")
    del state["card"]
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state["thread"].join()
    if "error" in state:
        raise state["error"]
    (want_loss, want), (ref_loss, ref) = state["cpu_fp32"], state["cpu_bf16"]
    walls = [state["walls"]["draw"] + card_s, state["walls"]["cpu_fp32"],
             state["walls"]["cpu_bf16"], time.perf_counter() - t0]
    names = state["names"]
    loss_floor = abs(ref_loss - want_loss) / abs(want_loss)
    loss_limit = factor * max(loss_floor, 2.0 ** -9)
    floors = [rel_l2(r, w) for r, w in zip(ref, want)]

    def held(loss, grads, quiet=False):
        rows, bad = {}, []
        for name, g, w, floor in zip(names, grads, want, floors):
            err = rel_l2(g, w)
            rows[name] = {"rel_l2": err, "floor": floor}
            ok = err <= factor * floor
            if not ok:
                bad.append(name)
            if not quiet:
                log(f"    {name:24s} rel_l2 {err:.3e}  floor {floor:.3e}  "
                    f"{'ok' if ok else 'OUT OF BOUND'}")
        return abs(loss - want_loss) / abs(want_loss), rows, bad

    loss_err, rows, bad = held(got_loss, got)
    log(f"  {what}, {c['batch']} x {c['seq']} tokens: loss card "
        f"{got_loss:.6f}, CPU fp32 {want_loss:.6f} (rel err {loss_err:.3e}, "
        f"limit {loss_limit:.3e}; CPU bf16 {ref_loss:.6f}, floor "
        f"{loss_floor:.3e}); {len(rows)} gradient leaves within "
        f"{factor:g} x their floor: {not bad} (card, CPU fp32, CPU bf16 "
        f"{', '.join(f'{w:.1f}' for w in walls[:3])} s; waited "
        f"{walls[3]:.1f} s for the CPU's runs)")
    report[key] = {
        "layers": cfg.n_layers, **(extra or {}),
        "tokens": c["batch"] * c["seq"],
        "loss": {"card": got_loss, "cpu_fp32": want_loss,
                 "cpu_bf16": ref_loss, "rel_err": loss_err,
                 "floor": loss_floor, "limit": loss_limit},
        "leaves": rows, "factor": factor, "walls_s": walls}
    if loss_err > loss_limit:
        fail(f"{key}: the card's loss is off the CPU's fp32 loss by "
             f"{loss_err} (limit {loss_limit})")
    if bad:
        fail(f"{key}: gradients off the CPU's fp32 run beyond {factor:g} x "
             f"their bf16 floor: {bad}")
    if planted is None:
        return
    label, _, must_reject = planted
    f_err, f_rows, f_bad = held(*faulty, quiet=True)
    rejected = bool(f_bad) or f_err > loss_limit
    log(f"    planted fault ({label}): loss rel err {f_err:.3e}; leaves out "
        f"of bound: " + (", ".join(
            f"{n} {f_rows[n]['rel_l2']:.3e} (floor {f_rows[n]['floor']:.3e})"
            for n in f_bad) or "none") + (f"; rejected: {rejected}"
        if must_reject else f"; rejected: {rejected} (measured, no "
        f"verdict)"))
    report[key]["planted"] = {"label": label, "loss_rel_err": f_err,
                              "leaves": f_rows, "rejected": rejected,
                              "must_reject": must_reject}
    if must_reject and not rejected:
        fail(f"{key}: the check does not reject the planted fault "
             f"({label})")


# ---------------------------------------------------------------------------
# phase 12c: training zamba2-1.2b, full width and depth
# ---------------------------------------------------------------------------

# constant lr, as TRAIN_LR and TRAIN_MOE_LR
TRAIN_HYBRID_LR = 1e-5
# the card-against-CPU gradient check (as TRAIN_MOE_CHECK): 7 layers (one
# group of 6, the shared block once, a tail of 1), 2 x 256 tokens
TRAIN_HYBRID_CHECK = dict(layers=7, seq=256, batch=2)
TRAIN_HYBRID_FLOOR_FACTOR = 2.0


def hybrid_train_launches(cfg) -> dict:
    """Launches of one zamba2 step at M = TRAIN_MB under the layer-granular
    remat (``models/model.py:_hybrid_trunk``): each Mamba2 layer's rmsnorm
    and SSD scan and each shared-block application's 2 rmsnorms and flash
    forward run twice (the forward, then again in the backward); the final
    norm and the CE head once; every backward once."""
    from repro_torch.models.model import hybrid_layout
    apps = hybrid_layout(cfg)[0]
    norms = cfg.n_layers + 2 * apps
    return {**train_launches(0), "rmsnorm": TRAIN_MB * (2 * norms + 1),
            "rmsnorm_bwd": TRAIN_MB * (norms + 1),
            "flash_attention": TRAIN_MB * 2 * apps,
            "flash_attention_bwd": TRAIN_MB * apps,
            "ssd_scan": TRAIN_MB * 2 * cfg.n_layers,
            "ssd_scan_bwd": TRAIN_MB * cfg.n_layers}


def train_hybrid_phase(torch, np, report):
    from repro_torch.configs import get_config
    from repro_torch.data.lm import DataConfig, global_batch_at
    from repro_torch.kernels.common import launches, reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.model import hybrid_layout
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = get_config(HYBRID_ARCH)
    groups, per, tail = hybrid_layout(cfg)
    n = allocated_params(cfg)
    log(f"  {HYBRID_ARCH} published width and depth: {cfg.n_layers} Mamba2 "
        f"layers in {groups} groups of {per}, the shared attention+MLP "
        f"block after each group, a tail of {tail}; {n / 1e9:.3f} B "
        f"parameters x {TRAIN_STATE_B} B = {n * TRAIN_STATE_B / 1e9:.1f} GB "
        f"of state; remat={cfg.remat} (each layer), {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    step = make_train_step(cfg, adamw(lr=TRAIN_HYBRID_LR))
    opt_state = step.init_opt_state(params)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, microbatches=TRAIN_MB,
                      seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in global_batch_at(data, 0).items()}
    tokens = TRAIN_SEQ * TRAIN_BATCH
    losses, times, norms = [], [], []
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"].item()))
        norms.append(float(metrics["grad_norm"].item()))
        times.append(time.perf_counter() - t0)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(times[1:])) * 1e3
    log(f"  lr {TRAIN_HYBRID_LR:g}  losses {[round(v, 4) for v in losses]}  "
        f"grad norms {[round(v, 3) for v in norms]}")
    log(f"  step ms {[round(t * 1e3, 1) for t in times]}  (median after the "
        f"first: {step_ms:.1f} ms)  tokens/s {tokens / step_ms * 1e3:.0f}  "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches {counts}")
    expected = {k: v * TRAIN_STEPS for k, v in
                hybrid_train_launches(cfg).items()}
    report["train_hybrid"] = {
        "layers": cfg.n_layers, "lr": TRAIN_HYBRID_LR, "params": n,
        "tokens_per_step": tokens, "losses": losses, "grad_norms": norms,
        "step_s": times, "step_ms": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3, "peak_bytes": peak,
        "launches": counts}
    del params, opt_state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        fail(f"non-finite hybrid training loss {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"the hybrid loss did not fall at every step on a repeated "
             f"batch: {losses}")
    if counts != expected:
        fail(f"train_hybrid launch counts {counts}, expected {expected}")
    c = TRAIN_HYBRID_CHECK
    grad_check(torch, report, "train_hybrid_grad_check",
               dataclasses.replace(cfg, n_layers=c["layers"]), c,
               TRAIN_HYBRID_FLOOR_FACTOR,
               f"{c['layers']} layers (one group, the shared block once, a "
               f"tail of 1)")
    return counts


# ---------------------------------------------------------------------------
# phase 12d: training xlstm-1.3b, full width and depth
# ---------------------------------------------------------------------------

# constant lr, as TRAIN_LR and TRAIN_HYBRID_LR
TRAIN_SSM_LR = 1e-5
TRAIN_SSM_STEPS = TRAIN_STEPS
# the card-against-CPU gradient checks, each at 2 x 256 tokens.  8 blocks
# (one segment: 7 mLSTM blocks and its sLSTM block), as TRAIN_HYBRID_CHECK;
# its mLSTM leaves' bf16 floors read 0.25-0.37, because the gradient of the
# mLSTM's normalizer max(|q·n|, 1) jumps where a rounding moves |q·n|
# across 1, and 7 stacked blocks carry the jumps down
# (scripts_xlstm_grad_floor.py, PERF.md §6): at 2 x floor that check
# passes a wide backward whose dx lacks w∘(B G).  2 blocks (one segment
# cut to 1 mLSTM block and its sLSTM block, slstm_period 2) have floors of
# ~1e-2 on the CPU, and there the same check must reject that fault.
TRAIN_SSM_CHECK = dict(layers=8, seq=256, batch=2)
TRAIN_SSM_SHORT_CHECK = dict(layers=2, seq=256, batch=2, period=2)
# --profile's train step: one segment
TRAIN_SSM_PROFILE_LAYERS = 8
TRAIN_SSM_FLOOR_FACTOR = 2.0


def ssm_train_launches(cfg) -> dict:
    """Launches of one xlstm step at M = TRAIN_MB under the block-granular
    remat (``models/model.py:_ssm_trunk``): each mLSTM block's rmsnorm and
    wide SSD scan (its first pass and the scan) run twice (the forward, then
    again in the backward), each sLSTM block's rmsnorm once (it runs
    outside the remat); the final norm and the CE head once; every backward
    once, the wide SSD backward once an mLSTM block."""
    from repro_torch.models.model import ssm_layout
    segments, per = ssm_layout(cfg)
    mlstm = segments * per
    return {**train_launches(0), "rmsnorm": TRAIN_MB * (2 * mlstm + segments
                                                        + 1),
            "rmsnorm_bwd": TRAIN_MB * (cfg.n_layers + 1),
            "flash_attention": 0, "flash_attention_bwd": 0,
            "ssd_scan_wide": TRAIN_MB * 2 * mlstm,
            "ssd_wide_prep": TRAIN_MB * 2 * mlstm,
            "ssd_scan_bwd_wide": TRAIN_MB * mlstm}


@contextlib.contextmanager
def wide_dx_fault():
    """The wide SSD backward as the training path calls it, with dx
    without its w∘(B G) term (``chunk_local_dx``), the kernel's planted
    fault (2) in ``ssd_bwd_wide_planted_faults``."""
    import repro_torch.kernels.ssd.ops as ops
    real = ops.ssd_scan_bwd_cuda

    def faulty(c, b, x, log_a, gate, dy, ds_final=None):
        out = list(real(c, b, x, log_a, gate, dy, ds_final))
        out[2] = chunk_local_dx((c, b, x, log_a, gate), dy)
        return tuple(out)

    ops.ssd_scan_bwd_cuda = faulty
    try:
        yield
    finally:
        ops.ssd_scan_bwd_cuda = real


def train_ssm_phase(torch, np, report):
    from repro_torch.configs import get_config
    from repro_torch.data.lm import DataConfig, global_batch_at
    from repro_torch.kernels.common import launches, reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.model import ssm_layout
    from repro_torch.models.xlstm import release_scan_graphs
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = get_config(SSM_ARCH)
    segments, per = ssm_layout(cfg)
    n = allocated_params(cfg)
    log(f"  {SSM_ARCH} published width and depth: {cfg.n_layers} blocks in "
        f"{segments} segments of {per} mLSTM blocks (the wide SSD scan and "
        f"its backward at N 512, P 513) and one sLSTM block; "
        f"{n / 1e9:.3f} B parameters x {TRAIN_STATE_B} B = "
        f"{n * TRAIN_STATE_B / 1e9:.1f} GB of state; remat={cfg.remat} "
        f"(each mLSTM block), {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    step = make_train_step(cfg, adamw(lr=TRAIN_SSM_LR))
    opt_state = step.init_opt_state(params)
    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, microbatches=TRAIN_MB,
                      seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in global_batch_at(data, 0).items()}
    tokens = TRAIN_SEQ * TRAIN_BATCH
    losses, times, norms = [], [], []
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(TRAIN_SSM_STEPS):
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"].item()))
        norms.append(float(metrics["grad_norm"].item()))
        times.append(time.perf_counter() - t0)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(times[1:])) * 1e3
    log(f"  lr {TRAIN_SSM_LR:g}  losses {[round(v, 4) for v in losses]}  "
        f"grad norms {[round(v, 3) for v in norms]}")
    log(f"  step ms {[round(t * 1e3, 1) for t in times]}  (median after the "
        f"first: {step_ms:.1f} ms)  tokens/s {tokens / step_ms * 1e3:.0f}  "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches {counts}")
    expected = {k: v * TRAIN_SSM_STEPS for k, v in
                ssm_train_launches(cfg).items()}
    report["train_ssm"] = {
        "layers": cfg.n_layers, "lr": TRAIN_SSM_LR, "params": n,
        "tokens_per_step": tokens, "losses": losses, "grad_norms": norms,
        "step_s": times, "step_ms": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3, "peak_bytes": peak,
        "launches": counts}
    del params, opt_state, batch, step
    gc.collect()
    release_scan_graphs()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)):
        fail(f"non-finite ssm training loss {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"the ssm loss did not fall at every step on a repeated "
             f"batch: {losses}")
    if counts != expected:
        fail(f"train_ssm launch counts {counts}, expected {expected}")
    # the checks after the timed steps: their CPU runs go on threads of
    # their own while the card runs its side
    c, short = TRAIN_SSM_CHECK, TRAIN_SSM_SHORT_CHECK
    checks = [grad_check_start(torch, dataclasses.replace(
        cfg, n_layers=c["layers"]), c), grad_check_start(
        torch, dataclasses.replace(cfg, n_layers=short["layers"],
                                   slstm_period=short["period"]), short)]
    fault = "dx of the wide backward without w∘(B G)"
    grad_check_finish(torch, report, "train_ssm_grad_check", checks[0],
                      TRAIN_SSM_FLOOR_FACTOR,
                      f"{c['layers']} blocks (one segment: "
                      f"{c['layers'] - 1} mLSTM, 1 sLSTM)",
                      planted=(fault, wide_dx_fault, False))
    grad_check_finish(torch, report, "train_ssm_grad_check_short", checks[1],
                      TRAIN_SSM_FLOOR_FACTOR,
                      f"{short['layers']} blocks (one segment cut to 1 "
                      f"mLSTM, 1 sLSTM)", {"slstm_period": short["period"]},
                      planted=(fault, wide_dx_fault, True))
    release_scan_graphs()
    torch.cuda.empty_cache()
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
# phase 19: distributed — the LM substrate on 4 ranks sharing the card
# ---------------------------------------------------------------------------

DIST_RANKS = 4
DIST_LANES, DIST_PROMPT, DIST_CACHE, DIST_STEPS = 8, 1024, 2048, 16
# (a): qwen2's consistency bound; (b): this many times the run's own bf16
# floor for the call (the single-process run with its embedding table
# perturbed by ~1/2 ulp, fed the same tokens, against the plain one), and
# as many times the call's tie band for its tokens
DIST_QWEN_LIMIT = CONSISTENCY_LIMIT[ARCH, None]
# (a): qwen2-7b cut to 2 layers at its published width (28 layers took
# ~40-54 s of the phase over gloo on the host), the fewest that still carry
# the sequence-sharded cache and the TP decode from one layer to the next:
# each of (a)'s checks compares with one process at the same depth, and
# which cache slice a rank holds does not depend on the depth.  (b) serves
# granite at its published 32: random-init granite routes chaotically
# under EP, and cut to 2 or 8 layers it fell outside (b)'s limits on the
# H100
DIST_QWEN_LAYERS = 2
DIST_MOE_FLOOR_FACTOR = 2.0
# (b) at 2 layers, a measurement beside the check (ROADMAP.md C8): per call,
# the tokens whose top-8 sets differ between EP and one process in any
# layer, each side's capacity, and the logits of the lanes whose tokens all
# route alike held to the call's limit (2 x its floor), as the check holds
# every lane
DIST_MOE_PROBE_LAYERS = 2
# (c): 2 steps against the single-process step, then 4 with grad_compress
DIST_TRAIN_STEPS, DIST_COMPRESS_STEPS = 2, 4
# (c) and (e): qwen2 cut to 2 layers, half the train phase's 4: the parts
# are bound by gloo on the host, and at 4 layers (c) alone took 216 s of
# the script's 1200 s limit (H100 80GB HBM3, 700 W); every check of theirs
# compares with one process at the same depth
DIST_TRAIN_LAYERS = 2
DIST_LOSS_RTOL, DIST_GNORM_RTOL = 2e-3, 2e-2
DIST_CKPT_RTOL = 1e-5
# (e): Adafactor under ZeRO, qwen2 at DIST_TRAIN_LAYERS on (2, 2), tp and
# fsdp, 2 steps against the single-process step (the limits of (c)); lr
# 1e-3 is pick_optimizer's for Adafactor (an RMS-clipped step of 1e-3 moves the
# bf16 weights, where (c)'s 1e-5 would leave most of them unchanged)
DIST_ADAFACTOR_LR = 1e-3
# ... and what the optimizer computes, held directly after the 2 steps:
# rank 0's moments (whole on every rank; each leaf's rel L2 against the
# single-process ones, the worst) within DIST_MOMENT_REL_L2, where a planted
# control (each shard's own means and update RMS, the fault the part is
# there to catch; it passes the loss and grad-norm limits) must exceed it.
# On 4 CPU ranks at width 3584 in bf16 the sound worst was 1.08e-2, the
# control's 0.98.  The gathered change of these parameters is reported, not
# held: a step of 1e-3 is a few bf16 ulps of a weight, so rounding alone
# moves it 2-6 % (the control's 5-7 %, same run).
DIST_ADAFACTOR_LEAVES = (("layers", "attn", "wq"), ("layers", "attn", "wo"),
                         ("layers", "attn", "bq"), ("final_norm", "w"))
DIST_MOMENT_REL_L2 = 5e-2
# (d): vocab_parallel_ce at qwen2's vocab against the CE kernel's loss and
# the plain backward's dx
DIST_CE_TOKENS = 8192
DIST_CE_LOSS_ATOL, DIST_CE_DX_REL_L2 = 1e-4, 1e-3
DIST_TIMEOUT_S = 900


def _dist_expected(part: str) -> dict:
    """Exact launches a rank makes in each part."""
    calls = 1 + DIST_STEPS                     # prefill + decode steps
    if part == "a":                            # qwen2-7b, cut
        n = DIST_QWEN_LAYERS
        return {"rmsnorm": (2 * n + 1) * calls, "flash_attention": n,
                "decode_attention": n * DIST_STEPS}
    if part in ("b", "b2"):                    # granite, EP
        n = _dist_serve_config(MOE_ARCH, part == "b2").n_layers
        return {"rmsnorm": (2 * n + 1) * calls, "flash_attention": n,
                "decode_attention": n * DIST_STEPS, "moe_gmm": 3 * n * calls}
    if part in ("c", "e"):                     # train, 2 layers, M 2
        steps = DIST_TRAIN_STEPS + (DIST_COMPRESS_STEPS if part == "c"
                                    else 0)
        return {k: v * steps for k, v in
                train_launches(DIST_TRAIN_LAYERS).items()
                if k != "cross_entropy" and v}   # the TP loss is plain torch
    return {}


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _dist_serve_config(arch, probe: bool = False):
    """(a)'s config, qwen2 at DIST_QWEN_LAYERS, or (b)'s, granite as
    published (at DIST_MOE_PROBE_LAYERS for the C8 measurement,
    ``probe``)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == ARCH:
        return dataclasses.replace(cfg, n_layers=DIST_QWEN_LAYERS)
    return dataclasses.replace(cfg, n_layers=DIST_MOE_PROBE_LAYERS) \
        if probe else cfg


@contextlib.contextmanager
def _routes_recorded(torch, into: dict):
    """Each MoE layer call's routing while the block runs: its tokens' top-k
    expert sets (sorted, on the host) in ``into["sets"]`` and the capacity
    its dispatch used in ``into["caps"]`` (``moe.ROUTING_STATS``)."""
    from repro_torch.models import moe

    route = moe._route
    into["sets"] = []

    def recorded(params, x_flat, cfg):
        w, e = route(params, x_flat, cfg)
        into["sets"].append(e.sort(-1).values.to(torch.int16).cpu())
        return w, e

    moe._route, moe.ROUTING_STATS = recorded, []
    try:
        yield
    finally:
        into["caps"] = [st["capacity"] for st in moe.ROUTING_STATS]
        moe._route, moe.ROUTING_STATS = route, None


def _dist_route_probe(torch, got_logits, ref):
    """C8's counts for each call (prefill, then each decode step) of a run
    at DIST_MOE_PROBE_LAYERS against one process: the tokens whose top-k
    sets differ in any layer, each side's capacities, and the rel L2 of the
    lanes whose tokens all route alike, with its limit 2 x the call's
    floor."""
    n = DIST_MOE_PROBE_LAYERS
    rows = []
    for c, (got, want) in enumerate(zip(got_logits, ref["logits"])):
        mine = ref["routes_got"]["sets"][c * n:(c + 1) * n]
        theirs = ref["routes"]["sets"][c * n:(c + 1) * n]
        diff = torch.zeros(mine[0].shape[0], dtype=torch.bool)
        for a, b in zip(mine, theirs):
            diff |= (a != b).any(-1)
        lanes = diff.view(DIST_LANES, -1).any(-1)      # tokens by lane
        keep = ~lanes
        want = want.to(got.device)
        rel_eq = (_rel_l2(got[keep.to(got.device)],
                          want[keep.to(got.device)])
                  if keep.any() else None)
        limit = DIST_MOE_FLOOR_FACTOR * ref["floor"][c]
        rows.append({
            "tokens": int(diff.numel()), "tokens_differ": int(diff.sum()),
            "caps_ep": ref["routes_got"]["caps"][c * n:(c + 1) * n],
            "caps_one": ref["routes"]["caps"][c * n:(c + 1) * n],
            "lanes_alike": int(keep.sum()), "rel_l2": _rel_l2(got, want),
            "rel_l2_alike": rel_eq, "limit": limit,
            "holds": _rel_l2(got, want) <= limit,
            "alike_holds": rel_eq is None or rel_eq <= limit})
    return rows


def _dist_serve_ref(torch, np, arch, probe: bool = False):
    """Single-process prefill of 8 x 1024 seeded tokens into a 2048 cache,
    then 16 greedy decode steps: the tokens fed (prompt, then each step's
    greedy token), every call's fp32 logits, and each call's bf16 floor:
    the same calls, fed the same tokens, with the embedding table perturbed
    by ~1/2 ulp (its rel L2 and, per lane, the tie band sqrt(2) x rms of
    the change).  With ``probe`` (C8) at DIST_MOE_PROBE_LAYERS, and the
    unperturbed run's routing (``_routes_recorded``)."""
    from repro_torch.models import decode_step, init_params, prefill

    cfg = _dist_serve_config(arch, probe)
    routes: dict = {}
    record = (_routes_recorded(torch, routes) if probe
              else contextlib.nullcontext())
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (DIST_LANES, DIST_PROMPT))).cuda()
    with torch.inference_mode():
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
        t0 = time.perf_counter()
        with record:
            logits, st = prefill(params, {"tokens": prompt}, cfg, DIST_CACHE)
            fed, out = [prompt], [logits.cpu()]
            for _ in range(DIST_STEPS):
                nxt = logits.argmax(-1, keepdim=True)
                fed.append(nxt)
                logits, st = decode_step(params, st, nxt, cfg)
                out.append(logits.cpu())
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del st
        perturb_half_ulp(torch, params["embed"]["tok"])
        pert, st = prefill(params, {"tokens": prompt}, cfg, DIST_CACHE)
        perts = [pert.cpu()]
        for nxt in fed[1:]:
            pert, st = decode_step(params, st, nxt, cfg)
            perts.append(pert.cpu())
        del st
    del params
    torch.cuda.empty_cache()
    logits, perts = torch.stack(out), torch.stack(perts)
    return {"tokens": torch.cat(fed, dim=1).cpu(), "logits": logits,
            "wall_s": wall,
            "floor": [_rel_l2(p, o) for p, o in zip(perts, logits)],
            "band": 2 ** 0.5 * (perts - logits).pow(2).mean(-1).sqrt(),
            **({"routes": routes} if probe else {})}


def _dist_train_optimizer(part: str):
    """(config, optimizer) of train part (c) or (e)."""
    from repro_torch.optim import adafactor, adamw
    cfg = dataclasses.replace(train_config(), n_layers=DIST_TRAIN_LAYERS)
    return cfg, (adafactor(lr=DIST_ADAFACTOR_LR) if part == "e"
                 else adamw(lr=TRAIN_LR))


def _train_batch(torch, cfg, device):
    """The train phase's batch (2 microbatches of 4 x 2048) on ``device``."""
    from repro_torch.data.lm import DataConfig, global_batch_at
    return {k: torch.from_numpy(v).to(device) for k, v in global_batch_at(
        DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                   global_batch=TRAIN_BATCH, microbatches=TRAIN_MB, seed=0),
        0).items()}


def _dist_train_ref(torch, part: str = "c"):
    """The single-process step on the train phase's batch, 2 steps, with
    part (c)'s or (e)'s config and optimizer."""
    from repro_torch.models import init_params
    from repro_torch.train import make_train_step

    from repro_torch.optim.optimizers import tree_leaves

    cfg, opt_fn = _dist_train_optimizer(part)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    before = {k: _leaf(params, k).float().cpu() for k in
              (DIST_ADAFACTOR_LEAVES if part == "e" else ())}
    step = make_train_step(cfg, opt_fn)
    opt = step.init_opt_state(params)
    batch = _train_batch(torch, cfg, "cuda")
    losses, norms = [], []
    for _ in range(DIST_TRAIN_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "grad_norms": norms}
    if part == "e":             # the moments and the parameters' change
        out["moments"] = [t.cpu() for t in tree_leaves(opt["s"])]
        out["delta"] = {k: _leaf(params, k).float().cpu() - v
                        for k, v in before.items()}
    del params, opt, batch
    torch.cuda.empty_cache()
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rel_l2_64(a, b) -> float:
    """||a - b|| / ||b|| in float64 (the moments' squares underflow fp32)."""
    a, b = a.detach().double(), b.detach().double().to(a.device)
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def _per_shard_adafactor():
    """(e)'s planted control: Adafactor's means and update RMS over each
    rank's own shard, not the whole parameter."""
    import torch

    from repro_torch.distributed.collectives import gather_full
    from repro_torch.optim import optimizers

    def mean(x, dim, spec, shape, mesh):
        dim %= x.dim()
        return gather_full(x.mean(dim=dim),
                           [e for d, e in enumerate(spec) if d != dim], mesh,
                           [n for d, n in enumerate(shape) if d != dim])

    def rms(u, spec, shape, mesh):
        return torch.sqrt(torch.mean(u * u) + 1e-30)

    saved = optimizers._mean_whole, optimizers._rms_whole
    optimizers._mean_whole, optimizers._rms_whole = mean, rms
    try:
        yield
    finally:
        optimizers._mean_whole, optimizers._rms_whole = saved


def _dist_ce_inputs(torch, device):
    """x (T, D) bf16, w (D, V) bf16 at qwen2's width and vocab, labels and
    a valid mask with every 17th token padding: from seeds, on ``device``."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(5)
    D, V, T = cfg.d_model, cfg.vocab_padded, DIST_CE_TOKENS
    x = torch.randn(T, D, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn(D, V, generator=gen, device=device) * D ** -0.5).to(
        torch.bfloat16)
    lab = torch.randint(0, cfg.vocab, (T,), generator=gen, device=device,
                        dtype=torch.int32)
    valid = torch.arange(T, device=device) % 17 != 0
    return cfg, x, w, lab, valid


def _dist_ce_ref(torch):
    """The CE kernel's loss and the plain backward's dx."""
    from repro_torch.kernels.cross_entropy.ops import ce_forward
    from repro_torch.kernels.cross_entropy.ref import ce_backward_chunked
    cfg, x, w, lab, valid = _dist_ce_inputs(torch, "cuda")
    lse, ll = ce_forward(x, w, lab, cfg.vocab)
    vf = valid.float()
    loss = float(((lse - ll) * vf).sum() / vf.sum())
    dx, _ = ce_backward_chunked(x, w, lab, valid, lse,
                                torch.ones((), device="cuda"), cfg.vocab)
    out = {"loss": loss, "dx": dx.cpu()}
    del x, w, lse, ll, dx
    torch.cuda.empty_cache()
    return out


def _dist_part(torch, fn):
    """Run one part on this rank: launches, collective bytes, peak memory
    and wall, each read just after."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import (COLLECTIVE_BYTES,
                                                     reset_collective_bytes)
    from repro_torch.kernels.common import launches, reset_launches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_launches()
    reset_collective_bytes()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = launches()
    res["collective_bytes"] = dict(COLLECTIVE_BYTES)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    dist.barrier()
    return res


def _dist_serve(torch, arch, mesh, ref, band_factor):
    """(a) / (b): the arch's shards drawn one layer at a time, prefill and
    16 teacher-forced decode steps under the decode policy; every call's
    logits against the single-process ones, on this rank, and its token
    within ``band_factor`` x the call's tie band (plus the top's ulp).
    Where ``ref`` holds the one process's routing (C8's measurement at
    DIST_MOE_PROBE_LAYERS), this rank's routing against it, each call
    (``_dist_route_probe``)."""
    from repro_torch.distributed.context import use_context
    from repro_torch.distributed.policy import (make_policy, param_pspecs,
                                                shard_placer)
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import param_specs
    from repro_torch.optim.optimizers import tree_leaves

    probe = "routes" in ref
    cfg = _dist_serve_config(arch, probe)
    routes: dict = {}
    record = (_routes_recorded(torch, routes) if probe
              else contextlib.nullcontext())
    pol = make_policy(cfg, ShapeConfig("decode", DIST_CACHE, DIST_LANES,
                                       "decode"), mesh)
    params = init_params(
        cfg, torch.Generator(device=mesh.device).manual_seed(0),
        device=mesh.device,
        place=shard_placer(param_pspecs(param_specs(cfg), pol, cfg), mesh))
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    toks = ref["tokens"].to(mesh.device)
    s_loc = DIST_CACHE // mesh.shape["model"]
    lo = mesh.index("model") * s_loc
    rels, within, gaps, local_lens = [], [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode(), use_context(pol.context()):
        with record:
            got, st = prefill(params, {"tokens": toks[:, :DIST_PROMPT]},
                              cfg, DIST_CACHE)
            t_prefill = time.perf_counter() - t0
            outs = [got]
            for i in range(DIST_STEPS):
                lens = st["len"]
                local_lens.append(int((lens + 1 - lo).clamp(0, s_loc).min()))
                col = DIST_PROMPT + i
                got, st = decode_step(params, st, toks[:, col:col + 1], cfg)
                outs.append(got)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for got, want, band in zip(outs, ref["logits"], ref["band"]):
            want = want.to(mesh.device)
            rels.append(_rel_l2(got, want))
            pick = want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
            top = want.max(-1).values
            gap = top - pick
            # the logits are bf16 products: two a bf16 ulp apart may differ
            # by nothing before rounding, so the band adds the top's ulp
            ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
            gaps.append(float(gap.max()))
            within.append(bool((gap <= band_factor * band.to(mesh.device)
                                + ulp).all()))
        probed = (_dist_route_probe(torch, outs, {**ref, "routes_got":
                                                  routes})
                  if probe else None)
    del params, st, outs
    return {"tp": pol.tp, "ep_axis": pol.ep_axis, "weights_bytes": weights,
            **({"probe": probed} if probe else {}),
            "rel_l2": rels, "within_band": within, "max_gap": gaps,
            "min_local_length": min(local_lens), "prefill_s": t_prefill,
            "decode_s": (wall - t_prefill) / DIST_STEPS}


def _dist_train(torch, device, ref, ckpt_dir):
    """(c): qwen2 at 2 layers on (2, 2) with tp and fsdp: 2 steps against
    the single-process step; the params checkpointed on (2, 2); 4 steps with
    grad_compress on the repeated batch while rank 0 writes the checkpoint's
    files (``async_write``); then the checkpoint restored on (1, 4)."""
    import torch.distributed as dist

    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.distributed.policy import (make_policy, param_pspecs,
                                                shard_placer,
                                                tree_leaves_with_path,
                                                tree_shardings)
    from repro_torch.models import init_params
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import param_specs
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg, _ = _dist_train_optimizer("c")
    mesh = Mesh.over_world((2, 2), ("data", "model"), device)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    pol = make_policy(cfg, shape, mesh, tp=True, fsdp=True,
                      microbatches=TRAIN_MB)
    specs = param_pspecs(param_specs(cfg), pol, cfg)
    batch = _train_batch(torch, cfg, device)

    def fresh():
        return init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device, place=shard_placer(specs, mesh))

    params = fresh()
    step = make_train_step(cfg, adamw(lr=TRAIN_LR), policy=pol)
    opt = step.init_opt_state(params)
    losses, norms, times = [], [], []
    for _ in range(DIST_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    del opt

    def sums(tree, specs_of, on):
        return {p: float(gather_full(t.detach(), specs_of[p], on).double()
                         .abs().sum())
                for p, t in tree_leaves_with_path(tree)}

    flat_specs = dict(tree_leaves_with_path(param_pspecs(params, pol, cfg)))
    before = sums(params, flat_specs, mesh)
    t0 = time.perf_counter()
    saving = save_checkpoint(
        ckpt_dir, DIST_TRAIN_STEPS, params, async_write=True,
        shardings=tree_shardings(param_pspecs(params, pol, cfg), pol))
    save_s = time.perf_counter() - t0        # the gathers to rank 0
    del params

    params = fresh()
    step = make_train_step(cfg, adamw(lr=TRAIN_LR), policy=pol,
                           grad_compress=True)
    opt = step.init_opt_state(params)
    compressed = []
    for _ in range(DIST_COMPRESS_STEPS):
        params, opt, m = step(params, opt, batch)
        compressed.append(float(m["loss"]))
    del params, opt
    t0 = time.perf_counter()
    saving.wait()                            # rank 0's files; a barrier
    wait_s = time.perf_counter() - t0
    mesh14 = Mesh.over_world((1, 4), ("data", "model"), device)
    pol14 = make_policy(cfg, shape, mesh14, tp=True, fsdp=True,
                        microbatches=TRAIN_MB)
    specs14 = param_pspecs(param_specs(cfg), pol14, cfg)
    t0 = time.perf_counter()
    restored, _ = load_checkpoint(ckpt_dir, DIST_TRAIN_STEPS,
                                  param_specs(cfg),
                                  shardings=tree_shardings(specs14, pol14))
    load_s = time.perf_counter() - t0
    after = sums(restored, dict(tree_leaves_with_path(specs14)), mesh14)
    ckpt_rel = max(abs(after[p] - before[p]) / max(before[p], 1e-30)
                   for p in before)
    del restored
    dist.barrier()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(norms,
                                                       ref["grad_norms"]))
    return {"losses": losses, "grad_norms": norms, "step_s": times,
            "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
            "ckpt_leaves": len(before), "ckpt_sum_rel": ckpt_rel,
            "ckpt_save_s": save_s, "ckpt_wait_s": wait_s,
            "ckpt_load_s": load_s,
            "compressed_losses": compressed}


def _dist_adafactor(torch, device, ref, planted=False):
    """(e): Adafactor under ZeRO, qwen2 at 2 layers on (2, 2) with tp and
    fsdp: 2 steps against the single-process step, their loss and grad
    norm, then rank 0's moments and the gathered change of
    ``DIST_ADAFACTOR_LEAVES``.  The state lies as ``param_pspecs`` places
    Adafactor's tree (every moment whole on every rank); its row and column
    means are summed across the shards.  ``planted``: the per-shard
    control."""
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.collectives import gather_full
    from repro_torch.distributed.policy import (make_policy, param_pspecs,
                                                shard_placer,
                                                tree_leaves_with_path)
    from repro_torch.models import init_params
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import param_specs
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import make_train_step

    cfg, opt_fn = _dist_train_optimizer("e")
    mesh = Mesh.over_world((2, 2), ("data", "model"), device)
    pol = make_policy(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), mesh, tp=True, fsdp=True,
                      microbatches=TRAIN_MB)
    shapes = param_specs(cfg)
    specs = param_pspecs(shapes, pol, cfg)
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device,
        place=shard_placer(specs, mesh))

    def whole(k):
        return gather_full(_leaf(params, k), _leaf(specs, k), mesh,
                           tuple(_leaf(shapes, k).shape)).float()

    before = {k: whole(k).clone() for k in DIST_ADAFACTOR_LEAVES}
    step = make_train_step(cfg, opt_fn, policy=pol)
    opt = step.init_opt_state(params)
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(opt["s"]))
    batch = _train_batch(torch, cfg, device)
    losses, norms, times = [], [], []
    with _per_shard_adafactor() if planted else contextlib.nullcontext():
        for _ in range(DIST_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append(time.perf_counter() - t0)
    moment_rel = {path: _rel_l2_64(t, r) for (path, t), r in
                  zip(tree_leaves_with_path(opt["s"]), ref["moments"])}
    delta_rel = {"/".join(k): _rel_l2_64(whole(k) - before[k],
                                         ref["delta"][k])
                 for k in DIST_ADAFACTOR_LEAVES}
    del params, opt, batch, before
    return {"losses": losses, "grad_norms": norms, "step_s": times,
            "state_bytes": state_bytes,
            "loss_rel": max(abs(a - b) / abs(b) for a, b in
                            zip(losses, ref["losses"])),
            "grad_norm_rel": max(abs(a - b) / abs(b) for a, b in
                                 zip(norms, ref["grad_norms"])),
            "moment_rel_l2": max(moment_rel.values()),
            "worst_moment": max(moment_rel, key=moment_rel.get),
            "moments_rel_l2": moment_rel, "delta_rel_l2": delta_rel}


def _dist_ce(torch, mesh, ref):
    """(d): vocab_parallel_ce at qwen2's vocab over 4 model ranks."""
    from repro_torch.distributed.collectives import local_shard
    from repro_torch.distributed.context import ShardingContext, use_context
    from repro_torch.distributed.vocab_ce import vocab_parallel_ce
    cfg, x, w, lab, valid = _dist_ce_inputs(torch, mesh.device)
    w = local_shard(w, (None, "model"), mesh).clone()
    torch.cuda.empty_cache()
    x.requires_grad_(True)
    with use_context(ShardingContext(mesh=mesh, rules={})):
        loss = vocab_parallel_ce(x, w, lab, valid, n_valid=cfg.vocab,
                                 vocab_size=cfg.vocab_padded)
        (dx,) = torch.autograd.grad(loss, x)
    want = ref["dx"].to(mesh.device)
    loss = float(loss.detach())
    return {"loss": loss, "loss_err": abs(loss - ref["loss"]),
            "dx_rel_l2": _rel_l2(dx, want),
            "dx_max_abs_err": float((dx.float() - want.float()).abs().max())}


def distributed_rank(rank, world, device, ref_path, ckpt_dir):
    """One rank of the distributed phase (spawned; gloo on the one card):
    parts (a)-(e) and (e)'s planted control, each with its own mesh over
    the same 4 ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import Mesh
    if device.type != "cuda":
        raise RuntimeError(f"rank {rank} is on {device}, not the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(ref_path, weights_only=False)
    mesh = Mesh.over_world((1, DIST_RANKS), ("data", "model"), device)
    out = {"device": str(device), "backend": dist.get_backend()}
    parts = {"a": lambda: _dist_serve(torch, ARCH, mesh, ref["a"], 1.0),
             "b": lambda: _dist_serve(torch, MOE_ARCH, mesh, ref["b"],
                                      DIST_MOE_FLOOR_FACTOR),
             "b2": lambda: _dist_serve(torch, MOE_ARCH, mesh, ref["b2"],
                                       DIST_MOE_FLOOR_FACTOR),
             "c": lambda: _dist_train(torch, device, ref["c"], ckpt_dir),
             "d": lambda: _dist_ce(torch, mesh, ref["d"]),
             "e": lambda: _dist_adafactor(torch, device, ref["e"]),
             "e planted": lambda: _dist_adafactor(torch, device, ref["e"],
                                                  planted=True)}
    for part, fn in parts.items():
        out[part] = _dist_part(torch, fn)
        if rank == 0:             # as it goes; the verdicts come at the end
            log(f"  rank 0 ({part}) done in {out[part]['wall_s']:.1f} s: " +
                ", ".join(f"{k} {v}" for k, v in out[part].items()
                          if k not in ("launches", "wall_s", "probe")))
    out["loaded"] = sorted(m for m in ("jax", "repro") if m in sys.modules)
    return out


def distributed_phase(torch, np, report):
    """Single-process references first, then one spawn of 4 ranks on the
    card over gloo; every rank's checks, launches, bytes and peaks."""
    from repro_torch.distributed import spawn
    from repro_torch.kernels.common import LAUNCHES

    t0 = time.perf_counter()
    ref = {"a": _dist_serve_ref(torch, np, ARCH),
           "b": _dist_serve_ref(torch, np, MOE_ARCH),
           "b2": _dist_serve_ref(torch, np, MOE_ARCH, probe=True),
           "c": _dist_train_ref(torch), "d": _dist_ce_ref(torch),
           "e": _dist_train_ref(torch, "e")}
    ref_s = time.perf_counter() - t0
    limits = {"a": [DIST_QWEN_LIMIT] * (DIST_STEPS + 1),
              "b": [DIST_MOE_FLOOR_FACTOR * f for f in ref["b"]["floor"]]}
    log(f"  single-process references in {ref_s:.1f} s: qwen2 prefill + "
        f"{DIST_STEPS} steps {ref['a']['wall_s']:.2f} s (bf16 floor, each "
        f"call: {min(ref['a']['floor']):.4e} to "
        f"{max(ref['a']['floor']):.4e}), granite {ref['b']['wall_s']:.2f} s "
        f"(floor {min(ref['b']['floor']):.4e} to "
        f"{max(ref['b']['floor']):.4e}; the limit {DIST_MOE_FLOOR_FACTOR:g} "
        f"x each call's), train losses {ref['c']['losses']} grad norms "
        f"{[round(v, 4) for v in ref['c']['grad_norms']]}, CE loss "
        f"{ref['d']['loss']:.6f}, Adafactor losses {ref['e']['losses']} "
        f"grad norms {[round(v, 4) for v in ref['e']['grad_norms']]}")
    OUT.mkdir(exist_ok=True)
    ref_path = ROOT / "build" / "distributed_ref.pt"
    ckpt_dir = ROOT / "build" / "distributed_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ref_path.parent.mkdir(exist_ok=True)
    torch.save(ref, ref_path)
    del ref["d"]["dx"]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB on the card ({torch.cuda.memory_reserved() / 2**30:.2f} "
        f"reserved) as the ranks start")
    # the ranks' allocators: 4 processes share 80 GB, so return freed
    # segments to the pool instead of keeping each size's blocks
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t0 = time.perf_counter()
    ranks = spawn(distributed_rank, DIST_RANKS, (str(ref_path),
                                                 str(ckpt_dir)),
                  device_type="cuda", timeout=DIST_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ref_path.unlink()
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    problems = []
    names = {"a": ARCH, "b": MOE_ARCH,
             "b2": f"{MOE_ARCH} at {DIST_MOE_PROBE_LAYERS} layers (C8)",
             "c": "train", "d": "vocab CE",
             "e": "train Adafactor", "e planted": "its planted control"}
    total = {k: 0 for k in LAUNCHES}
    for r, res in enumerate(ranks):
        if res["loaded"]:
            problems.append(f"rank {r} loaded {res['loaded']}")
        for part in names:
            got = res[part]["launches"]
            want = {k: _dist_expected(part.split()[0]).get(k, 0)
                    for k in got}
            for k, v in got.items():    # the control is not the path
                total[k] += v if part != "e planted" else 0
            if got != want:
                problems.append(f"rank {r} part ({part}) {names[part]} "
                                f"launches {got}, expected {want}")
    log(f"  4 ranks on {ranks[0]['device']} over {ranks[0]['backend']} "
        f"(NCCL refuses two ranks on one device); spawn + parts "
        f"{spawn_s:.1f} s")
    for part, arch in (("a", ARCH), ("b", MOE_ARCH)):
        res = [r[part] for r in ranks]
        worst = max(max(x["rel_l2"]) for x in res)
        over = [i for x in res for i, (v, lim) in
                enumerate(zip(x["rel_l2"], limits[part])) if v > lim]
        limit = max(limits[part])
        within = all(all(x["within_band"]) for x in res)
        zero = [x["min_local_length"] for x in res]
        log(f"  ({part}) {arch}: tp {res[0]['tp']} ep {res[0]['ep_axis']}; "
            f"weights a rank {res[0]['weights_bytes'] / 2**30:.2f} GiB; "
            f"prefill {res[0]['prefill_s']:.2f} s, decode "
            f"{res[0]['decode_s'] * 1e3:.1f} ms a step; logits' rel L2 "
            f"against one process, worst of {DIST_STEPS + 1} calls and 4 "
            f"ranks {worst:.4e} (limit {limit:.4e}{' at most' if part == 'b' else ''}; "
            f"calls over their limit {sorted(set(over))}); tokens within the "
            f"tie band {within} (largest gap {max(max(x['max_gap']) for x in res):.4g}); "
            f"least local length a rank saw {zero}")
        if over or not within:
            problems.append(f"({part}) {arch}: rel L2 over the limit at "
                            f"calls {sorted(set(over))}, within band "
                            f"{within}")
        if min(zero) != 0:
            problems.append(f"({part}) no rank saw a local length 0: {zero}")
    # C8's measurement (reported, no verdict): rank 0's routing at 2 layers
    probe = ranks[0]["b2"]["probe"]
    log(f"  (b) at {DIST_MOE_PROBE_LAYERS} layers (C8, measured): per call, "
        f"tokens whose top-k sets differ from one process in any layer, "
        f"capacities EP / one process, lanes "
        f"whose tokens all route alike and their rel L2 (the call's limit):")
    for c_i, row in enumerate(probe):
        alike = ("-" if row["rel_l2_alike"] is None
                 else f"{row['rel_l2_alike']:.4e}")
        log(f"    call {c_i:2d}: {row['tokens_differ']} of {row['tokens']} "
            f"tokens differ; capacity {row['caps_ep']} / {row['caps_one']}; "
            f"{row['lanes_alike']} lanes alike, rel L2 {alike}; all lanes "
            f"{row['rel_l2']:.4e} (limit {row['limit']:.4e}): "
            f"{'holds' if row['holds'] else 'over'}")
    report["distributed_c8"] = probe
    c = [r["c"] for r in ranks]
    log(f"  (c) train (2, 2) tp fsdp: losses {c[0]['losses']} against "
        f"{ref['c']['losses']} (rel {c[0]['loss_rel']:.3e}, limit "
        f"{DIST_LOSS_RTOL:g}); grad norms {[round(v, 4) for v in c[0]['grad_norms']]} "
        f"(rel {c[0]['grad_norm_rel']:.3e}, limit {DIST_GNORM_RTOL:g}); "
        f"step s {[round(v, 2) for v in c[0]['step_s']]}; checkpoint of "
        f"{c[0]['ckpt_leaves']} leaves gathered on (2, 2) in "
        f"{c[0]['ckpt_save_s']:.1f} s (rank 0's write beside the "
        f"grad_compress steps, then waited {c[0]['ckpt_wait_s']:.1f} s), "
        f"restored on (1, 4) in "
        f"{c[0]['ckpt_load_s']:.1f} s, leaf sums' worst rel "
        f"{max(x['ckpt_sum_rel'] for x in c):.2e}; grad_compress losses "
        f"{[round(v, 5) for v in c[0]['compressed_losses']]}")
    if c[0]["loss_rel"] > DIST_LOSS_RTOL or \
            c[0]["grad_norm_rel"] > DIST_GNORM_RTOL:
        problems.append("(c) the sharded step disagrees with one process")
    if max(x["ckpt_sum_rel"] for x in c) > DIST_CKPT_RTOL:
        problems.append("(c) the restore on (1, 4) changed the parameters")
    cl = c[0]["compressed_losses"]
    if not all(b < a for a, b in zip(cl, cl[1:])):
        problems.append(f"(c) the loss did not fall with grad_compress: {cl}")
    d = [r["d"] for r in ranks]
    log(f"  (d) vocab_parallel_ce at {ARCH}'s width and vocab, T "
        f"{DIST_CE_TOKENS}, over 4 ranks: "
        f"loss {d[0]['loss']:.6f} (err {max(x['loss_err'] for x in d):.2e}, "
        f"limit {DIST_CE_LOSS_ATOL:g}); dx rel L2 "
        f"{max(x['dx_rel_l2'] for x in d):.2e} (limit {DIST_CE_DX_REL_L2:g}), "
        f"max abs err {max(x['dx_max_abs_err'] for x in d):.3g}")
    if max(x["loss_err"] for x in d) > DIST_CE_LOSS_ATOL or \
            max(x["dx_rel_l2"] for x in d) > DIST_CE_DX_REL_L2:
        problems.append("(d) vocab_parallel_ce disagrees with the CE kernel")
    e = [r["e"] for r in ranks]
    log(f"  (e) train (2, 2) tp fsdp, Adafactor under ZeRO, "
        f"{DIST_TRAIN_LAYERS} layers, lr {DIST_ADAFACTOR_LR:g}: losses "
        f"{e[0]['losses']} against {ref['e']['losses']} (rel "
        f"{e[0]['loss_rel']:.3e}, limit {DIST_LOSS_RTOL:g}); grad norms "
        f"{[round(v, 4) for v in e[0]['grad_norms']]} (rel "
        f"{e[0]['grad_norm_rel']:.3e}, limit {DIST_GNORM_RTOL:g}); step s "
        f"{[round(v, 2) for v in e[0]['step_s']]}; Adafactor state a rank "
        f"{e[0]['state_bytes'] / 2**20:.2f} MiB (whole on every rank)")
    if e[0]["loss_rel"] > DIST_LOSS_RTOL or \
            e[0]["grad_norm_rel"] > DIST_GNORM_RTOL:
        problems.append("(e) the sharded Adafactor step disagrees with one "
                        "process")
    planted = ranks[0]["e planted"]
    for tag, x in (("sound", e[0]), ("planted", planted)):
        log(f"  (e) {tag}: rank 0's {len(x['moments_rel_l2'])} moments, "
            f"worst rel L2 {x['moment_rel_l2']:.3e} ({x['worst_moment']}; "
            f"limit {DIST_MOMENT_REL_L2:g}); the gathered change after "
            f"{DIST_TRAIN_STEPS} steps (reported), rel L2 "
            + ", ".join(f"{k} {v:.3e}" for k, v in x["delta_rel_l2"].items())
            + f"; loss rel {x['loss_rel']:.3e}, grad norm rel "
            f"{x['grad_norm_rel']:.3e}")
    if e[0]["moment_rel_l2"] > DIST_MOMENT_REL_L2:
        problems.append("(e) the sharded Adafactor's moments disagree with "
                        "one process")
    if not planted["moment_rel_l2"] > DIST_MOMENT_REL_L2:
        problems.append("(e) the planted per-shard Adafactor's moments pass "
                        "the limit: the check cannot see the fault")
    for part in names:
        walls = [round(r[part]["wall_s"], 1) for r in ranks]
        peaks = [round(r[part]["peak_bytes"] / 2**30, 2) for r in ranks]
        sent = {k: round(v / 1e6, 1)
                for k, v in ranks[0][part]["collective_bytes"].items()}
        log(f"  ({part}) per rank: wall {walls} s, peak memory {peaks} GiB; "
            f"rank 0 sent MB {sent} (copied through host memory by the "
            f"port: 0 — gloo takes every collective here on CUDA tensors)")
    report["distributed"] = {"reference_s": ref_s, "spawn_s": spawn_s,
                             "limits": limits,
                             "floors": {"a": ref["a"]["floor"],
                                        "b": ref["b"]["floor"]},
                             "ranks": ranks}
    if problems:
        fail("distributed: " + "; ".join(problems))
    return total


# ---------------------------------------------------------------------------
# phase 20: the multi-pod dry run, and its count held against the card
# ---------------------------------------------------------------------------

# (a): these cells of ``python -m repro_torch.launch.dryrun`` on the 16x16
# mesh, one subprocess each.  zamba2's and xlstm's train_4k are left out
# for time: their recurrences are Python loops over 4096 tokens x 8
# microbatches a layer, which the pass counts op by op (tens of minutes
# each on one core; PERF.md has their CPU runs).
DRYRUN_CELLS = tuple((a, s) for a in (ARCH, MOE_ARCH, HYBRID_ARCH, SSM_ARCH,
                                      LLAMA_ARCH)
                     for s in ("train_4k", "decode_32k")
                     if not (a in (HYBRID_ARCH, SSM_ARCH) and s == "train_4k"))
# The dry run counts op by op on the host's CPU: llama3-405b's train_4k (16
# microbatches of 126 layers, ~2.3 M ops) takes 570-670 s on an H100
# machine's host, (b)'s counts ~200 s: after the card's phases they would
# take the run past its time limit.  So they start once the last phase
# whose time (b) reads (serve_vlm) is done, at the lowest CPU priority,
# with the card hidden from them, and count while the later phases run
# (tabular to distributed: their times are taken beside the counts), in
# two lanes: llama3-405b's train_4k; the other cells, then (b)'s counts.
# Each process reads its own launch counts.  The phase collects.
DRYRUN_LONG = (LLAMA_ARCH, "train_4k")
DRYRUN_AFTER = "serve_vlm"        # the lanes start after this phase
DRYRUN_TIMEOUT_S = 950            # from the lanes' start
# (b): the served models as their serve phases ran them (key, arch, layers)
DRYRUN_SERVED = (("serve", ARCH, None), ("serve " + HYBRID_ARCH,
                                         HYBRID_ARCH, None),
                 ("serve " + MOE_ARCH, MOE_ARCH, None),
                 ("serve " + SSM_ARCH, SSM_ARCH, None),
                 ("serve " + STARCODER_ARCH, STARCODER_ARCH, None),
                 ("serve " + NEMOTRON_ARCH, NEMOTRON_ARCH, NEMOTRON_LAYERS),
                 ("serve " + AUDIO_ARCH, AUDIO_ARCH, None),
                 ("serve " + VLM_ARCH, VLM_ARCH, VLM_LAYERS))


def _one_device_bound(cfg, shape, flops, microbatches=1,
                      lengths=(None,)) -> tuple:
    """(bound s, the term that sets it) of one step on one H100 from its
    datasheet peaks: the count's FLOPs, and ``analytic_memory_bytes`` under
    a one-device policy, averaged over the decode cache ``lengths`` (each
    a step's cache length; None: the shape's own).

    The analytic weight term of a serving step reads every parameter once,
    the input embedding table too, where the step gathers only its tokens'
    rows: the rows no token can select (vocab less the step's tokens) are
    taken off, so the bound counts what this step's data needs.  (At 4
    layers nemotron's table is 20 % of its weights; uncorrected, its decode
    bound sat 0.5 % under the measured time.)"""
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.policy import make_policy
    from repro_torch.launch.analysis import Roofline, analytic_memory_bytes

    one = Mesh(shape={"data": 1, "model": 1})
    unread = 0.0
    if shape.kind != "train" and cfg.frontend == "none" and \
            not cfg.tie_embeddings:         # else the head reads it all
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind == "prefill" else 1)
        unread = 2.0 * cfg.d_model * max(0, cfg.vocab - tokens)   # bf16
    roofs = []
    for n in lengths:
        sh = shape if n is None else dataclasses.replace(shape, seq_len=n)
        pol = make_policy(cfg, sh, one, microbatches=microbatches)
        roofs.append(Roofline(
            flops, analytic_memory_bytes(cfg, sh, pol) - unread, 0.0, 1))
    bound = sum(r.step_time_s for r in roofs) / len(roofs)
    return bound, roofs[-1].dominant


def _held_cases() -> list:
    """(b)'s cases: (the phase's report key, kind, what, config, shape,
    the count's keywords, decode cache lengths) for the train phase's step
    and each served model's prefill wave and decode step.  The plain decode
    attends the whole cache buffer (the FLOPs); the bytes are taken at each
    step's cache length, prompt + 1 to prompt + max_new."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeConfig

    t = SERVE_TRAFFIC
    lanes, S = t["n_lanes"], t["prompt_len"]
    cfg = train_config()
    cases = [("train", "train", f"train step {ARCH} {cfg.n_layers} layers, "
              f"{TRAIN_BATCH}x{TRAIN_SEQ} in {TRAIN_MB}", cfg,
              ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
              {"microbatches": TRAIN_MB}, (None,))]
    for key, arch, layers in DRYRUN_SERVED:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cases.append((key, "prefill", f"prefill wave {arch} {cfg.n_layers} "
                      f"layers, {lanes}x{S}", cfg,
                      ShapeConfig("prefill_wave", S, lanes, "prefill"),
                      {"max_len": t["max_len"]}, (None,)))
        cases.append((key, "decode", f"decode step {arch} {cfg.n_layers} "
                      f"layers, B {lanes}, cache {S + 1}-{S + t['max_new']}",
                      cfg, ShapeConfig("decode_step", t["max_len"], lanes,
                                       "decode"), {},
                      range(S + 1, S + t["max_new"] + 1)))
    return cases


def held_counts(path: str) -> None:
    """(b)'s counts (a lane's subprocess, without the card): each case's
    one-device step on fake tensors through the counting pass; its FLOPs,
    the count's wall and the kernel launches this process made during it,
    to ``path`` as JSON."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.common import launches
    from repro_torch.launch.dryrun import fake_step
    from repro_torch.launch.hlo_cost import analyze
    out = []
    for _key, _kind, what, cfg, shape, kw, _lengths in _held_cases():
        before = launches()
        with FakeTensorMode():
            step, args, _ = fake_step(cfg, shape, **kw)
            cost = analyze(step, *args)
        out.append({"what": what, "flops": cost.flops,
                    "count_s": cost.wall_s,
                    "launches": {k: n - before[k]
                                 for k, n in launches().items()}})
        del step, args, cost
    Path(path).write_text(json.dumps(out))


def _held_rows(counts: list, report: dict, card: str) -> list:
    """(b): each case whose phase ran in this call, its bound on one H100
    against the time that phase measured."""
    rows = []
    for (key, kind, what, cfg, shape, kw, lengths), c in zip(_held_cases(),
                                                             counts):
        rep = report.get(key)
        if rep is None:
            continue
        ms = (rep["step_ms"] if kind == "train" else
              min(rep["prefill_s"]) * 1e3 if kind == "prefill" else
              rep["decode_s"] / rep["decode_steps"] * 1e3)
        bound, by = _one_device_bound(cfg, shape, c["flops"],
                                      kw.get("microbatches", 1), lengths)
        rows.append({"what": what, "flops": c["flops"],
                     "count_s": c["count_s"], "ms": ms,
                     "bound_ms": bound * 1e3, "bound_by": by,
                     "ratio": ms / (bound * 1e3)})
    for r in rows:
        log(f"  (b) {r['what']}: measured {r['ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}; {r['flops']:.4g} "
            f"FLOP counted in {r['count_s']:.1f} s), ratio "
            f"{r['ratio']:.3f} ({card})")
    if not rows:
        log("  (b) no train or serve phase ran in this call: nothing to "
            "hold the count against")
    return rows


def start_dryrun() -> dict:
    """Start the dry run's two lanes (threads, each running its
    subprocesses one after the other at the lowest CPU priority, the card
    hidden: CUDA_VISIBLE_DEVICES empty, the dry run needs none).  Every
    subprocess is killed at exit if it still runs."""
    import atexit
    import threading
    out_dir = OUT / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    nice = ["nice", "-n", "19"] if shutil.which("nice") else []

    def cli(arch, shape):
        return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--mesh", "single", "--out",
                str(out_dir / f"{arch}.{shape}.jsonl")]

    lanes = [[(DRYRUN_LONG, cli(*DRYRUN_LONG))],
             [(c, cli(*c)) for c in DRYRUN_CELLS if c != DRYRUN_LONG]
             + [("held", [sys.executable, "-c", "import sys, chip_smoke; "
                          "chip_smoke.held_counts(sys.argv[1])",
                          str(out_dir / "held.json")])]]
    state = {"procs": [], "done": {}, "stop": False,
             "t0": time.perf_counter(), "out_dir": out_dir}

    def run(lane):
        for tag, cmd in lane:
            if state["stop"]:
                return
            name = tag if isinstance(tag, str) else ".".join(tag)
            t0 = time.perf_counter()
            with open(out_dir / f"{name}.log", "w") as f:
                proc = subprocess.Popen(nice + cmd, env=env, stdout=f,
                                        stderr=subprocess.STDOUT, cwd=ROOT)
                state["procs"].append(proc)
                rc = proc.wait()
            state["done"][tag] = (rc, time.perf_counter() - t0)

    def kill():
        state["stop"] = True
        for proc in state["procs"]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    state["kill"] = kill
    atexit.register(kill)
    state["threads"] = [threading.Thread(target=run, args=(lane,),
                                         daemon=True) for lane in lanes]
    for t in state["threads"]:
        t.start()
    return state


def _dryrun_record(state, cell, problems: list):
    """The cell's record, or None with a problem."""
    arch, shape = cell
    rc, wall = state["done"].get(cell, (None, None))
    path = state["out_dir"] / f"{arch}.{shape}.jsonl"
    recs = [json.loads(line) for line in path.read_text().splitlines()] \
        if path.exists() else []
    if rc != 0 or len(recs) != 1 or recs[0]["status"] != "ok":
        log_path = state["out_dir"] / f"{arch}.{shape}.log"
        tail = log_path.read_text()[-1500:] if log_path.exists() else ""
        problems.append(f"(a) {arch} {shape}: rc {rc}, records "
                        f"{[r.get('status') for r in recs]}: {tail}")
        return None
    return {**recs[0], "cli_wall_s": wall}


def dryrun_phase(torch, np, report, state):
    """(a) the dry-run CLI's records from the lanes ``start_dryrun``
    began after ``DRYRUN_AFTER``, every one ``ok``; (b) the count held
    against the card's measured phases: every ratio of measured time to
    bound >= 1.  No kernel launches: each counting process's own counts,
    summed, are the path's."""
    from repro_torch.kernels.common import LAUNCHES

    card = report.get("card", "")
    t0 = time.perf_counter()
    for t in state["threads"]:
        t.join(timeout=max(1.0, state["t0"] + DRYRUN_TIMEOUT_S
                           - time.perf_counter()))
    wait_s = time.perf_counter() - t0
    problems = []
    if any(t.is_alive() for t in state["threads"]):
        state["kill"]()
        problems.append(f"the dry run was not done within "
                        f"{DRYRUN_TIMEOUT_S} s of its start; done: "
                        f"{sorted(map(str, state['done']))}")
    records = [r for r in (_dryrun_record(state, c, problems)
                           for c in DRYRUN_CELLS) if r is not None]
    held_path = state["out_dir"] / "held.json"
    counted = json.loads(held_path.read_text()) if held_path.exists() else []
    held = _held_rows(counted, report, card)
    if not held_path.exists():
        problems.append("(b) no counts: "
                        + (state["out_dir"] / "held.log").read_text()[-1500:])
    for r in records:
        log(f"  (a) {r['arch']} x {r['shape']} x {r['mesh']}: dominant "
            f"{r['dominant']}, step_time_s {r['step_time_s']:.4g} (compute "
            f"{r['compute_s']:.4g}, memory {r['memory_s']:.4g}, collective "
            f"{r['collective_s']:.4g}); {r['flops']:.4g} FLOP a device, "
            f"{r['n_ops']} ops counted in {r['count_wall_s']} s (the "
            f"subprocess {r['cli_wall_s']:.1f} s); microbatches "
            f"{r['policy']['microbatches']}")
    counts = {k: 0 for k in LAUNCHES}
    for got in [r["kernel_launches"] for r in records] + \
            [c["launches"] for c in counted]:
        for k, n in got.items():
            counts[k] += n
    log(f"  (a) {len(records)} of {len(DRYRUN_CELLS)} records ok; the "
        f"lanes ran {time.perf_counter() - state['t0']:.1f} s from "
        f"{DRYRUN_AFTER}'s end, this phase waited {wait_s:.1f} s for them; "
        f"left out for time: {HYBRID_ARCH} and {SSM_ARCH} train_4k; kernel "
        f"launches, summed over the {len(records) + len(counted)} counts "
        f"(each read in the process that counted) {counts}")
    report["dryrun"] = {"records": records, "held": held, "wait_s": wait_s,
                        "lanes": {str(k): v for k, v in
                                  state["done"].items()}}
    low = [r for r in held if not r["ratio"] >= 1.0]
    if low:
        problems.append("(b) measured time under the count's bound (the "
                        "count is at fault): " + "; ".join(
                            f"{r['what']} {r['ratio']:.3f}" for r in low))
    if any(counts.values()):
        problems.append(f"kernel launches in the dry run: {counts}")
    if problems:
        fail("dryrun: " + "; ".join(problems))
    return counts


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


SERVICE_ROWS = AGENTIC_ROWS
SERVICE_BUDGET = 16 << 30
SERVICE_THREADS = 8
SERVICE_AGENTS = 4
SERVICE_ROUNDS = 3
SERVICE_PROBE_ROWS = 20_000
# compiled against per-op and service against local: the agentic phase's
# limit
SERVICE_RTOL = TABULAR_TIER_RTOL
# the reference's four-tenant split of iteration 1 (repro's service on the
# CPU, 16 GiB, 8 threads, coalesce_window_s 0.05; the same at 2,000 and
# 200,000 rows): one super-batch, 135 executions deduped, and each job
# (coalesced_with, ops_shared_cross_agent, cache_hits, per_backend) with
# "jax" read as "torch"
SERVICE_SPLIT = (1, 135, (3, 45, 0, {"torch": 35, "torch-seg": 16,
                                     "python": 14}))


def service_config(cache_dir, **kw):
    """The client's defaults (compiled segments, 2 executors) on the card,
    16 GiB, 8 threads, inductor's cache in ``cache_dir``."""
    from repro_torch.client import StratumConfig

    kw.setdefault("memory_budget_bytes", SERVICE_BUDGET)
    return StratumConfig.make(hardware_threads=SERVICE_THREADS,
                              jit_cache_dir=cache_dir, **kw)


def _split_batches(rows):
    """Iteration 1 split by model: tenant i submits the two pipelines of
    MODELS[i], one for each preprocessing."""
    from repro_torch.agents.aide import MODELS, PREPROCS, PipelineSpec
    from repro_torch.core import PipelineBatch

    out = []
    for model in MODELS:
        specs = [PipelineSpec(preproc=p, model=model, cv_k=3, n_rows=rows,
                              seed=7) for p in PREPROCS]
        out.append(PipelineBatch([s.build() for s in specs],
                                 [f"{s.preproc}+{s.model}" for s in specs]))
    return out


def _worst_rel(got: dict, want: dict) -> float:
    return max(abs(got[k] - want[k]) / abs(want[k]) for k in want)


def _uncompilable(svc, label, problems):
    unc = svc.plan_cache.snapshot()["uncompilable"]
    if unc:
        problems.append(f"{label}: {unc} uncompilable segment(s)")


def service_phase(torch, np, report):
    import tempfile

    from repro_torch.data import tabular as data
    from repro_torch.kernels.common import launches, reset_launches

    card = report.get("card", "")
    t_phase = time.perf_counter()
    data.ensure_files("uk_housing", SERVICE_ROWS, 0)
    cache_dir = tempfile.mkdtemp(prefix="inductor-")
    out = report["service"] = {"rows": SERVICE_ROWS, "card": card}
    problems: list = []
    reset_launches()
    try:
        _service_checks(torch, np, out, problems, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    counts = launches()
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {counts}; phase {out['phase_s']:.1f} s ({card})")
    if any(counts.values()):
        problems.append(f"a hand kernel launched on the service path: "
                        f"{counts}")
    if problems:
        fail("service: " + "; ".join(problems))
    return counts


def _service_checks(torch, np, out, problems, cache_dir):
    """Checks (a)-(d) of the service phase; each failure is appended to
    ``problems``."""
    from repro_torch.client import connect

    # the port's local target at the client's defaults: each tenant's
    # batch alone, the agents' best specs, the unpreempted sweep
    local = connect("local", service_config(cache_dir))
    try:
        alone = _service_split(torch, np, out, problems, cache_dir, local)
        _service_search(torch, np, out, problems, cache_dir, local)
        _service_preempt(torch, np, out, problems, cache_dir, alone)
        _service_isolation(torch, np, out, problems, cache_dir, local)
    finally:
        local.close()


def _service_split(torch, np, out, problems, cache_dir, local):
    """(a) four tenants, iteration 1 split by model, queued before
    start(): one super-batch with the reference's sharing and counts, and
    each tenant's scores its batch's alone on the local target."""
    from repro_torch.service import StratumService

    card = out["card"]
    batches = _split_batches(SERVICE_ROWS)
    svc = StratumService(config=service_config(
        cache_dir, coalesce_window_s=0.05).service_config(),
        autostart=False)
    try:
        futs = [svc.session(f"agent-{i}").submit(b)
                for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        svc.start()
        done = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        g = svc.telemetry.global_snapshot()
        _uncompilable(svc, "split", problems)
        gate = svc.mem_inflight_peak
    finally:
        svc.stop()
    jobs = [(r.coalesced_with, r.ops_shared_cross_agent, r.cache_hits,
             dict(r.per_backend)) for _, r in done]
    got = (g["super_batches"], g["ops_deduped_cross_agent"], jobs)
    want = (SERVICE_SPLIT[0], SERVICE_SPLIT[1], [SERVICE_SPLIT[2]] * 4)
    scores = [{k: float(v) for k, v in res.items()} for res, _ in done]
    alone, t_alone = {}, time.perf_counter()
    for b in batches:
        res, _ = local.run_batch(b)
        alone.update({k: float(v) for k, v in res.items()})
    t_alone = time.perf_counter() - t_alone
    rel = max(_worst_rel(s, {k: alone[k] for k in s}) for s in scores)
    log(f"  (a) 4 tenants, iteration 1 split by model, {SERVICE_ROWS} rows: "
        f"{wall:.2f} s; super-batches {got[0]}, deduped {got[1]}, per job "
        f"(coalesced_with, shared, cache hits, tiers) {jobs[0]} "
        f"(reference {SERVICE_SPLIT}); memory gate's largest in-flight "
        f"{gate / 2**30:.2f} GiB of {SERVICE_BUDGET / 2**30:.0f}, peak "
        f"device memory {peak / 2**30:.2f} GiB")
    log(f"      scores against each tenant's batch alone on the local "
        f"target ({t_alone:.2f} s): largest relative difference {rel:.3g} "
        f"(limit {SERVICE_RTOL:g}) ({card})")
    out["split"] = {"wall_s": wall, "counts": got, "scores": scores,
                    "alone": alone, "max_rel": rel, "gate_peak_bytes": gate,
                    "peak_bytes": peak,
                    "plan_cache": g["plan_cache"]}
    if got != want:
        problems.append(f"split {got}, the reference's {want}")
    if not (rel <= SERVICE_RTOL and all(np.isfinite(v) for s in scores
                                        for v in s.values())):
        problems.append(f"split scores against the local target: {rel}")
    return alone


def _service_search(torch, np, out, problems, cache_dir, local):
    """(b) examples/agentic_search.py's service mode: N agents, each an
    AsyncAIDESearch on its own thread, through connect("service")."""
    import tempfile
    import threading

    from repro_torch.agents import AIDEAgent, AsyncAIDESearch
    from repro_torch.client import connect
    from repro_torch.core.runtime import crossings, reset_crossings
    from repro_torch.service.observability import (COMPLETED, percentile,
                                                   replay, top)

    card = out["card"]
    trace_dir = tempfile.mkdtemp(prefix="traces-")
    try:
        cfg = service_config(cache_dir, coalesce_window_s=0.05, trace=True,
                             trace_dir=trace_dir)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_crossings()
        t0 = time.perf_counter()
        with connect("service", cfg) as client:
            bests, searches = _run_agents(client, SERVICE_AGENTS,
                                          SERVICE_ROUNDS, AIDEAgent,
                                          AsyncAIDESearch, threading)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            svc = client.service
            snap, g = client.telemetry.snapshot(), \
                client.telemetry.global_snapshot()
            seg = svc._backends["torch"].stats()
            gate = svc.mem_inflight_peak
            frame = top.render(g)
        cross = crossings()
        peak = torch.cuda.max_memory_allocated()
        timelines = replay.reassemble(replay.load_events(trace_dir))
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    last = {key: hops[-1]["event"] for key, hops in timelines.items()}
    waits = {f"agent-{i}": [r.queue_wait_s for r in s.reports]
             for i, s in enumerate(searches)}
    rel, rerun = {}, {}
    for i, node in enumerate(bests):
        if node is not None and np.isfinite(node.score):
            value, _ = local.run(node.spec.build())
            rerun[i] = float(value)
            rel[i] = abs(node.score - rerun[i]) / abs(rerun[i])
    log(f"  (b) {SERVICE_AGENTS} agents x {SERVICE_ROUNDS} rounds of "
        f"AsyncAIDESearch(batch_size=4, max_inflight=2) through "
        f"connect(\"service\"): {wall:.2f} s")
    for i, node in enumerate(bests):
        w = waits[f"agent-{i}"]
        log(f"      agent-{i}: best "
            f"{node.spec.preproc + '+' + node.spec.model if node else None}"
            f" rmse {node.score if node else None} (local target "
            f"{rerun.get(i)}, rel {rel.get(i)}); queue wait p50 "
            f"{percentile(w, 50):.3f} s, p99 {percentile(w, 99):.3f} s; "
            f"jobs {snap[f'agent-{i}']['jobs_completed']} done, "
            f"{snap[f'agent-{i}']['jobs_failed']} failed")
    log(f"      super-batches {g['super_batches']} (jobs coalesced "
        f"{g['jobs_coalesced']}), cross-agent ops deduped "
        f"{g['ops_deduped_cross_agent']}, cross-tenant cache hits "
        f"{g['cache_cross_tenant_hits']}, plan cache: "
        f"{g['plan_cache']['entries']} programs, "
        f"{g['plan_cache']['compiles']} compiles, "
        f"{g['plan_cache']['hits']} hits (rate "
        f"{g['plan_cache']['hit_rate']:.3f}), uncompilable "
        f"{g['plan_cache']['uncompilable']}")
    log(f"      traced {seg['traces']} segment(s) in {seg['trace_s']:.2f} s,"
        f" compiled {seg['compiles']} in {seg['compile_s']:.2f} s; "
        f"crossings {cross['to_device']} to the card "
        f"({cross['to_device_bytes'] / 2**20:.1f} MiB), {cross['to_host']} "
        f"to the host ({cross['to_host_bytes'] / 2**20:.1f} MiB); peak "
        f"device memory {peak / 2**30:.2f} GiB, the gate's largest "
        f"in-flight {gate / 2**30:.2f} GiB of "
        f"{SERVICE_BUDGET / 2**30:.0f} ({card})")
    log(f"      trace log: {len(timelines)} jobs replayed, last hops "
        f"{sorted(set(last.values()))}")
    for line in frame.splitlines():
        log(f"      | {line}")
    out["search"] = {
        "wall_s": wall, "best": [None if n is None else n.score
                                 for n in bests],
        "local": rerun, "rel": rel, "queue_wait_s": waits,
        "telemetry": snap, "global": g, "segment_stats": seg,
        "crossings": cross, "peak_bytes": peak, "gate_peak_bytes": gate,
        "replayed_jobs": len(timelines)}
    jobs = SERVICE_AGENTS * SERVICE_ROUNDS
    resolved = all(len(s.reports) == SERVICE_ROUNDS
                   and not s.deadlines_missed and not s.analysis_rejections
                   for s in searches)
    failed = sum(v["jobs_failed"] + v["deadline_shed"]
                 for v in snap.values())
    if not resolved or failed or sum(v["jobs_completed"]
                                     for v in snap.values()) != jobs:
        problems.append(f"search: rounds resolved {resolved}, failed or "
                        f"shed {failed}")
    if len(rel) != SERVICE_AGENTS or \
            not all(r <= SERVICE_RTOL for r in rel.values()):
        problems.append(f"search bests against the local target: {rel}")
    # work merged across agents, then reused after the merge: by the
    # shared cache or by a shared compiled program.  Which one depends on
    # the cache's room: with 1.6 GiB of cache (16 GiB x 0.10) against
    # 1,000,000 rows, an agent's intermediates are evicted before another
    # agent reads them, and the recomputation reuses the programs; the
    # reference does the same at the same data-to-cache ratio
    # (tests/test_torch_service.py::test_cross_tenant_cache_hits_need_room)
    pc = g["plan_cache"]
    if not (g["ops_deduped_cross_agent"] > 0
            and g["cache_cross_tenant_hits"] + pc["hits"] > 0):
        problems.append(f"search: work not shared across agents (deduped "
                        f"{g['ops_deduped_cross_agent']}, cross-tenant "
                        f"hits {g['cache_cross_tenant_hits']}, plan cache "
                        f"{pc})")
    if g["plan_cache"]["uncompilable"]:
        problems.append(f"search: {g['plan_cache']['uncompilable']} "
                        f"uncompilable segment(s)")
    if len(timelines) != jobs or set(last.values()) != {COMPLETED}:
        problems.append(f"trace log: {len(timelines)} jobs, last hops "
                        f"{sorted(set(last.values()))}")


def _run_agents(client, n_agents, n_rounds, AIDEAgent, AsyncAIDESearch,
                threading, **search_kw):
    """examples/agentic_search.py's run_async: one AsyncAIDESearch a
    thread, agent i seeded i (``search_kw``: e.g. the fabric mode's
    ``shard_affinity=True``)."""
    bests, searches, errors = [None] * n_agents, [None] * n_agents, []

    def agent_main(i):
        try:
            searches[i] = AsyncAIDESearch(
                client.session(f"agent-{i}"),
                AIDEAgent(n_rows=SERVICE_ROWS, cv_k=3, seed=i),
                batch_size=4, max_inflight=2, **search_kw)
            bests[i] = searches[i].run(n_rounds=n_rounds)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=agent_main, args=(i,))
               for i in range(n_agents)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"an agent failed: {errors}")
    return bests, searches


def _service_preempt(torch, np, out, problems, cache_dir, alone):
    """(c) one executor: iteration 1 as a SCAVENGER sweep; once it is
    dispatched and has polled its first wave boundary, an INTERACTIVE
    quickstart probe; the probe first, the sweep preempted and resumed
    from its salvage with the unpreempted scores."""
    import threading

    import repro_torch.tabular as T
    from repro_torch.agents import paper_workload_batches
    from repro_torch.data import tabular as data
    from repro_torch.service import Priority, StratumService
    from repro_torch.service.observability import DISPATCHED

    card = out["card"]
    _n, sweep_batch, _ctx = next(iter(paper_workload_batches(
        n_rows=SERVICE_ROWS, cv_k=3)))
    probe_batch, _, _ = tabular_batch(T, data, SERVICE_PROBE_ROWS)
    svc = StratumService(config=service_config(
        cache_dir, n_executors=1, coalesce_window_s=0.0,
        trace=True).service_config(), autostart=False)
    polled = threading.Event()
    install = svc._preempt_check_for

    def watched(live, band):
        # the runtime polls the check only at a wave boundary after an op
        # ran: its first call means the sweep's first wave is done
        check = install(live, band)
        if check is None:
            return None

        def poll():
            polled.set()
            return check()
        return poll

    svc._preempt_check_for = watched
    order: list = []
    try:
        sweep = svc.session("sweep").submit(sweep_batch,
                                            priority=Priority.SCAVENGER)
        sweep.add_done_callback(lambda _f: order.append("sweep"))
        t0 = time.perf_counter()
        svc.start()
        if not polled.wait(900):
            raise RuntimeError("the sweep never reached a wave boundary")
        hops = [h[0] for h in svc.traces.get(f"j{sweep.job_id}").hops]
        t_probe = time.perf_counter()
        probe = svc.session("probe").submit(probe_batch,
                                            priority=Priority.INTERACTIVE)
        probe.add_done_callback(lambda _f: order.append("probe"))
        _, probe_rep = probe.result(timeout=900)
        probe_s = time.perf_counter() - t_probe
        res, rep = sweep.result(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _uncompilable(svc, "preemption", problems)
    finally:
        svc.stop()
    scores = {k: float(v) for k, v in res.items()}
    rel = _worst_rel(scores, alone)
    log(f"  (c) one executor: iteration 1 as SCAVENGER ({wall:.2f} s); the "
        f"sweep's hops when the probe came {hops}; INTERACTIVE quickstart "
        f"probe at {SERVICE_PROBE_ROWS} rows: queue wait "
        f"{probe_rep.queue_wait_s:.3f} s, done {probe_s:.2f} s after "
        f"submit; order {order}")
    log(f"      sweep preemptions {rep.preemptions}, ops salvaged "
        f"{rep.ops_salvaged}; scores against the unpreempted run: largest "
        f"relative difference {rel:.3g} (limit {SERVICE_RTOL:g}) ({card})")
    out["preemption"] = {"wall_s": wall, "hops_at_probe": hops,
                         "probe_wait_s": probe_rep.queue_wait_s,
                         "probe_s": probe_s, "order": order,
                         "preemptions": rep.preemptions,
                         "ops_salvaged": rep.ops_salvaged, "max_rel": rel}
    if DISPATCHED not in hops or order[:1] != ["probe"] or \
            rep.preemptions < 1 or rep.ops_salvaged <= 0:
        problems.append(f"preemption: hops {hops}, order {order}, "
                        f"preemptions {rep.preemptions}, salvaged "
                        f"{rep.ops_salvaged}")
    if not rel <= SERVICE_RTOL:
        problems.append(f"preempted sweep's scores: {rel}")


def _boom(*_a, **_k):
    raise ValueError("poisoned op")


def _service_isolation(torch, np, out, problems, cache_dir, local):
    """(d) a host-side poisoned batch coalesced with an innocent one, a
    submission that fails the static analysis, then one more job."""
    import repro_torch.tabular as T
    from repro_torch.client import ServiceTarget, SubmitOptions
    from repro_torch.core import GENERIC, TRANSFORM, LazyOp, PipelineBatch
    from repro_torch.core.analysis import AnalysisError
    from repro_torch.core.runtime import ExecutionError
    from repro_torch.data import tabular as data
    from repro_torch.service import StratumService

    card = out["card"]
    x = T.read("uk_housing", SERVICE_PROBE_ROWS, seed=0)
    bad = PipelineBatch([LazyOp("boom", GENERIC, spec={"fn": _boom},
                                inputs=(T.project(x, [0, 1]),)).out()],
                        ["bad"])
    good, _, _ = tabular_batch(T, data, SERVICE_PROBE_ROWS)
    want, _ = local.run_batch(good)
    cfg = service_config(cache_dir, coalesce_window_s=0.05)
    svc = StratumService(config=cfg.service_config(), autostart=False)
    client = ServiceTarget(cfg, service=svc)
    try:
        f_bad = client.submit(bad, SubmitOptions(tenant="bad"))
        f_good = client.submit(good, SubmitOptions(tenant="good"))
        svc.start()
        try:
            f_bad.result(timeout=900)
            bad_error = None
        except ExecutionError as e:
            bad_error = type(e.cause).__name__
        res, rep = f_good.result(timeout=900)
        merged = client.telemetry.global_snapshot()
        rel = _worst_rel({k: float(v) for k, v in res.items()},
                         {k: float(v) for k, v in want.items()})
        invalid = PipelineBatch([LazyOp("no_such_op", TRANSFORM,
                                        inputs=(x,)).out()], ["invalid"])
        depth = svc.queue.pending()
        try:
            client.submit(invalid, SubmitOptions(verify=True))
            refused = None
        except AnalysisError as e:
            refused = sorted(e.rules)
        depth_after = svc.queue.pending()
        after, _ = client.run_batch(good, timeout=900)
        snap = client.telemetry.snapshot()
        _uncompilable(svc, "isolation", problems)
    finally:
        client.close()
        svc.stop()
    same_after = all(float(after[k]) == float(res[k]) for k in res)
    log(f"  (d) poisoned batch coalesced with the quickstart at "
        f"{SERVICE_PROBE_ROWS} rows: the bad job raised ExecutionError "
        f"({bad_error}) in a super-batch of {merged['jobs_coalesced']} "
        f"jobs, the innocent one re-ran alone, relative difference to the "
        f"local target {rel:.3g}; verify=True on an "
        f"invalid pipeline refused at submit {refused}, queue depth "
        f"{depth} -> {depth_after}; a later job answered, equal "
        f"{same_after} ({card})")
    out["isolation"] = {"bad_error": bad_error, "good_rel": rel,
                        "merged": [merged["super_batches"],
                                   merged["jobs_coalesced"]],
                        "refused": refused, "later_equal": same_after,
                        "telemetry": snap}
    if bad_error != "ValueError" or not rel <= SERVICE_RTOL or \
            (merged["super_batches"], merged["jobs_coalesced"]) != (1, 2) \
            or snap["bad"]["jobs_failed"] != 1 or \
            snap["good"]["jobs_completed"] != 1:
        problems.append(f"isolation: bad {bad_error}, good rel {rel}, "
                        f"telemetry {snap}")
    if refused != ["unknown-op"] or depth_after != depth or not same_after:
        problems.append(f"admission: refused {refused}, depth {depth} -> "
                        f"{depth_after}, later job equal {same_after}")


# ---------------------------------------------------------------------------
# fabric: N agents across shards, in this process and in worker processes
# ---------------------------------------------------------------------------

FABRIC_ROWS = SERVICE_ROWS
FABRIC_SHARDS = 4
# the service phase's 16 GiB split over the shards: each shard has its own
# memory gate and cache, and their sum stays the service's
FABRIC_SHARD_BUDGET = SERVICE_BUDGET // FABRIC_SHARDS
FABRIC_RTOL = SERVICE_RTOL
# (b) benchmarks/e2e_agentic.py's cohort workload (_run_fabric_mode): 16
# agents in 4 cohorts, one dataset each, an expensive TableVectorizer
# prefix per cohort and a cheap unique tail per (agent, round), one
# executor a shard, per-op dispatch, the cache at ~1.3 cohort working sets
COHORT_AGENTS = 16
COHORTS = 4
COHORT_ROUNDS = 2
COHORT_BUDGET = 8 << 30
COHORT_SETS = 1.3
COHORT_SCORE_RTOL = 1e-9          # the benchmark's scores_identical test
# (c) the out-of-process fabric on the one card
PROC_WORKERS = 2
PROC_FLOOD = 8
PROC_FLOOD_ROWS = SERVICE_PROBE_ROWS


class _RecordingSession:
    """A client session whose futures record, as they resolve, the type of
    every result value that reached the caller."""

    def __init__(self, session, seen):
        self._session, self._seen = session, seen

    def submit(self, batch, options=None):
        fut = self._session.submit(batch, options)
        fut.add_done_callback(self._record)
        return fut

    def _record(self, fut):
        try:
            results, _ = fut.result(timeout=0)
        except BaseException:  # noqa: BLE001 — a failed job is counted apart
            return
        self._seen.extend(type(v) for v in results.values())


class _RecordingClient:
    def __init__(self, client, seen):
        self._client, self._seen = client, seen

    def session(self, tenant):
        return _RecordingSession(self._client.session(tenant), self._seen)


def _host_types(torch, np, types) -> bool:
    """Every type a host value's: numpy (an array, or a scalar that the
    codec made a 0-d array) or a Python number; never a tensor."""
    return bool(types) and all(
        not issubclass(t, torch.Tensor)
        and issubclass(t, (np.ndarray, np.generic, float, int))
        for t in types)


def _flood_batches(T, rows):
    """(c)'s flood: eight small distinct pipelines over the seed-0 lake."""
    from repro_torch.core import PipelineBatch

    out = []
    for i in range(PROC_FLOOD):
        x = T.read("uk_housing", rows, seed=0)
        xs = T.scale(T.impute(T.project(x, [10 + i % 4, 11])))
        out.append(PipelineBatch([T.metric(
            T.project(xs, [0]), T.project(x, [0]),
            kind=("mae", "rmse")[i // 4])], ["p"]))
    return out


class _Utilization:
    """The card's ``utilization.gpu`` (the share of time a kernel ran),
    sampled every 250 ms by one ``nvidia-smi -lms`` process while the block
    runs: the busy share of work that no profiler in this process sees
    (kernels of worker processes too)."""

    def __enter__(self):
        import threading

        self.samples: list = []
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "250"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None
            return self
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        return self

    def _read(self):
        for line in self._proc.stdout:
            try:
                self.samples.append(float(line.split(",")[0]))
            except ValueError:
                pass

    def __exit__(self, *exc):
        if self._proc is not None:
            self._proc.terminate()
            self._proc.wait(timeout=30)
            self._reader.join(timeout=30)

    def busy(self):
        """The mean busy share over the block, or None without samples."""
        return sum(self.samples) / len(self.samples) / 100 \
            if self.samples else None


def _share(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def _smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-{query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def fabric_phase(torch, np, report):
    import os
    import tempfile

    from repro_torch.kernels.common import launches, reset_launches

    card = report.get("card", "")
    t_phase = time.perf_counter()
    # the workers read the lake: every file exists before any spawns.
    # One process a lake, all at once (writing a 1,000,000-row CSV is
    # host-bound Python, ~14 s each on the card's host)
    writers = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from repro_torch.data.tabular "
         "import ensure_files; ensure_files('uk_housing', int(sys.argv[1]), "
         "int(sys.argv[2]))", str(rows), str(seed)],
        env={**os.environ, "PYTHONPATH": str(SRC)})
        for rows, seed in [(FABRIC_ROWS, c) for c in range(COHORTS)]
        + [(PROC_FLOOD_ROWS, 0)]]
    rcs = [w.wait(timeout=600) for w in writers]
    if any(rcs):
        fail(f"fabric: writing the lakes exited {rcs}")
    cache_dir = tempfile.mkdtemp(prefix="inductor-")
    out = report["fabric"] = {"rows": FABRIC_ROWS, "card": card,
                              "lake_s": time.perf_counter() - t_phase}
    log(f"  lakes: {COHORTS} x {FABRIC_ROWS} rows and {PROC_FLOOD_ROWS} "
        f"rows in {out['lake_s']:.1f} s")
    problems: list = []
    reset_launches()
    try:
        _fabric_checks(torch, np, out, problems, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    counts = launches()
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  launches {counts}; phase {out['phase_s']:.1f} s ({card})")
    if any(counts.values()):
        problems.append(f"a hand kernel launched on the fabric path: "
                        f"{counts}")
    if problems:
        fail("fabric: " + "; ".join(problems))
    return counts


def _fabric_checks(torch, np, out, problems, cache_dir):
    """Checks (a)-(c) of the fabric phase; each failure is appended to
    ``problems``."""
    from repro_torch.client import connect

    local = connect("local", service_config(cache_dir))
    try:
        matching = _fabric_agents(torch, np, out, problems, cache_dir, local)
    finally:
        local.close()
    _fabric_cohorts(torch, np, out, problems)
    _fabric_processes(torch, np, out, problems, cache_dir, matching)


def _fabric_agents(torch, np, out, problems, cache_dir, local):
    """(a) examples/agentic_search.py --target fabric --shards 4: N agents,
    each an AsyncAIDESearch pinned to a shard, through connect("fabric");
    then iteration 1 and (c)'s flood on the same fabric, the in-process
    runs the worker processes are held to."""
    import threading
    from collections import Counter

    import repro_torch.tabular as T
    from repro_torch.agents import (AIDEAgent, AsyncAIDESearch,
                                    paper_workload_batches)
    from repro_torch.client import SubmitOptions, connect
    from repro_torch.service.observability import percentile

    card = out["card"]
    cfg = service_config(cache_dir, coalesce_window_s=0.05,
                         n_shards=FABRIC_SHARDS,
                         memory_budget_bytes=FABRIC_SHARD_BUDGET)
    _n, it1, _ctx = next(iter(paper_workload_batches(n_rows=FABRIC_ROWS,
                                                     cv_k=3)))
    seen: list = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with connect("fabric", cfg) as client:
        with _Utilization() as util:
            bests, searches = _run_agents(
                _RecordingClient(client, seen), SERVICE_AGENTS,
                SERVICE_ROUNDS, AIDEAgent, AsyncAIDESearch, threading,
                shard_affinity=True)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fab = client.fabric
        locality = fab.router.locality_hit_rate()
        snap, g = client.telemetry.snapshot(), \
            client.telemetry.global_snapshot()
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        res, rep = client.run_batch(it1, timeout=900)
        it1_s = time.perf_counter() - t1
        it1_scores = {k: float(v) for k, v in res.items()}
        futs = [client.submit(b, SubmitOptions(tenant="flood"))
                for b in _flood_batches(T, PROC_FLOOD_ROWS)]
        flood = [float(f.result(timeout=900)[0]["p"]) for f in futs]
        g_after = client.telemetry.global_snapshot()
    shards = {i: sorted({r.shard_id for r in s.reports})
              for i, s in enumerate(searches)}
    rel, rerun = {}, {}
    for i, node in enumerate(bests):
        if node is not None and np.isfinite(node.score):
            value, _ = local.run(node.spec.build())
            rerun[i] = float(value)
            rel[i] = abs(node.score - rerun[i]) / abs(rerun[i])
    unc = {sid: row.get("plan_cache", {}).get("uncompilable", 0)
           for sid, row in g_after["per_shard"].items()}
    routed = {sid: row["envelopes_routed"]
              for sid, row in g["per_shard"].items()}
    log(f"  (a) {SERVICE_AGENTS} agents x {SERVICE_ROUNDS} rounds of "
        f"AsyncAIDESearch(batch_size=4, max_inflight=2, "
        f"shard_affinity=True) through connect(\"fabric\"), "
        f"{FABRIC_SHARDS} shards of {FABRIC_SHARD_BUDGET / 2**30:.0f} GiB: "
        f"{wall:.2f} s; envelopes a shard {routed}, locality "
        f"{locality:.3f}; peak device memory {peak / 2**30:.2f} GiB; card "
        f"busy {_share(util.busy())} (nvidia-smi utilization.gpu)")
    for i, node in enumerate(bests):
        w = [r.queue_wait_s for r in searches[i].reports]
        log(f"      agent-{i}: shard {shards[i]}, best "
            f"{node.spec.preproc + '+' + node.spec.model if node else None}"
            f" rmse {node.score if node else None} (local target "
            f"{rerun.get(i)}, rel {rel.get(i)}); queue wait p50 "
            f"{percentile(w, 50):.3f} s, p99 {percentile(w, 99):.3f} s")
    log(f"      super-batches {g['super_batches']} (jobs coalesced "
        f"{g['jobs_coalesced']}), deduped {g['ops_deduped_cross_agent']}, "
        f"plan cache hits {g.get('plan_cache_hits')} misses "
        f"{g.get('plan_cache_misses')}, compile "
        f"{g.get('plan_cache_compile_time_s', 0.0):.2f} s; the "
        f"{len(seen)} results' types {dict(Counter(t.__name__ for t in seen))}"
        f"; uncompilable {unc}")
    log(f"      then iteration 1 (8 pipelines) on the same fabric in "
        f"{it1_s:.2f} s on {rep.shard_id}, and the {PROC_FLOOD}-job flood "
        f"of (c) at {PROC_FLOOD_ROWS} rows ({card})")
    out["agents"] = {
        "wall_s": wall, "routed": routed, "locality": locality,
        "shards": shards, "best": [None if n is None else n.score
                                   for n in bests],
        "local": rerun, "rel": rel, "telemetry": snap, "global": g,
        "peak_bytes": peak, "busy": util.busy(), "iteration1_s": it1_s,
        "iteration1": it1_scores, "flood": flood, "uncompilable": unc}
    jobs = SERVICE_AGENTS * SERVICE_ROUNDS
    resolved = all(len(s.reports) == SERVICE_ROUNDS
                   and not s.deadlines_missed and not s.analysis_rejections
                   for s in searches)
    failed = sum(snap[f"agent-{i}"]["jobs_failed"]
                 + snap[f"agent-{i}"]["deadline_shed"]
                 for i in range(SERVICE_AGENTS))
    done = sum(snap[f"agent-{i}"]["jobs_completed"]
               for i in range(SERVICE_AGENTS))
    if not resolved or failed or done != jobs:
        problems.append(f"(a): rounds resolved {resolved}, done {done} of "
                        f"{jobs}, failed or shed {failed}")
    if any(len(v) != 1 for v in shards.values()):
        problems.append(f"(a): an agent's jobs on several shards {shards}")
    if locality != 1.0:
        problems.append(f"(a): locality {locality}")
    if not _host_types(torch, np, seen) or len(seen) != jobs * 4:
        problems.append(f"(a): results' types {Counter(seen)}, not "
                        f"{jobs * 4} host values")
    if len(rel) != SERVICE_AGENTS or \
            not all(r <= FABRIC_RTOL for r in rel.values()):
        problems.append(f"(a): bests against the local target: {rel}")
    if any(unc.values()):
        problems.append(f"(a): uncompilable segments {unc}")
    return {"iteration1": it1_scores, "flood": flood}


def _cohort_job(T, data, cohort_seed, rows, tail_idx):
    """benchmarks/e2e_agentic.py's _cohort_job: the cohort's read and
    TableVectorizer fit (shared by the cohort), then a unique cheap tail."""
    from repro_torch.core import PipelineBatch

    feats, tgt = data.feature_target_indices()
    x = T.read("uk_housing", rows, seed=cohort_seed)
    Xv = T.table_vectorizer(T.project(x, feats), data.schema_dict(), feats)
    y = T.project(x, [tgt])
    col = tail_idx % len(feats)
    kind = "mae" if (tail_idx // len(feats)) % 2 else "rmse"
    return PipelineBatch([T.metric(T.project(Xv, [col]), y, kind=kind)],
                         [f"tail{tail_idx}"])


def _cohort_keys(n_cohorts, n_shards):
    """Affinity keys placing the cohorts evenly on an ``n_shards`` ring
    (the benchmark's _balanced_cohort_keys)."""
    from repro_torch.service.fabric import ConsistentHashRing

    ring = ConsistentHashRing([f"shard-{i}" for i in range(n_shards)])
    keys, used, i = [], set(), 0
    while len(keys) < n_cohorts and i < 100_000:
        key = f"cohort-{i}"
        shard = ring.route(key)
        if shard not in used or len(used) == n_shards:
            if shard in used:
                used.clear()
            used.add(shard)
            keys.append(key)
        i += 1
    return keys


def _cohort_config(cache_fraction):
    from repro_torch.service import ServiceConfig

    return ServiceConfig(
        memory_budget_bytes=COHORT_BUDGET, cache_fraction=cache_fraction,
        coalesce_window_s=0.005, coalesce_max_jobs=2,
        max_jobs_per_tenant_per_round=1, n_executors=1,
        compiled_segments=False, hardware_threads=SERVICE_THREADS)


def _cohort_mode(torch, n_shards, keys, cache_fraction):
    """The open-loop sweep: every agent's rounds submitted up front, round
    by round in agent order (agent i in cohort i % COHORTS)."""
    import repro_torch.tabular as T
    from repro_torch.data import tabular as data
    from repro_torch.service.fabric import ShardedStratum

    fab = ShardedStratum(n_shards=n_shards,
                         config=_cohort_config(cache_fraction))
    try:
        sessions = [fab.session(f"agent-{i}") for i in range(COHORT_AGENTS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _Utilization() as util:
            futures = []
            for r in range(COHORT_ROUNDS):
                for i in range(COHORT_AGENTS):
                    cohort, rank = i % COHORTS, i // COHORTS
                    tail = rank * COHORT_ROUNDS + r
                    futures.append((tail, sessions[i].submit(
                        _cohort_job(T, data, cohort, FABRIC_ROWS, tail),
                        affinity=keys[cohort])))
            scores = [float(f.result(timeout=900)[0][f"tail{tail}"])
                      for tail, f in futures]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g = fab.telemetry.global_snapshot()
        hits = {sid: svc.cache.stats.hits
                for sid, svc in fab._shards_snapshot().items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        fab.stop()
    return {"shards": n_shards, "wall_s": wall,
            "jobs_per_s": len(futures) / wall,
            "locality": g["signature_locality_hit_rate"],
            "routed": {k: v["envelopes_routed"]
                       for k, v in g["per_shard"].items()},
            "cache_hits": hits, "super_batches": g["super_batches"],
            "peak_bytes": peak, "busy": util.busy(), "scores": scores}


def _fabric_cohorts(torch, np, out, problems):
    """(b) the cohort workload once on 1 shard and once on 4: the same
    scores, locality 1.0 on 4; the walls and the throughput ratio."""
    import repro_torch.tabular as T
    from repro_torch.data import tabular as data
    from repro_torch.service import StratumService

    card = out["card"]
    # one cohort's cached working set on the card, read off a probe run
    # with room to spare (it also loads the per-op paths once)
    probe = StratumService(config=_cohort_config(0.5))
    try:
        t0 = time.perf_counter()
        probe.session("probe").submit(
            _cohort_job(T, data, 0, FABRIC_ROWS, 0)).result(timeout=900)
        probe_s = time.perf_counter() - t0
        per_cohort = probe.cache.stats.bytes_in_ram
    finally:
        probe.stop()
    fraction = min(0.5, COHORT_SETS * per_cohort / COHORT_BUDGET)
    keys = _cohort_keys(COHORTS, FABRIC_SHARDS)
    modes = {n: _cohort_mode(torch, n, keys, fraction)
             for n in (1, FABRIC_SHARDS)}
    lo, hi = modes[1], modes[FABRIC_SHARDS]
    rel = max(abs(a - b) / max(abs(a), 1.0)
              for a, b in zip(lo["scores"], hi["scores"]))
    ratio = hi["jobs_per_s"] / lo["jobs_per_s"]
    jobs = COHORT_AGENTS * COHORT_ROUNDS
    log(f"  (b) cohorts: {COHORT_AGENTS} agents in {COHORTS} cohorts x "
        f"{COHORT_ROUNDS} rounds = {jobs} jobs at {FABRIC_ROWS} rows; one "
        f"cohort's working set {per_cohort / 2**20:.1f} MiB (probe "
        f"{probe_s:.2f} s), cache {fraction:.4f} of "
        f"{COHORT_BUDGET / 2**30:.0f} GiB a shard")
    for m in (lo, hi):
        log(f"      {m['shards']} shard(s): {m['wall_s']:.2f} s, "
            f"{m['jobs_per_s']:.3f} jobs/s, locality {m['locality']:.3f}, "
            f"envelopes {m['routed']}, cache hits {m['cache_hits']}, "
            f"super-batches {m['super_batches']}, peak device memory "
            f"{m['peak_bytes'] / 2**30:.2f} GiB, card busy "
            f"{_share(m['busy'])}")
    log(f"      throughput ratio {FABRIC_SHARDS} shards / 1: {ratio:.3f}; "
        f"scores' largest relative difference {rel:.3g} (limit "
        f"{COHORT_SCORE_RTOL:g}) ({card})")
    out["cohorts"] = {"per_cohort_bytes": per_cohort,
                      "cache_fraction": fraction, "ratio": ratio,
                      "max_rel": rel, "probe_s": probe_s,
                      "modes": {str(k): {kk: vv for kk, vv in v.items()
                                         if kk != "scores"}
                                for k, v in modes.items()}}
    if not rel <= COHORT_SCORE_RTOL or \
            not all(np.isfinite(v) for v in lo["scores"]):
        problems.append(f"(b): 1 and {FABRIC_SHARDS} shards' scores "
                        f"differ by {rel}")
    if hi["locality"] != 1.0:
        problems.append(f"(b): locality {hi['locality']}")


def _fabric_processes(torch, np, out, problems, cache_dir, matching):
    """(c) processes=True with 2 workers on the card: iteration 1 against
    the in-process fabric; a worker SIGKILLed mid-flood; a drain with its
    warm hand-off; a graceful stop."""
    import gc
    import os
    import signal

    import repro_torch.tabular as T
    from repro_torch.agents import paper_workload_batches
    from repro_torch.client import SubmitOptions, connect

    card = out["card"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    cfg = service_config(cache_dir, coalesce_window_s=0.05,
                         n_shards=PROC_WORKERS, processes=True)
    _n, it1, _ctx = next(iter(paper_workload_batches(n_rows=FABRIC_ROWS,
                                                     cv_k=3)))
    floods = _flood_batches(T, PROC_FLOOD_ROWS)
    pids: dict = {}
    t0 = time.perf_counter()
    client = connect("fabric", cfg)
    try:
        fab = client.fabric
        spawn_s = time.perf_counter() - t0
        pids.update(fab.supervisor.live_workers())
        t1 = time.perf_counter()
        with _Utilization() as util:
            res, rep = client.run_batch(it1, timeout=900)
        it1_s = time.perf_counter() - t1
        it1_rel = _worst_rel({k: float(v) for k, v in res.items()},
                             matching["iteration1"])
        smi_used = _smi("gpu=memory.used")
        smi_apps = _smi("compute-apps=pid,used_memory")
        live = fab.shard_ids()
        if len(live) != PROC_WORKERS:
            # a worker left the ring during iteration 1 (ROADMAP.md C7):
            # fail with the supervisor's record of why, before the flood's
            # keys are built for shards that are gone
            problems.append(
                f"(c): {len(live)} of {PROC_WORKERS} shards live after "
                f"iteration 1 ({live}); supervisor failures "
                f"{list(fab.supervisor.failures)}; worker stats "
                f"{fab.supervisor.worker_stats()}")
            log(f"  {problems[-1]}")
            return
        # SIGKILL one worker with the flood in flight: its jobs are
        # requeued on the ring successor, none is lost
        victim = fab.shard_ids()[-1]
        keys = {sid: [k for k in (f"flood-{sid}-{j}" for j in range(999))
                      if fab.router._ring.route(k) == sid][:PROC_FLOOD]
                for sid in fab.shard_ids()}
        sids = fab.shard_ids()
        t1 = time.perf_counter()
        futs = [client.submit(b, SubmitOptions(
            tenant="flood", affinity=keys[sids[i % 2]][i]))
            for i, b in enumerate(floods)]
        os.kill(pids[victim], signal.SIGKILL)
        done = [f.result(timeout=900) for f in futs]
        kill_s = time.perf_counter() - t1
        _wait_until(lambda: victim not in fab.shard_ids())
        flood = [float(r["p"]) for r, _ in done]
        types = [type(v) for v in res.values()] + \
            [type(r["p"]) for r, _ in done]
        attempts = [rep.attempt for _, rep in done]
        g = client.telemetry.global_snapshot()
        failures = list(fab.supervisor.failures)
        # drain the survivor with its warm hand-off to a new worker
        (survivor,) = fab.shard_ids()
        t1 = time.perf_counter()
        new = fab.add_shard()
        add_s = time.perf_counter() - t1
        pids.update(fab.supervisor.live_workers())
        t1 = time.perf_counter()
        fab.scale_down(survivor)
        drain_s = time.perf_counter() - t1
        shipped = fab.supervisor.handoff_entries_shipped
        _wait_until(lambda: fab.supervisor.worker_stats()[new][
            "handoff_imported"] >= shipped)
        res0, rep0 = client.submit(floods[0], SubmitOptions(
            tenant="flood")).result(timeout=900)
        types.append(type(res0["p"]))
        g_end = client.telemetry.global_snapshot()
        stats = fab.supervisor.worker_stats()
    finally:
        t1 = time.perf_counter()
        client.close()
        stop_s = time.perf_counter() - t1
        left = _reap_worker_groups(os, signal, pids)
    reaped = dict(fab.supervisor.reaped)
    alive = [sid for sid, pid in pids.items() if _alive(os, pid)]
    unc = {sid: row.get("plan_cache", {}).get("uncompilable", 0)
           for sid, row in g_end["per_shard"].items()}
    flood_equal = flood == matching["flood"]
    log(f"  (c) processes=True, {PROC_WORKERS} workers on the card: spawned "
        f"in {spawn_s:.2f} s; the parent's reserved device memory "
        f"{reserved / 2**30:.2f} GiB; iteration 1 in {it1_s:.2f} s on "
        f"{rep.shard_id} (card busy {_share(util.busy())}), against the "
        f"in-process fabric: largest relative difference {it1_rel:.3g} "
        f"(limit {FABRIC_RTOL:g})")
    log(f"      card memory.used with the workers live {smi_used}; compute "
        f"apps: {smi_apps or 'none listed'}")
    log(f"      SIGKILL {victim} mid-flood ({PROC_FLOOD} jobs): all "
        f"answered in {kill_s:.2f} s, attempts {attempts}, equal to the "
        f"unkilled run {flood_equal}; shards failed {g['shards_failed']}, "
        f"requeues {g['failover_requeues']}, supervisor failures "
        f"{failures}; the results' types "
        f"{sorted({t.__name__ for t in types})}")
    log(f"      add_shard {new} in {add_s:.2f} s; scale_down {survivor} "
        f"with its warm hand-off in {drain_s:.2f} s: {shipped} entries "
        f"shipped, {stats[new]['handoff_imported']} imported; the "
        f"resubmitted job on {rep0.shard_id}: cache hits "
        f"{rep0.cache_hits}, equal {float(res0['p']) == flood[0]}")
    for sid, st in sorted(stats.items()):
        seg = st["segments"]
        log(f"      worker {sid} (pid {st['pid']}): HELLO "
            f"{st['hello_s']}, service ready {st['ready_s']} s after "
            f"spawn; largest heartbeat gap {st['max_beat_gap_s']:.3f} s; "
            f"traced {seg.get('traces')} segment(s) in "
            f"{seg.get('trace_s', 0.0):.2f} s, compiled "
            f"{seg.get('compiles')} in {seg.get('compile_s', 0.0):.2f} s; "
            f"exit {reaped.get(sid)}")
    log(f"      graceful stop {stop_s:.2f} s; workers left alive {alive}; "
        f"stray processes killed in the workers' groups {left}; "
        f"uncompilable {unc} ({card})")
    out["processes"] = {
        "spawn_s": spawn_s, "parent_reserved_bytes": reserved,
        "iteration1_s": it1_s, "iteration1_rel": it1_rel,
        "iteration1_busy": util.busy(),
        "memory_used": smi_used, "compute_apps": smi_apps,
        "victim": victim, "kill_s": kill_s, "attempts": attempts,
        "flood_equal": flood_equal, "shards_failed": g["shards_failed"],
        "failover_requeues": g["failover_requeues"], "failures": failures,
        "add_s": add_s, "drain_s": drain_s, "shipped": shipped,
        "resubmitted_cache_hits": rep0.cache_hits, "workers": stats,
        "reaped": reaped, "alive": alive, "stray": left,
        "uncompilable": unc, "stop_s": stop_s}
    if not it1_rel <= FABRIC_RTOL:
        problems.append(f"(c): iteration 1 against the in-process fabric "
                        f"{it1_rel}")
    if not _host_types(torch, np, types):
        problems.append(f"(c): results' types {types}")
    if len(done) != PROC_FLOOD or not flood_equal:
        problems.append(f"(c): flood {flood} against the unkilled "
                        f"{matching['flood']}")
    if g["shards_failed"] != 1 or [s for s, _ in failures] != [victim]:
        problems.append(f"(c): failovers {failures}, shards failed "
                        f"{g['shards_failed']}")
    if g_end["shards_failed"] != 1 or len(fab.supervisor.failures) != 1:
        problems.append(f"(c): an unasked-for failover "
                        f"{fab.supervisor.failures}")
    if not (shipped > 0 and stats[new]["handoff_imported"] > 0
            and rep0.shard_id == new and rep0.cache_hits > 0):
        problems.append(f"(c): hand-off shipped {shipped}, imported "
                        f"{stats[new]['handoff_imported']}, resubmitted on "
                        f"{rep0.shard_id} with {rep0.cache_hits} hits")
    survivors = {sid: rc for sid, rc in reaped.items() if sid != victim}
    if any(rc != 0 for rc in survivors.values()) or alive:
        problems.append(f"(c): exits {reaped}, left alive {alive}")
    if any(unc.values()):
        problems.append(f"(c): uncompilable segments {unc}")


def _wait_until(cond, timeout_s: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _alive(os, pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _reap_worker_groups(os, signal, pids) -> int:
    """Kill what is left of each worker's process group (a worker starts
    a session of its own; inductor's compile workers join it): the script
    leaves no process behind.  Returns how many groups still had one."""
    left = 0
    for pid in pids.values():
        try:
            os.killpg(pid, signal.SIGKILL)
            left += 1
        except (ProcessLookupError, PermissionError):
            pass
    return left


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


def profile_service(torch, np, report):
    """The service phase's (b) under torch.profiler: a first, unprofiled
    pass of the agents compiles every program; the intermediate cache is
    cleared; the same agents again, profiled.  The device's busy share
    and device time by op family, beside the single-client quickstart's
    idle share (the agentic profile, when it ran in this call)."""
    import tempfile
    import threading

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.agents import AIDEAgent, AsyncAIDESearch
    from repro_torch.client import connect

    cache_dir = tempfile.mkdtemp(prefix="inductor-")
    try:
        cfg = service_config(cache_dir, coalesce_window_s=0.05)
        with connect("service", cfg) as client:
            _run_agents(client, SERVICE_AGENTS, SERVICE_ROUNDS, AIDEAgent,
                        AsyncAIDESearch, threading)
            client.service.cache.clear_ram()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _run_agents(client, SERVICE_AGENTS, SERVICE_ROUNDS,
                            AIDEAgent, AsyncAIDESearch, threading)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    rows, busy, nk = _kernel_table(prof, 1)
    lines = _profile_lines(
        f"service, {SERVICE_AGENTS} agents x {SERVICE_ROUNDS} rounds, "
        f"{SERVICE_ROWS} rows, compiled programs warm, cache cold", wall,
        busy, nk, rows, report)
    fams: dict = {}
    for name, cnt, us in rows:
        fam = next(f for f, keys in TABULAR_FAMILIES
                   if any(k in name for k in keys))
        n, t = fams.get(fam, (0.0, 0.0))
        fams[fam] = (n + cnt, t + us)
    for fam, (cnt, us) in fams.items():
        lines.append(f"    {fam}: {us / 1e3:.3f} ms ({us / busy:.3f} of "
                     f"device time), {cnt:.0f} launches")
    report["profile"]["service_families_us"] = {f: t for f, (_, t) in
                                                fams.items()}
    single = [v for k, v in report["profile"].items()
              if k.startswith("agentic quickstart")]
    if single:
        idle = 1 - single[0]["device_busy_ms"] / single[0]["wall_ms"]
        lines.append(f"    idle share {1 - busy / 1e6 / wall:.3f} against "
                     f"the single-client quickstart's {idle:.3f} (this call)")
    report["profile"]["service_idle_share"] = 1 - busy / 1e6 / wall
    return lines


# the kernels of the GBT's per-level histogram: index_add_ of the fixed-point
# gradients and bincount of the counts
HISTOGRAM_KERNELS = ("indexFunc", "index_add", "Histogram", "histogram")

# kernel families of the tabular path, for the service profile
TABULAR_FAMILIES = (
    ("host<->device copies (pageable)", ("Memcpy",)),
    ("GBT histograms (index_add_, bincount)", HISTOGRAM_KERNELS),
    ("inductor's Triton kernels (the compiled segments)", ("triton_",)),
    ("cuBLAS and cuSOLVER", ("gemm", "nvjet", "potrf", "syrk", "trsm",
                             "splitKreduce")),
    ("sorts, reductions, elementwise and the rest", ("",)),
)


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
        "ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel",
        "wide_bwd_prep_kernel", "wide_bwd_band_kernel",
        "wide_bwd_finish_kernel", "moe_gmm_kernel",
        "moe_gmm_decode_kernel", "gmm_dw_kernel")


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


def profile_train_step(torch, report, cfg=None, lr=TRAIN_LR):
    """One train step at the train phase's configuration (or ``cfg``'s)
    under torch.profiler, after one warm step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.lm import DataConfig, global_batch_at
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = cfg or train_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    step = make_train_step(cfg, adamw(lr=lr))
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
    return _profile_lines(f"train step ({cfg.name}, {cfg.n_layers} layers,"
                          f" {TRAIN_BATCH}x{TRAIN_SEQ} tokens)", wall, busy,
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


def slstm_train_share(torch, report) -> str:
    """One sLSTM block of xlstm-1.3b forward and backward at a train
    microbatch's shape (4 x 2048 tokens, d 2048, bf16), after a warm run:
    its wall (3 runs, unprofiled) and its device time (one run under
    torch.profiler), times 2 (one segment's block, 2 microbatches) against
    the profiled one-segment train step's (``report["profile"]``), and
    times 12 (6 blocks) against the train_ssm phase's unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import _xlstm_layers, ssm_layout
    from repro_torch.models.xlstm import slstm_block

    cfg = get_config(SSM_ARCH)
    one = dataclasses.replace(cfg, n_layers=cfg.slstm_period)
    params = init_params(one, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    lp = _xlstm_layers(params, one)[0][1]
    gen = torch.Generator(device="cuda").manual_seed(3)
    B = TRAIN_BATCH // TRAIN_MB
    x = torch.randn(B, TRAIN_SEQ, cfg.d_model, generator=gen, device="cuda"
                    ).to(torch.bfloat16).requires_grad_()
    dy = torch.randn(B, TRAIN_SEQ, cfg.d_model, generator=gen,
                     device="cuda").to(torch.bfloat16)

    def run():
        slstm_block(lp, x, cfg).backward(dy)
        torch.cuda.synchronize()

    run()                                              # warm: the captures
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    wall = (time.perf_counter() - t0) / 3              # unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    _, busy, nk = _kernel_table(prof, 1)
    busy /= 1e3                                        # µs -> ms
    seg = TRAIN_MB                     # one segment's block, 2 microbatches
    n_blocks = ssm_layout(cfg)[0] * TRAIN_MB
    step = report.get("profile", {}).get(
        f"train step ({cfg.name}, {TRAIN_SSM_PROFILE_LAYERS} layers, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens)", {})
    step_busy = step.get("device_busy_ms")
    out = {"wall_ms": wall * 1e3, "busy_ms": busy, "kernels": nk,
           "blocks_a_step": n_blocks}
    text = (f"sLSTM block fwd+bwd (B {B}, S {TRAIN_SEQ}, d {cfg.d_model}): "
            f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms, {nk:.0f} "
            f"kernels")
    if step_busy:
        out["share_of_segment_busy"] = seg * busy / step_busy
        text += (f"; x {seg} against the profiled one-segment step: "
                 f"{out['share_of_segment_busy']:.3f} of its device time")
    full = report.get("train_ssm", {}).get("step_ms")
    if full:
        out["share_of_step_wall"] = n_blocks * wall * 1e3 / full
        text += (f"; x {n_blocks} against the {cfg.n_layers}-block step's "
                 f"{full:.1f} ms: {out['share_of_step_wall']:.3f}")
    report.setdefault("profile", {})["slstm_train"] = out
    del params, x, dy
    torch.cuda.empty_cache()
    return text


def profile_phase(torch, np, report, phases):
    lines = []
    if "train" in phases:
        lines += profile_train_step(torch, report)
    if "train_moe" in phases:
        lines += profile_train_step(
            torch, report, train_moe_config(train_moe_depth(torch)[0]),
            TRAIN_MOE_LR)
    if "train_hybrid" in phases:
        from repro_torch.configs import get_config
        lines += profile_train_step(torch, report, get_config(HYBRID_ARCH),
                                    TRAIN_HYBRID_LR)
    if "train_ssm" in phases:
        # one segment (8 blocks): the step's ~10^6 kernels at 48 blocks are
        # more than the profiler's tables take in the run's time
        from repro_torch.configs import get_config
        from repro_torch.models.xlstm import release_scan_graphs
        lines += profile_train_step(torch, report, dataclasses.replace(
            get_config(SSM_ARCH), n_layers=TRAIN_SSM_PROFILE_LAYERS),
            TRAIN_SSM_LR)
        lines.append(slstm_train_share(torch, report))
        release_scan_graphs()
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
    if "service" in phases:
        lines += profile_service(torch, np, report)
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
    if "train_moe" in phases:
        log(f"[train_moe] make_train_step {MOE_ARCH} full width and depth")
        by_path["train_moe"] = timed("train_moe", train_moe_phase, torch, np,
                                     report)
    if "train_hybrid" in phases:
        log(f"[train_hybrid] make_train_step {HYBRID_ARCH} full width and "
            f"depth")
        by_path["train_hybrid"] = timed("train_hybrid", train_hybrid_phase,
                                        torch, np, report)
    if "train_ssm" in phases:
        log(f"[train_ssm] make_train_step {SSM_ARCH} full width and depth")
        by_path["train_ssm"] = timed("train_ssm", train_ssm_phase, torch, np,
                                     report)
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
    dryrun = None
    if "dryrun" in phases:
        dryrun = start_dryrun()
        log(f"[dryrun] the dry run's counts started on the host (lowest "
            f"priority) after {DRYRUN_AFTER}, beside the card's later "
            f"phases")
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
    if "service" in phases:
        log(f"[service] the paper's N concurrent agents through "
            f"connect(\"service\") at the client's defaults, "
            f"{SERVICE_ROWS} rows, on the card")
        by_path["service"] = timed("service", service_phase, torch, np,
                                   report)
    if "fabric" in phases:
        log(f"[fabric] the paper's agents across shards through "
            f"connect(\"fabric\"), in this process and in worker "
            f"processes, {FABRIC_ROWS} rows, on the card")
        by_path["fabric"] = timed("fabric", fabric_phase, torch, np, report)
    if "distributed" in phases:
        log(f"[distributed] the LM substrate sharded over {DIST_RANKS} ranks "
            f"sharing the card (gloo): qwen2-7b TP + sequence-sharded "
            f"decode, granite EP, a (2, 2) train step, vocab-parallel CE")
        by_path["distributed"] = timed("distributed", distributed_phase,
                                       torch, np, report)
    if "dryrun" in phases:
        log("[dryrun] the multi-pod dry run (python -m "
            "repro_torch.launch.dryrun) on this machine, and its count held "
            "against the phases measured on the card")
        by_path["dryrun"] = timed("dryrun", dryrun_phase, torch, np, report,
                                  dryrun)
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
