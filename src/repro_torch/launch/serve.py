"""Serving entry point: continuous-batched generation (the counterpart of
``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen2-7b --full     # full width
    python -m repro_torch.launch.serve --arch starcoder2-15b --full  # G 12
    python -m repro_torch.launch.serve --arch zamba2-1.2b --full  # hybrid
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --full  # moe
    python -m repro_torch.launch.serve --arch xlstm-1.3b --full    # ssm
    python -m repro_torch.launch.serve --arch qwen2-7b --device cpu  # reduced

Runs on the CUDA device unless ``device="cpu"`` (``--device cpu``) is given;
with no device and no CUDA it raises.  The reduced configs (fp32, head dim
32) are for the CPU: on a CUDA device ``serve_demo`` raises for them before
it allocates a parameter (``check_card_config``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, reduced as reduce_cfg
from ..kernels.common import resolve_device
from ..models.config import ModelConfig
from ..models.model import init_params, prefill
from ..serve.batcher import Batcher, Request
from ..serve.step import make_decode_step
from . import check_card_config


@torch.inference_mode()
def serve_requests(params, cfg: ModelConfig, requests: list[Request], *,
                   n_lanes: int, prompt_len: int, max_len: int,
                   device=None) -> tuple[dict, list[Request]]:
    """Serve ``requests`` in waves over ``n_lanes`` lanes, as the JAX
    package's ``serve_demo`` does.  Returns (stats, finished requests)."""
    device = resolve_device(device)
    decode = make_decode_step(cfg)
    batcher = Batcher(n_lanes=n_lanes, max_len=max_len)
    for req in requests:
        batcher.submit(req)

    steps = 0
    produced = 0
    prefill_s: list[float] = []
    decode_s = 0.0
    t0 = time.perf_counter()
    # wave-batched admission: lanes are prefilled together as one batch
    # (unused lanes with zero prompts), decode proceeds until the wave drains
    # (retired lanes keep decoding), exactly as the JAX loop.
    while not batcher.idle:
        wave = batcher.admit()
        if not wave:
            break
        prompts = np.zeros((n_lanes, prompt_len), np.int32)
        for lane, req in wave:
            prompts[lane] = req.prompt
        tp = time.perf_counter()
        logits, state = prefill(
            params, {"tokens": torch.from_numpy(prompts).to(device)}, cfg,
            max_len=max_len)
        nxt = torch.argmax(logits, -1)[:, None].to(torch.int32).cpu().numpy()
        prefill_s.append(time.perf_counter() - tp)
        while batcher.active_lanes():
            active = batcher.active_lanes()
            batcher.record_tokens(nxt[:, 0])
            produced += len(active)
            td = time.perf_counter()
            nxt_t, _, state = decode(params, state,
                                     torch.from_numpy(nxt).to(device))
            nxt = nxt_t.cpu().numpy()      # waits for the step
            decode_s += time.perf_counter() - td
            steps += 1
    dt = time.perf_counter() - t0          # the last step's .cpu() waited
    stats = {"requests": len(batcher.finished), "decode_steps": steps,
             "tokens": produced, "tok_per_s": produced / max(dt, 1e-9),
             "wall_s": dt, "prefill_s": prefill_s, "decode_s": decode_s}
    return stats, batcher.finished


def serve_demo(arch: str, *, n_requests: int = 8, n_lanes: int = 4,
               prompt_len: int = 16, max_new: int = 16, max_len: int = 64,
               use_reduced: bool = True, seed: int = 0, device=None):
    """Synthetic requests through the port's serving path.  Returns the JAX
    ``serve_demo``'s dict (requests, decode_steps, tokens, tok_per_s,
    wall_s) plus the prefill seconds of each wave and the summed decode
    seconds.  Its prompts are tokens, as the JAX package's are: the vlm and
    audio families, which take precomputed embeddings, raise before any
    parameter is allocated (serve them through ``serve.step``)."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduce_cfg(cfg)
    if cfg.frontend != "none":
        raise ValueError(
            f"{arch} takes precomputed embeddings (frontend "
            f"{cfg.frontend!r}), not token prompts: serve it through "
            "repro_torch.serve.step's make_prefill_step and make_decode_step")
    check_card_config(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=device)

    rng = np.random.default_rng(seed)
    requests = [Request(rid=rid,
                        prompt=rng.integers(0, cfg.vocab,
                                            prompt_len).astype(np.int32),
                        max_new_tokens=max_new)
                for rid in range(n_requests)]
    stats, _ = serve_requests(params, cfg, requests, n_lanes=n_lanes,
                              prompt_len=prompt_len, max_len=max_len,
                              device=device)
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published configuration, not the reduced one")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (raises without one)")
    args = ap.parse_args()
    out = serve_demo(args.arch, n_requests=args.requests,
                     n_lanes=args.lanes, prompt_len=args.prompt_len,
                     max_new=args.max_new, use_reduced=not args.full,
                     device=args.device)
    print(out)


if __name__ == "__main__":
    main()
