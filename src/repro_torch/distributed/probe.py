"""What the collectives of this machine take: run on a card,

    python -m repro_torch.distributed.probe [--ranks 4] [--out FILE]

starts ``--ranks`` processes on the first card over gloo and tries each
``torch.distributed`` collective the port could use on CUDA tensors of
fp32, bf16 and int32 (each result checked against its expected value),
times a 117 MB fp32 all-reduce (a qwen2-7b prefill wave's partial sum), a
115 KB one (a decode step's) and the first on pinned host memory, then
asks NCCL for 2 ranks on the same card.  It prints one JSON object (and
writes it to ``--out``): each collective's "ok" or the error it raised,
the times, and NCCL's answer.  A refusal is the probe's finding, not its
failure: the exit code is 0 when every rank reported.
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import threading
import time

import torch
import torch.distributed as dist

from .collectives import free_port

WATCHDOG_S = 120.0


def _try(results: dict, name: str, fn) -> None:
    """Record fn's check or the error it raised (the probe's finding)."""
    try:
        results[name] = "ok" if fn() else "wrong result"
    except (RuntimeError, ValueError, TypeError) as e:
        results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def _collectives(rank: int, world: int, dev) -> dict:
    res: dict = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        tag = str(dt).split(".")[-1]

        def full(n, v):
            return torch.full((n,), v, dtype=dt, device=dev)

        def all_reduce_sum():
            t = full(1000, rank + 1)
            dist.all_reduce(t)
            return t[0].item() == world * (world + 1) // 2

        def all_reduce_max():
            t = full(10, rank + 1)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return t[0].item() == world

        def all_gather():
            outs = [full(5, 0) for _ in range(world)]
            dist.all_gather(outs, full(5, rank))
            return [o[0].item() for o in outs] == list(range(world))

        def reduce_scatter_tensor():
            out = full(4, 0)
            dist.reduce_scatter_tensor(out, full(4 * world, rank + 1))
            return out[0].item() == world * (world + 1) // 2

        def all_to_all_single():
            t = torch.arange(world, device=dev).to(dt) + 10 * rank
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t)
            return out.tolist() == [10 * r + rank for r in range(world)]

        def broadcast():
            t = full(5, rank)
            dist.broadcast(t, src=0)
            return t[0].item() == 0

        for fn in (all_reduce_sum, all_reduce_max, all_gather,
                   reduce_scatter_tensor, all_to_all_single, broadcast):
            _try(res, f"{fn.__name__} {tag}", fn)
    return res


def _time_all_reduce(t: torch.Tensor, iters: int) -> float:
    for _ in range(2):
        dist.all_reduce(t)
    if t.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(t)
    if t.is_cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _gloo_rank(rank, world, port, queue):
    threading.Timer(WATCHDOG_S, lambda: os._exit(3)).start()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {"collectives": _collectives(rank, world, dev)}
    big = 8 * 1024 * 3584
    out["all_reduce_117MB_fp32_ms"] = _time_all_reduce(
        torch.ones(big, device=dev), 3)
    out["all_reduce_117MB_fp32_pinned_host_ms"] = _time_all_reduce(
        torch.ones(big).pin_memory(), 3)
    out["all_reduce_115KB_fp32_ms"] = _time_all_reduce(
        torch.ones(8 * 28 * 128, device=dev), 50)
    dist.barrier()
    queue.put((rank, out))
    dist.destroy_process_group()
    os._exit(0)


def _nccl_rank(rank, world, port, queue):
    threading.Timer(WATCHDOG_S, lambda: os._exit(4)).start()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank, device_id=dev)
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        queue.put((rank, f"ok {t[0].item()}"))
    except RuntimeError as e:          # DistBackendError is one
        queue.put((rank, f"{type(e).__name__}: {str(e)[:600]}"))
    os._exit(0)


def _run(target, world: int, timeout: float) -> dict:
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    while len(got) < world and time.monotonic() < deadline:
        if not any(p.is_alive() for p in procs) and queue.empty():
            break
        try:
            r, v = queue.get(timeout=1.0)
            got[r] = v
        except queue_mod.Empty:
            continue
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    got["exit_codes"] = [p.exitcode for p in procs]
    return got


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA device")
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    gloo = _run(_gloo_rank, args.ranks, 2 * WATCHDOG_S)
    report["gloo_rank0"] = gloo.get(0)
    report["gloo_exit_codes"] = gloo["exit_codes"]
    report["nccl_two_ranks_one_card"] = _run(_nccl_rank, 2, WATCHDOG_S)
    text = json.dumps(report, indent=1, default=str)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if 0 not in gloo:
        raise SystemExit("a gloo rank did not report")


if __name__ == "__main__":
    main()
