"""The wide SSD backward (``csrc/ssd_scan_bwd_wide.cu``) against the forms
its design dropped, on one CUDA card, at xlstm's train shape.

Each form is the committed source with one part rewritten (the text edits
below), built with ``kernels/common.py``'s nvcc flags into its own library
under ``build/ssd_bwd_wide_variants/`` and called through the same wrapper:

* ``final``: the committed kernel;
* ``one_accumulator``: the rs product's three parts built once a V box and
  summed over the warpgroup's 256 columns in one wgmma accumulator;
* ``update_in_state``: the state update's parts added straight into the
  state's accumulators (N 256), no fresh accumulator and fold;
* ``no_rs_product``: the rs product left out (its results wrong): what the
  rest costs.

For each form, in alternating order over ``--rounds`` rounds: device ms a
call (``chip_smoke.Timer``: L2 flushed, events), its kernels' split
(``chip_smoke.ssd_bwd_wide_split``), and, in the first round, ``--draws``
draws of the ds_final train case held against the twin
``ssd_chunked_bwd_ref`` by ``chip_smoke.ssd_bwd_check``: how many draws
fail and the worst element in bf16 ulps.  One JSON line a form, and the
card's name and power limit.  Run from the repository's root:

    python3 scripts_ssd_bwd_wide_variants.py [--draws 4] [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan_bwd_wide.cu"
OUT = ROOT / "build" / "ssd_bwd_wide_variants"
RS = ("    // (1) P = this warpgroup's share of T V^T",
      "    hp::named_sync(2 + wg, 128);       // the warpgroup's V boxes")
UPDATE = ("    // (3) the update: T = exp(l_L) T + A^T Z",
          "    hp::named_sync(2 + wg, 128);       // the warpgroup's Z boxes")

ONE_ACCUMULATOR = """    hp::bar_wait(&vfull[wg], ph);
    float P[32];
    const uint32_t vb = base + B_V + wg * HALF;
#pragma unroll
    for (int gq = 0; gq < 4; ++gq) {
      uint32_t fr[3][4][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int j0 = 8 * gq + 2 * kq, j1 = j0 + 1;
        split3(st[4 * j0], st[4 * j0 + 1], fr[0][kq][0], fr[1][kq][0],
               fr[2][kq][0]);
        split3(st[4 * j0 + 2], st[4 * j0 + 3], fr[0][kq][1], fr[1][kq][1],
               fr[2][kq][1]);
        split3(st[4 * j1], st[4 * j1 + 1], fr[0][kq][2], fr[1][kq][2],
               fr[2][kq][2]);
        split3(st[4 * j1 + 2], st[4 * j1 + 3], fr[0][kq][3], fr[1][kq][3],
               fr[2][kq][3]);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int pt = 0; pt < 3; ++pt)
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
          hp::Wgmma<64>::rs<0>(P, fr[2 - pt][kq],
                               hp::desc_kmajor(vb + gq * BOX, kq),
                               gq > 0 || pt > 0 || kq > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(P);
      hp::fence_regs(fr[0]);
      hp::fence_regs(fr[1]);
      hp::fence_regs(fr[2]);
    }
"""

UPDATE_IN_STATE = """    hp::bar_wait(&zfull[wg], ph);
#pragma unroll
    for (int i = 0; i < 128; ++i) st[i] *= dec;
    {
      const uint32_t zb = base + B_Z + wg * HALF, bt = base + B_BUILT;
      hp::wgmma_fence();
#pragma unroll
      for (int pt = 0; pt < 3; ++pt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hp::Wgmma<256>::ss<1, 1>(
              st, hp::desc_mnmajor(bt + (2 - pt) * BOX, kk, BOX),
              hp::desc_mnmajor(zb, kk, BOX), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(st);
    }
"""

NO_RS_PRODUCT = """    hp::bar_wait(&vfull[wg], ph);
    float P[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) P[i] = st[i] * 1e-3f;
"""


def replace(src: str, span, body: str) -> str:
    i = src.index(span[0])
    return src[:i] + body + src[src.index(span[1], i):]


def forms() -> dict:
    src = SRC.read_text()
    return {"final": src,
            "one_accumulator": replace(src, RS, ONE_ACCUMULATOR),
            "update_in_state": replace(src, UPDATE, UPDATE_IN_STATE),
            "no_rs_product": replace(src, RS, NO_RS_PRODUCT)}


def build(sources: dict) -> dict:
    """Each form's library, one nvcc each, all started together."""
    from repro_torch.kernels.common import NVCC_FLAGS, _nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I",
             str(SRC.parent), "-o", str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_bwd_wide.argtypes = [p] * 13 + [i] * 5 + [i64] * 27 + [p]
        lib.ssd_scan_bwd_wide.restype = i
        lib.ssd_scan_bwd_wide_workspace.argtypes = [i, i, i]
        lib.ssd_scan_bwd_wide_workspace.restype = i64
        libs[name] = (lib, [line.strip() for line in log.splitlines()
                            if any(k in line for k in ("band_kernel", "Used",
                                                       "spill"))])
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the forms run only on the card")
    import chip_smoke as cs
    import repro_torch.kernels.ssd.kernel as K
    from repro_torch.kernels.common import bf16_ulps
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    libs = build(forms())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    timer = cs.Timer(torch)
    inputs, dy, _ = cs.ssd_bwd_wide_case(torch, randn,
                                         *cs.SSD_BWD_WIDE_CASES[0])
    out = {n: {"ms": [], "ptxas": libs[n][1]} for n in libs}
    order = list(libs)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            K.library = lambda name=name: libs[name][0]
            call = lambda: K.ssd_scan_bwd_cuda(*inputs, dy)
            out[name]["ms"].append(timer.ms(call))
            out[name]["split_us"] = cs.ssd_bwd_wide_split(torch, timer, call)
            if r or name == "no_rs_product":
                continue
            fails, worst = 0, 0.0
            draw_gen = torch.Generator(device="cuda")
            draw_gen.manual_seed(1)            # the same draws for each form

            def draw(*shape, dtype=torch.bfloat16):
                return torch.randn(shape, generator=draw_gen,
                                   device="cuda").to(dtype)
            for _ in range(args.draws):
                a, d, ds = cs.ssd_bwd_wide_case(torch, draw,
                                                *cs.SSD_BWD_WIDE_CASES[1])
                got = K.ssd_scan_bwd_cuda(*a, d, ds)
                want = ssd_chunked_bwd_ref(*a, d, ds)
                res = cs.ssd_bwd_check(torch, "", got, want, quiet=True,
                                       name="ssd_scan_bwd_wide")
                fails += not all(v[0] for v in res.values())
                worst = max(worst, *(float(bf16_ulps(
                    got[k], want[k], "ssd_scan_bwd/card_bf16").max())
                    for k in range(3)))
                del a, d, ds, got, want
            out[name].update(draws=args.draws, draws_failing=fails,
                             worst_ulps=worst)
    for name in order:
        print(json.dumps({"form": name, **out[name]}), flush=True)


if __name__ == "__main__":
    main()
