// Fused LM-head cross-entropy forward for Hopper: per token, the log-sum-exp
// of x·w over the valid vocabulary and the logit of its label, without ever
// writing the (T, V) logits.
//
// Replaces: src/repro/kernels/cross_entropy/kernel.py:76 ce_forward_pallas
// (body _ce_kernel), and the chunked jnp forward _forward_chunked (ops.py)
// that the JAX package takes when the head is padded (n_valid < V): columns
// at or past n_valid are masked here, so one kernel serves both branches.
//
// What bounds it on the H100: operations.  At the training path's shape
// (T = 8192 tokens, D = 3584, V = 152064) the product is 2·T·D·V = 8.93
// TFLOP: 9.03 ms at 989 TFLOP/s, against 1.09 GB of w and 58.7 MB of x
// (0.34 ms at 3.35 TB/s).  The earlier design (mma.sync on 32 x 64 warp
// tiles, cp.async, 2048-column splits with the token tile fastest) ran at
// 1.76x the library's matmul + logsumexp: mma.sync reaches at most half
// the tensor cores' rate, and its blocks in flight spanned all of x.
//
// Design: the grouped matmul's prefill mainloop (moe_gmm.cu) with a
// logsumexp epilogue.
//  * work units are output tiles of 128 tokens x 256 columns; a persistent
//    grid of one block an SM walks them.  V = 152064 is exactly 594 column
//    tiles and T = 8192 is 64 token tiles;
//  * the token tile is the fastest index of the units: the ~132 units in
//    flight cover all 64 token tiles of ~2 column tiles.  They advance
//    through D nearly in step, so what L2 must hold at once is the current
//    64-deep slices (x: 8192 x 64, w: 64 x 512, ~1 MB for each), and each
//    w slice serves 64 units.  x is then read from device memory once per
//    ~2 column tiles: ~297 x 58.7 MB = 17 GB, ~5.2 ms at 3.35 TB/s,
//    overlapped with the products' 9.03 ms.  Bands of 4, 8 or 16 column
//    tiles (x read 594/8 times, w's working set in L2) ran no faster on the
//    H100, and their unit arithmetic (two divisions by run-time values)
//    pushed the consumers past their 168 registers into spills;
//  * one producer thread keeps a 4-stage TMA ring of 64-deep slices full:
//    the x box (128 tokens, a 2-D map over (T, D)) and four 64-column w
//    boxes (a 2-D map over (D, V)), all with the 128-byte swizzle.  Rows
//    past T, a last slice half past D (D % 64 == 32) and columns past V
//    read zeros;
//  * two consumer warpgroups each run wgmma m64n256k16 on 64 of the 128
//    tokens (x the K-major A operand, w the MN-major B operand), with one
//    wgmma group in flight while the next slice is waited for;
//  * the epilogue stays in registers: each thread holds 2 rows x 64
//    columns of its warpgroup's 64 x 256 accumulator.  Columns at or past
//    n_valid become -inf; the thread picks out its rows' label logits and
//    takes each row's max and exp2 sum (log2 domain) in four chains; quad
//    shuffles leave one (m, l, label logit) a row, written as the column
//    tile's partial.  At K 3584 the epilogue is ~1 us against ~30 us of
//    products a unit;
//  * column tiles wholly past n_valid are not units: they run no products,
//    and the merge reads only the tiles that ran;
//  * ce_merge_kernel merges a token's partials in a fixed order (8 warps,
//    each a fixed residue of the tiles, then the 8 in order): the result
//    is deterministic, with no atomics;
//  * products of bf16 values are exact in fp32, as in the TPU kernel's fp32
//    dot of the same values; only the order of the fp32 sums differs.
#include "common.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <math.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;

constexpr int BT = 128;                       // tokens a unit
constexpr int BN = 256;                       // vocabulary columns a unit
constexpr int BK = 64;                        // depth of one slice
constexpr int STAGES = 4;
constexpr int X_BYTES = BT * BK * 2;          // 16 KB
constexpr int W_BOX = BK * 64 * 2;            // 8 KB: 64 deep x 64 columns
constexpr int STAGE_BYTES = X_BYTES + (BN / 64) * W_BOX;   // 48 KB
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;          // + alignment
constexpr int THREADS = 384;                  // 2 consumer WGs + 1
constexpr int MERGE_TOKENS = 32;              // tokens a merge block
constexpr int MERGE_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// (m, l) merge in the log2 domain; an empty side has m = -inf and l = 0.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * exp2f(m - M)) +
      (m2 == -INFINITY ? 0.f : l2 * exp2f(m2 - M));
  m = M;
}

__global__ void __launch_bounds__(THREADS, 1)
    ce_tile_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const int* __restrict__ labels, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_ll,
                   int T, int D, int n_valid, int n_tt, int n_units) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], 256);                  // every consumer thread
    }
    hp::bar_init_fence();
  }
  __syncthreads();

  const int nk = (D + BK - 1) / BK;
  const int wg = warp / 4;

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load --------------------
    if (tid == 256) {
      hp::tma_prefetch_map(&x_map);
      hp::tma_prefetch_map(&w_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const int tt = u % n_tt, ct = u / n_tt;    // token tile fastest
        for (int ks = 0; ks < nk; ++ks) {
          hp::bar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * STAGE_BYTES;
          hp::bar_arrive_tx(&full[stage], STAGE_BYTES);
          hp::tma_load_2d(st, &x_map, &full[stage], ks * BK, tt * BT);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hp::tma_load_2d(st + X_BYTES + j * W_BOX, &w_map, &full[stage],
                            ct * BN + 64 * j, ks * BK);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tokens 64·wg .. 64·wg + 63 --------
    const int w4 = (tid - wg * 128) / 32, gq = lane / 4, t4 = lane % 4;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2] = {};
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int tt = u % n_tt, ct = u / n_tt;
      // this thread's rows: row0 and row0 + 8
      const int row0 = tt * BT + 64 * wg + 16 * w4 + gq;
      const int lab0 = row0 < T ? labels[row0] : -1;
      const int lab1 = row0 + 8 < T ? labels[row0 + 8] : -1;

      int prev = -1;
      for (int ks = 0; ks < nk; ++ks) {
        hp::bar_wait(&full[stage], phase);
        const uint32_t xs = base + stage * STAGE_BYTES + wg * 64 * 128;
        const uint32_t ws = base + stage * STAGE_BYTES + X_BYTES;
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hp::Wgmma<BN>::ss<0, 1>(acc, hp::desc_kmajor(xs, kk),
                                  hp::desc_mnmajor(ws, kk, W_BOX),
                                  ks > 0 || kk > 0);
        hp::wgmma_commit();
        // the products of the previous slice are done: release its stage
        hp::wgmma_wait<1>();
        if (prev >= 0) hp::bar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      hp::bar_arrive(&empty[prev]);

      // Epilogue.  acc[4j + 2r + e]: row row0 + 8r, column
      // ct·BN + 8j + 2·t4 + e.  Column c = 8j + e of this thread is valid
      // while c < lim; the label sits at c == lab - c0.
      const int c0 = ct * BN + 2 * t4;
      const int lim = n_valid - c0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lab_c = (r == 0 ? lab0 : lab1) - c0;
        float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        float hit = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + e;
            const float v = c < lim ? acc[4 * j + 2 * r + e] : -INFINITY;
            acc[4 * j + 2 * r + e] = v;
            mx[j % 4] = fmaxf(mx[j % 4], v);
            hit = c == lab_c ? v : hit;
          }
        const float m =
            fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])) * LOG2E;
        const float m_use = m == -INFINITY ? 0.f : m;
        float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sm[j % 4] +=
                repro::exp2_approx(fmaf(acc[4 * j + 2 * r + e], LOG2E, -m_use));
        float mm = m, l = (sm[0] + sm[1]) + (sm[2] + sm[3]);
#pragma unroll
        for (int off = 1; off <= 2; off *= 2) {
          const float m2 = __shfl_xor_sync(0xffffffffu, mm, off);
          const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
          hit = fmaxf(hit, __shfl_xor_sync(0xffffffffu, hit, off));
          merge(mm, l, m2, l2);
        }
        const int row = row0 + 8 * r;
        if (t4 == 0 && row < T) {
          const ll at = (ll)ct * T + row;
          part_m[at] = mm;
          part_l[at] = l;
          part_ll[at] = hit;
        }
      }
    }
  }
}

// A block merges the partials of 32 tokens: warp w takes the column tiles
// w, w + 8, w + 16, ... of its lane's token in order, then the 8 warps'
// results are merged in order.  The order of the sums is fixed.
__global__ void __launch_bounds__(MERGE_TOKENS * MERGE_WARPS)
    ce_merge_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_ll,
                    float* __restrict__ lse, float* __restrict__ label_logit,
                    int T, int n_ct) {
  __shared__ float red[3][MERGE_WARPS][MERGE_TOKENS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * MERGE_TOKENS + lane;
  float M = -INFINITY, L = 0.f, H = -INFINITY;
  if (t < T) {
    for (int s = warp; s < n_ct; s += MERGE_WARPS) {
      const ll at = (ll)s * T + t;
      merge(M, L, part_m[at], part_l[at]);
      H = fmaxf(H, part_ll[at]);
    }
  }
  red[0][warp][lane] = M;
  red[1][warp][lane] = L;
  red[2][warp][lane] = H;
  __syncthreads();
  if (warp == 0 && t < T) {
    for (int w = 1; w < MERGE_WARPS; ++w) {
      merge(M, L, red[0][w][lane], red[1][w][lane]);
      H = fmaxf(H, red[2][w][lane]);
    }
    // the TPU kernel's m + log(max(l, 1e-30)), from the log2 domain
    lse[t] = M == -INFINITY ? -INFINITY : (M + log2f(fmaxf(L, 1e-30f))) * LN2;
    label_logit[t] = H;
  }
}

}  // namespace

// Vocabulary columns a tile: the caller sizes the (n_split, T) scratch.
extern "C" int cross_entropy_split() { return BN; }

// x: (T, D) bf16 contiguous; w: (D, V) bf16 contiguous; labels: (T,) int32;
// lse, label_logit: (T,) fp32; part_m, part_l, part_ll: (n_split, T) fp32
// scratch.  Needs D % 32 == 0, V % 8 == 0, 0 < n_valid <= V, n_split ==
// ceil(V / 256) and 16-byte aligned x and w.  Returns 0 or a CUDA error
// code; -1 for arguments the kernel does not take.
extern "C" int cross_entropy_fwd(const void* x, const void* w,
                                 const void* labels, void* lse,
                                 void* label_logit, void* part_m,
                                 void* part_l, void* part_ll, int T, int D,
                                 int V, int n_valid, int n_split,
                                 void* stream) {
  if (T <= 0 || D <= 0 || D % 32 != 0 || V <= 0 || V % 8 != 0) return -1;
  if (n_valid <= 0 || n_valid > V) return -1;
  if (n_split != (V + BN - 1) / BN) return -1;
  const int n_tt = (T + BT - 1) / BT;
  const int n_ct = (n_valid + BN - 1) / BN;   // tiles with a valid column
  if ((ll)n_tt * n_ct > INT_MAX) return -1;
  CUtensorMap xm, wm;
  const cuuint64_t xd[2] = {(cuuint64_t)D, (cuuint64_t)T};
  const cuuint64_t xs[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xb[2] = {64, BT};
  const cuuint64_t wd[2] = {(cuuint64_t)V, (cuuint64_t)D};
  const cuuint64_t wst[1] = {(cuuint64_t)V * 2};
  const cuuint32_t wb[2] = {64, BK};
  if (!hp::encode_bf16(&xm, x, 2, xd, xs, xb) ||
      !hp::encode_bf16(&wm, w, 2, wd, wst, wb))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ce_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pll = static_cast<float*>(part_ll);
  const int grid = std::min(n_tt * n_ct, hp::sm_count());
  ce_tile_kernel<<<grid, THREADS, SMEM, s>>>(
      xm, wm, static_cast<const int*>(labels), pm, pl, pll, T, D, n_valid,
      n_tt, n_tt * n_ct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_merge_kernel<<<(T + MERGE_TOKENS - 1) / MERGE_TOKENS,
                    MERGE_TOKENS * MERGE_WARPS, 0, s>>>(
      pm, pl, pll, static_cast<float*>(lse), static_cast<float*>(label_logit),
      T, n_ct);
  return static_cast<int>(cudaGetLastError());
}
