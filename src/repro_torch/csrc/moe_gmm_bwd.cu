// Grouped expert matmul backward for Hopper: for out = moe_gmm(x, w, sizes)
// and the upstream gradient dy, dx[i] = dy[i] · w[e_i]^T and dw[e] =
// x_e^T · dy_e over expert e's rows, fp32 accumulation, one bf16 rounding of
// each output.
//
// Replaces: nothing on the TPU (no Pallas counterpart).  The TPU kernel
// src/repro/kernels/moe_gmm/kernel.py:61 moe_gmm_pallas has no custom_vjp;
// this computes the gradient of src/repro/kernels/moe_gmm/ref.py's
// moe_gmm_ref, the function the forward kernel (moe_gmm.cu) computes, as
// the flash and rmsnorm backwards target their ref.py.
//
// What bounds it on the H100, at granite-moe-3b-a800m's training shapes
// (48 experts of 2048 rows: T = 98,304; gate and up at D 1536 -> F 512,
// down at 512 -> 1536): operations.  Each of the two products is
// 2 · 98,304 · 1536 · 512 = 154.6 GFLOP, 0.156 ms at 989 TFLOP/s, against
// 478 MB of x, w, dy, dx and dw for both (0.143 ms at 3.35 TB/s).
//
// The function and its guarantees, for any group sizes:
//  * rows are sorted by expert; the sizes are read on the device (no host
//    sync), each counted as at least 0 and each end cut at T, as in the
//    forward (moe_gmm.cuh's work list);
//  * rows past the last group get dx 0 and give nothing to dw; an expert
//    with no rows gets dw 0;
//  * deterministic: every output element is written by one block, which
//    sums its products in a fixed order, with no atomics;
//  * products of bf16 values are exact in fp32 and summed in fp32 (the
//    plain version's fp32 products of the same values); one bf16 rounding.
//
// Design (simple first; a later change can move it to wgmma and TMA):
//  * gmm_dx_kernel: the forward's work list with the weight read
//    transposed in place.  A unit is (expert, 128 rows, 128 columns of
//    D); dy's rows (K = F contiguous) are the A operand and w[e]'s rows (D
//    rows, F contiguous) are already the "col" B operand of mma.sync, so
//    w^T is never formed.
//    A row tile starts at its expert's first row: rows past the expert's
//    last are multiplied but never stored; the rows past the last group
//    are stored as zeros.  The grid is the units' upper bound, (T/128 + E)
//    row tiles x D/128; blocks past the last unit return at once;
//  * gmm_dw_kernel: one block per (128 rows of D, 128 columns of F, expert),
//    which walks the expert's rows 32 at a time and sums x^T · dy over
//    them (K = the expert's rows); x and dy tiles are read row-major and
//    transposed by ldmatrix.trans.  Rows past the expert's last are loaded
//    as zeros, so they add nothing;
//  * both: 8 warps of 64 x 32 each (16 mma.sync m16n8k16 a 16-deep step),
//    a 3-stage cp.async ring of 32-deep slices, shared-memory rows padded
//    by 16 bytes so that the 8 rows an ldmatrix reads fall in distinct
//    banks; the K and N tails load zeros (D, F multiples of 8: a 16-byte
//    chunk lies wholly inside or outside).
#include "common.cuh"
#include "moe_gmm.cuh"

#include <limits.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
using repro::gmm::Groups;
using repro::gmm::MAX_E;
using repro::gmm::Unit;
using repro::gmm::find_unit;
using repro::gmm::scan_groups;

constexpr int BM = 128;          // output rows a block
constexpr int BN = 128;          // output columns a block
constexpr int BK = 32;           // depth of one slice
constexpr int STAGES = 3;
constexpr int THREADS = 256;     // 8 warps: 2 (rows) x 4 (columns)

// dx: A = dy rows (BM x BK), B = w[e] rows (BN x BK); K contiguous in both
constexpr int DX_PITCH = BK + 8;                     // 80-byte rows
constexpr int DX_TILE = BM * DX_PITCH;               // elements
constexpr int DX_SMEM = STAGES * 2 * DX_TILE * 2;    // 61,440 bytes
// dw: A = x rows (BK x BM), B = dy rows (BK x BN); M or N contiguous
constexpr int DW_PITCH = BM + 8;                     // 272-byte rows
constexpr int DW_TILE = BK * DW_PITCH;
constexpr int DW_SMEM = STAGES * 2 * DW_TILE * 2;    // 52,224 bytes

// The warp's 64 x 32 tile of a block's 128 x 128: 4 x 4 m16n8 fragments.
using Acc = float[4][4][4];

// acc (row 16i + g (+8), column 8j + 2t (+1) of the warp's tile) rounded to
// bf16 into out, rows [r_lo, r_hi) and columns below n_hi kept.
__device__ __forceinline__ void store_tile(const Acc& acc, bf16* out,
                                           ll pitch, int r0, int c0,
                                           int r_lo, int r_hi, int n_hi,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * i + g + 8 * h;
      if (r < r_lo || r >= r_hi) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c < n_hi)
          *reinterpret_cast<uint32_t*>(out + (ll)r * pitch + c) =
              repro::pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// dx = dy · w[e]^T over the forward's work list
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
    gmm_dx_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                  const int* __restrict__ group_sizes, bf16* __restrict__ dx,
                  int T, int D, int F, int E, int n_col_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Groups groups;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (warp == 0) scan_groups<BM>(groups, group_sizes, T, E, lane);
  __syncthreads();
  const int u = blockIdx.x;
  if (u >= groups.tile_end[E] * n_col_tiles) return;
  const Unit t = find_unit<BM, BN>(groups, u, n_col_tiles, E);
  const int wm = warp / 4, wn = warp % 4;            // 64-row, 32-col tile

  if (t.g == E) {                                    // past the last group
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = tid; c < t.nrows * (BN / 8); c += THREADS) {
      const int col = t.n0 + (c % (BN / 8)) * 8;
      if (col < D)
        *reinterpret_cast<uint4*>(dx + (ll)(t.r0 + c / (BN / 8)) * D + col) =
            zero;
    }
    return;
  }

  const bf16* we = w + (ll)t.g * D * F;
  const int nk = (F + BK - 1) / BK;
  // one slice: 128 rows x 4 chunks of A and of B, 4 chunks a thread
  auto load = [&](int ks) {
    if (ks < nk) {
      bf16* a = smem + (ks % STAGES) * 2 * DX_TILE;
      bf16* b = a + DX_TILE;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * THREADS;             // 0..511
        const int r = c / 4, k = ks * BK + (c % 4) * 8;
        const int row = t.r0 + r, col = t.n0 + r;
        const bool ka = k < F;
        repro::cp_async_16(repro::smem_u32(a + r * DX_PITCH + (c % 4) * 8),
                           dy + (ll)min(row, T - 1) * F + (ka ? k : 0),
                           ka && row < T ? 16 : 0);
        repro::cp_async_16(repro::smem_u32(b + r * DX_PITCH + (c % 4) * 8),
                           we + (ll)min(col, D - 1) * F + (ka ? k : 0),
                           ka && col < D ? 16 : 0);
      }
    }
    repro::cp_async_commit();
  };

  Acc acc = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int ks = 0; ks < nk; ++ks) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(ks + STAGES - 1);
    const bf16* a = smem + (ks % STAGES) * 2 * DX_TILE;
    const bf16* b = a + DX_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + 16 * i + (lane % 8) + 8 * ((lane / 8) % 2);
        const int k = 16 * kk + 8 * (lane / 16);
        repro::ldmatrix_x4(af[i], repro::smem_u32(a + r * DX_PITCH + k));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + 16 * j + (lane % 8) + 8 * (lane / 16);
        const int k = 16 * kk + 8 * ((lane / 8) % 2);
        repro::ldmatrix_x4(bfr[j], repro::smem_u32(b + n * DX_PITCH + k));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          repro::mma_bf16_16816(acc[i][j], af[i], bfr[j / 2][2 * (j % 2)],
                                bfr[j / 2][2 * (j % 2) + 1]);
    }
  }
  repro::cp_async_wait<0>();
  store_tile(acc, dx, D, t.r0 + wm * 64, t.n0 + wn * 32, t.r0,
             t.r0 + t.nrows, D, lane);
}

// ---------------------------------------------------------------------------
// dw[e] = x_e^T · dy_e, one block per (128 x 128 tile of dw[e], expert)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
    gmm_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  const int* __restrict__ group_sizes, bf16* __restrict__ dw,
                  int T, int D, int F, int E, int n_col_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bounds[2];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.y;
  const int m0 = (blockIdx.x / n_col_tiles) * BM;    // rows of dw[e]: D
  const int n0 = (blockIdx.x % n_col_tiles) * BN;    // columns: F
  if (warp == 0) {
    // expert e's rows: the sizes before it summed, each at least 0, and
    // both ends cut at T
    ll before = 0;
    for (int i = lane; i < e; i += 32) before += max(group_sizes[i], 0);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      before += __shfl_xor_sync(0xffffffffu, before, off);
    if (lane == 0) {
      const ll lo = min(before, (ll)T);
      bounds[0] = (int)lo;
      bounds[1] = (int)min(lo + max(group_sizes[e], 0), (ll)T);
    }
  }
  __syncthreads();
  const int lo = bounds[0], hi = bounds[1];
  const int wm = warp / 4, wn = warp % 4;
  const int nk = (hi - lo + BK - 1) / BK;

  // one slice: 32 rows x 16 chunks of x (columns m0..) and of dy (n0..),
  // 4 chunks a thread; rows at or past hi read zeros
  auto load = [&](int ks) {
    if (ks < nk) {
      bf16* a = smem + (ks % STAGES) * 2 * DW_TILE;
      bf16* b = a + DW_TILE;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * THREADS;             // 0..511
        const int r = c / 16, ch = (c % 16) * 8;
        const int row = lo + ks * BK + r;
        const bool in = row < hi;
        const ll src_row = (ll)(in ? row : lo);
        const int mc = m0 + ch, nc = n0 + ch;
        repro::cp_async_16(repro::smem_u32(a + r * DW_PITCH + ch),
                           x + src_row * D + (mc < D ? mc : 0),
                           in && mc < D ? 16 : 0);
        repro::cp_async_16(repro::smem_u32(b + r * DW_PITCH + ch),
                           dy + src_row * F + (nc < F ? nc : 0),
                           in && nc < F ? 16 : 0);
      }
    }
    repro::cp_async_commit();
  };

  Acc acc = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int ks = 0; ks < nk; ++ks) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(ks + STAGES - 1);
    const bf16* a = smem + (ks % STAGES) * 2 * DW_TILE;
    const bf16* b = a + DW_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bfr[2][4];
      // A[m][k] = x[k][m]: matrix q of the four is (m half q % 2, k half
      // q / 2); the stored rows are k, transposed by ldmatrix
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = lane / 8;
        const int k = 16 * kk + (lane % 8) + 8 * (q / 2);
        const int m = wm * 64 + 16 * i + 8 * (q % 2);
        repro::ldmatrix_x4_trans(af[i], repro::smem_u32(a + k * DW_PITCH + m));
      }
      // B[k][n] = dy[k][n]: matrix q is (k half q % 2, n block q / 2)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = lane / 8;
        const int k = 16 * kk + (lane % 8) + 8 * (q % 2);
        const int n = wn * 32 + 16 * j + 8 * (q / 2);
        repro::ldmatrix_x4_trans(bfr[j], repro::smem_u32(b + k * DW_PITCH + n));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          repro::mma_bf16_16816(acc[i][j], af[i], bfr[j / 2][2 * (j % 2)],
                                bfr[j / 2][2 * (j % 2) + 1]);
    }
  }
  repro::cp_async_wait<0>();
  store_tile(acc, dw + (ll)e * D * F, F, m0 + wm * 64, n0 + wn * 32, 0, D, F,
             lane);
}

}  // namespace

// x: (T, D), w: (E, D, F), dy: (T, F), dx: (T, D), dw: (E, D, F), all bf16
// contiguous and 16-byte aligned; group_sizes: (E,) int32 on the device.
// Needs D % 8 == 0, F % 8 == 0, 0 < E <= MAX_E.  Launches gmm_dx_kernel,
// then gmm_dw_kernel, on `stream`.  Returns 0 or a CUDA error code; -1 for
// arguments the kernels do not take.
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           const void* group_sizes, void* dx, void* dw, int T,
                           int D, int F, int E, void* stream) {
  if (T <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 || E <= 0 || E > MAX_E)
    return -1;
  const int dx_cols = (D + BN - 1) / BN;
  const ll dx_units = ((ll)(T + BM - 1) / BM + E) * dx_cols;
  const ll dw_tiles = (ll)((D + BM - 1) / BM) * ((F + BN - 1) / BN);
  if (dx_units > INT_MAX || dw_tiles > INT_MAX) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_dx_kernel<<<(int)dx_units, THREADS, DX_SMEM, s>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(dx), T, D, F,
      E, dx_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      gmm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  gmm_dw_kernel<<<dim3((unsigned)dw_tiles, E), THREADS, DW_SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(dw), T, D, F,
      E, (F + BN - 1) / BN);
  return static_cast<int>(cudaGetLastError());
}
