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
// 478 MB of x, w, dy, dx and dw for both (0.143 ms at 3.35 TB/s).  So each
// product has to run on wgmma, fed by TMA, as the forward's does; the first
// design (mma.sync, cp.async) sat at 3.8x this bound.
//
// The function and its guarantees, for any group sizes:
//  * rows are sorted by expert; the sizes are read on the device (no host
//    sync), each counted as at least 0 and each end cut at T, as in the
//    forward (moe_gmm.cuh's work list);
//  * rows past the last group get dx 0 and give nothing to dw; an expert
//    with no rows gets dw 0;
//  * deterministic: every output element is written by one block, which
//    sums its products in a fixed order, with no atomics and no split over
//    K;
//  * products of bf16 values are exact in fp32 and summed in fp32 (the
//    plain version's fp32 products of the same values); one bf16 rounding.
//
// Design: both products run moe_gmm.cuh's tile design (a persistent grid,
// a ring of 3 TMA slices of 64 deep fed by one producer thread, two
// consumer warpgroups on wgmma m64n256k16, the bulk-copy epilogue):
//  * dx = dy · w[e]^T is the forward's product with w read K-major: M =
//    rows, N = D, K = F.  dy's rows are the K-major A operand, as x's are
//    in the forward, and w[e] as stored (D rows, F contiguous) is wgmma's
//    K-major B, so w^T is never formed.  moe_gmm_kernel<true> runs it over
//    the forward's work list: the w map is 3-D over (E, D, F), one box of
//    64 along F by 256 along D a slice (a box past D or F reads zeros and
//    never the next expert's rows), and the rows past the last group get
//    zeros;
//  * dw[e] = x_e^T · dy_e (gmm_dw_kernel): M = D, N = F, K = the expert's
//    rows.  x's rows hold M contiguous and dy's hold N contiguous, so both
//    operands are MN-major (wgmma ss<1, 1>): a slice is two 64 x 64 boxes
//    of x (one a consumer warpgroup) and four of dy, the forward's 48 KB
//    stage.  A unit is (expert, 128 rows of D, 256 columns of F), the
//    units ordered expert by expert, so that the blocks in flight read one
//    expert's x_e and dy_e from L2; each walks the expert's rows 64 at a
//    time.  Slices start at the expert's first row and TMA fills zeros only
//    past T, so the last slice of an expert whose rows are not a multiple
//    of 64 holds the next expert's first rows: both consumer warpgroups
//    zero those rows in the x and dy tiles before the products read the
//    stage (a whole 128-byte row of a swizzled tile is one row's values),
//    so they add nothing, not even a neighbour's NaN times 0.  An expert
//    with no rows stores a zero tile.
#include "moe_gmm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;
using repro::gmm::BK;
using repro::gmm::Groups;
using repro::gmm::P_A_BYTES;
using repro::gmm::P_BN;
using repro::gmm::P_BOX;
using repro::gmm::P_BT;
using repro::gmm::P_EPI_WARP;
using repro::gmm::P_SMEM;
using repro::gmm::P_STAGE_BYTES;
using repro::gmm::P_STAGES;
using repro::gmm::P_THREADS;
using repro::gmm::PRing;
using repro::gmm::args_ok;
using repro::gmm::consume_unit;
using repro::gmm::launch_tiles;
using repro::gmm::scan_groups;
using repro::gmm::store_rows;
using repro::gmm::store_zeros;
using repro::gmm::tile_map;

// dw's unit: expert e, whose rows are [lo, lo + rows); rows m0.. of dw[e]
// (over D) and columns n0.. (over F)
struct DwUnit {
  int e, lo, rows, m0, n0;
};

__device__ __forceinline__ DwUnit dw_unit(const Groups& s, int u,
                                          int tiles_per_e, int n_col_tiles) {
  DwUnit t;
  t.e = u / tiles_per_e;
  const int tile = u % tiles_per_e;
  t.m0 = (tile / n_col_tiles) * P_BT;
  t.n0 = (tile % n_col_tiles) * P_BN;
  t.lo = t.e == 0 ? 0 : s.row_end[t.e - 1];
  t.rows = s.row_end[t.e] - t.lo;
  return t;
}

// ---------------------------------------------------------------------------
// dw[e] = x_e^T · dy_e: persistent, 128 x 256 tiles of dw[e], K = e's rows
// ---------------------------------------------------------------------------

// x_map: (T, D), dy_map: (T, F), both with 64 x 64 boxes (64 columns, 64
// rows); rows past T read zeros.
__global__ void __launch_bounds__(P_THREADS, 1)
    gmm_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap dy_map,
                  const int* __restrict__ group_sizes, bf16* __restrict__ dw,
                  int T, int D, int F, int E, int n_col_tiles,
                  int tiles_per_e) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Groups groups;
  __shared__ __align__(8) uint64_t full[P_STAGES];
  __shared__ __align__(8) uint64_t empty[P_STAGES];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (warp == 0) scan_groups<BK>(groups, group_sizes, T, E, lane);
  if (tid == 32) {
    for (int i = 0; i < P_STAGES; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], 256);                  // every consumer thread
    }
    hp::bar_init_fence();
  }
  __syncthreads();

  const int n_units = E * tiles_per_e;
  const int wg = warp / 4;
  PRing ring;

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load --------------------
    if (tid == 256) {
      hp::tma_prefetch_map(&x_map);
      hp::tma_prefetch_map(&dy_map);
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const DwUnit t = dw_unit(groups, u, tiles_per_e, n_col_tiles);
        for (int k0 = 0; k0 < t.rows; k0 += BK) {
          hp::bar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &full[ring.stage];
          unsigned char* st = smem + ring.stage * P_STAGE_BYTES;
          hp::bar_arrive_tx(bar, P_STAGE_BYTES);
          const int row = t.lo + k0;
#pragma unroll
          for (int j = 0; j < P_BT / 64; ++j)
            hp::tma_load_2d(st + j * P_BOX, &x_map, bar, t.m0 + 64 * j, row);
#pragma unroll
          for (int j = 0; j < P_BN / 64; ++j)
            hp::tma_load_2d(st + P_A_BYTES + j * P_BOX, &dy_map, bar,
                            t.n0 + 64 * j, row);
          ring.next();
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64·wg .. 64·wg + 63 of the
    // tile: its x box is the wgmma A operand, all four dy boxes are B ------
    const int ctid = tid - wg * 128;
    const int w4 = ctid / 32;
    const uint32_t stg =
        base + P_STAGES * P_STAGE_BYTES + (4 * wg + w4) * P_EPI_WARP;
    float acc[P_BN / 2] = {};
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int rows = dw_unit(groups, u, tiles_per_e, n_col_tiles).rows;
      if (rows > 0) {
        const int nk = (rows + BK - 1) / BK;
        const int valid = rows - (nk - 1) * BK;      // e's rows in the last
        consume_unit<1, 1>(
            acc, ring, full, empty, base, wg, nk, [&](uint32_t st) {
              if (valid == BK) return;
              // rows valid..63 of this warpgroup's x box and of its two dy
              // boxes (the other warpgroup zeroes the other two), then
              // every consumer waits for the zeros before the products
              const int n = (BK - valid) * 8;        // 16-byte chunks a box
              for (int c = ctid; c < 3 * n; c += 128) {
                const int box = c / n, i = c % n;
                const int off = box == 0 ? wg * P_BOX
                                         : P_A_BYTES + (2 * wg + box - 1) *
                                                           P_BOX;
                asm volatile(
                    "st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                        st + off + (valid + i / 8) * 128 + (i % 8) * 16),
                    "r"(0)
                    : "memory");
              }
              hp::fence_proxy_async();
              hp::named_sync(1, 256);
            });
      }
      // the unit's place, read again from shared memory after the
      // products: no register holds it while they run
      const DwUnit t = dw_unit(groups, u, tiles_per_e, n_col_tiles);
      bf16* tile = dw + ((ll)t.e * D + t.m0) * F + t.n0;
      const int m_rows = min(P_BT, D - t.m0);
      if (t.rows == 0) {
        store_zeros<P_BN>(tile, F, min(64 * wg, m_rows),
                          min(64 * wg + 64, m_rows), F - t.n0, ctid, 128);
        continue;
      }
      const int r = 64 * wg + 16 * w4 + lane;
      store_rows(acc, stg, lane < 16 && r < m_rows ? tile + (ll)r * F : nullptr,
                 min(P_BN, F - t.n0) * 2, lane);
    }
    if (lane < 16) hp::bulk_wait();
  }
}

}  // namespace

// x: (T, D), w: (E, D, F), dy: (T, F), dx: (T, D), dw: (E, D, F), all bf16
// contiguous and 16-byte aligned; group_sizes: (E,) int32 on the device.
// Needs D % 8 == 0, F % 8 == 0, 0 < E <= MAX_E.  Launches dx's kernel
// (moe_gmm_kernel<true>), then gmm_dw_kernel, on `stream`.  Returns 0 or a
// CUDA error code; -1 for arguments the kernels do not take.
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* dy,
                           const void* group_sizes, void* dx, void* dw, int T,
                           int D, int F, int E, void* stream) {
  if (!args_ok(T, D, F, E)) return -1;
  const int dw_cols = (F + P_BN - 1) / P_BN;
  const ll tiles_per_e = (ll)((D + P_BT - 1) / P_BT) * dw_cols;
  if (tiles_per_e * E > INT_MAX) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // dx: dy (T, F) in 128-row boxes, w (E, D, F) in 256-row boxes; dw: x
  // and dy in 64-row boxes
  CUtensorMap dym, wm, xm, dyr;
  if (!tile_map(&dym, dy, T, F, P_BT) || !tile_map(&wm, w, D, F, P_BN, E) ||
      !tile_map(&xm, x, T, D, 64) || !tile_map(&dyr, dy, T, F, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_tiles<true>(dym, wm, group_sizes, dx, T, F, D, E, s);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      gmm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (int)std::min(tiles_per_e * E, (ll)hp::sm_count());
  gmm_dw_kernel<<<grid, P_THREADS, P_SMEM, s>>>(
      xm, dyr, static_cast<const int*>(group_sizes), static_cast<bf16*>(dw), T,
      D, F, E, dw_cols, (int)tiles_per_e);
  return static_cast<int>(cudaGetLastError());
}
