// Grouped expert matmul for Hopper: out[i] = x[i] · w[e_i] over rows sorted
// by expert, fp32 accumulation, one bf16 rounding of each output.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py:61 moe_gmm_pallas (body
// _gmm_kernel), the three expert products of each MoE layer
// (src/repro/models/moe.py:_expert_compute).
//
// What bounds it on the H100, at granite-moe-3b-a800m's serving shapes
// (48 experts, each a 1536 -> 512 swiglu FFN):
//  * prefill (T = 48 x 2048 rows; K 1536, N 512 and K 512, N 1536): 154.6
//    GFLOP of bf16 products (0.156 ms at 989 TFLOP/s) against 478 MB of x,
//    w and out (0.143 ms at 3.35 TB/s): the tensor cores, barely;
//  * decode (T = 48 x 2 rows): the 75.5 MB of weights a call, 0.023 ms.
//
// The function and its guarantees, for any group sizes:
//  * rows are sorted by expert; the group sizes are read on the device (no
//    host sync), each counted as at least 0 and each end cut at T;
//  * every output row is written by exactly one block: no zeroing pass and
//    no accumulation across blocks;
//  * rows past the last group (sum(group_sizes) < T) form one more group,
//    written as zeros, as the TPU kernel's zeroed output tile;
//  * products of bf16 values are exact in fp32 and summed in fp32 (the TPU
//    kernel's fp32 dot of the same values); one bf16 rounding at the end.
//
// Work list.  The TPU grid (T/128, F/512, E) walks every expert for every
// output tile and masks the rows that are not the expert's.  Here each
// expert's rows are cut into row tiles, and a work unit is (expert, row
// tile, column tile).  A block reads the E sizes, takes their prefix sums
// in shared memory (warp 0, a shuffle scan 32 experts at a time) and finds
// a unit's expert by a binary search.  A row tile starts at its expert's
// first row: rows past the expert's last (its neighbour's, or zeros past T)
// are loaded and multiplied but never stored.
//
// Two designs, picked by the caller from T and E (kernels/moe_gmm/kernel.py
// gmm_design); both are right for any sizes, the pick is about speed:
//
// Prefill (moe_gmm_kernel<false>, moe_gmm.cuh): the tensor cores bound it,
// and the mma.sync design reached 2.5-2.9x torch.bmm.  Here:
//  * a persistent grid of one block per SM walks the units; consecutive
//    units are the column tiles of one row tile, so the blocks in flight
//    read each x tile once from device memory and share a few experts'
//    weights in L2;
//  * one producer thread keeps TMA loads in flight into a ring of 3 slices
//    of 64 deep: the x tile (128 rows, a 2-D map over (T, D); rows past T
//    read zeros) and the w tile (256 columns, four 64-column boxes of a 3-D
//    map over (E, D, F), so a slice past D reads zeros and never the next
//    expert's first rows);
//  * two consumer warpgroups each run wgmma m64n256k16 on 64 of the 128
//    rows: x is the K-major A operand, w (K, N) with N contiguous the
//    MN-major B operand, both read from the 128-byte-swizzled TMA tiles;
//    one wgmma group stays in flight while the next slice is waited for.
//    A 128 x 256 tile reads 48 KB from L2 for 4.2 MFLOP a slice; 128 x 128
//    tiles (32 KB for 2.1) were bound by the L2's bandwidth;
//  * every warpgroup multiplies, even one whose rows all lie past the
//    unit's last: a branch around wgmma makes ptxas serialise them;
//  * the epilogue rounds to bf16 into shared memory and stores each of the
//    unit's rows by one bulk copy, which drains while the next unit's
//    products run: at K 512 the 302 MB of output are as much traffic as
//    the products are work (storing from registers left the down product
//    far behind torch.bmm).
// The kernel is a template on w's layout: the backward's dx (moe_gmm_bwd.cu)
// runs it with w read K-major.
//
// Decode (moe_gmm_decode_kernel): at C = 2 rows an expert a 128-row tile
// is almost all idle, and the call is the 75.5 MB of weights.  Here:
//  * the swapped product out^T = w^T · x^T: 64 columns of w are the wgmma
//    M side (A, MN-major) and a row tile of 16 is N (B, K-major), m64n16k16;
//  * units of (expert, 16 rows, 64 columns); a persistent grid of three
//    blocks an SM walks them.  In each block a producer warp streams the
//    units' w panels through one ring of 6 TMA slices of 8 KB (48 KB in
//    flight a block, ~144 KB an SM), the x rows beside them, across unit
//    boundaries; one consumer warpgroup multiplies.  48 experts x F/64
//    columns are 384 or 1152 units, enough to fill the card without a
//    split over K.
#include "moe_gmm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;
using repro::gmm::BK;
using repro::gmm::Groups;
using repro::gmm::Ring;
using repro::gmm::Unit;
using repro::gmm::find_unit;
using repro::gmm::scan_groups;
using repro::gmm::store_zeros;
using repro::gmm::tile_map;

// ---------------------------------------------------------------------------
// decode: out^T = w^T · x^T, 64 columns x 16 rows a unit, wgmma m64n16k16
// ---------------------------------------------------------------------------

constexpr int D_BT = 16;
constexpr int D_BN = 64;
constexpr int D_STAGES = 6;
constexpr int D_W_BYTES = BK * D_BN * 2;             // 8 KB
constexpr int D_X_BYTES = D_BT * BK * 2;             // 2 KB
constexpr int D_STAGE_BYTES = D_W_BYTES + D_X_BYTES; // 10 KB: atoms aligned
constexpr int D_SMEM = D_STAGES * D_STAGE_BYTES + 1024;
constexpr int D_THREADS = 160;                       // 1 consumer WG + 1 warp

__global__ void __launch_bounds__(D_THREADS)
    moe_gmm_decode_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map,
                          const int* __restrict__ group_sizes,
                          bf16* __restrict__ out, int T, int K, int N, int E,
                          int n_col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Groups groups;
  __shared__ __align__(8) uint64_t full[D_STAGES];
  __shared__ __align__(8) uint64_t empty[D_STAGES];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (warp == 0) scan_groups<D_BT>(groups, group_sizes, T, E, lane);
  if (tid == 32) {
    for (int i = 0; i < D_STAGES; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], 128);
    }
    hp::bar_init_fence();
  }
  __syncthreads();

  const int n_units = groups.tile_end[E] * n_col_tiles;
  const int nk = (K + BK - 1) / BK;

  if (warp == 4) {
    // ---- producer ----------------------------------------------------------
    if (lane == 0) {
      Ring<D_STAGES> ring;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const Unit t = find_unit<D_BT, D_BN>(groups, u, n_col_tiles, E);
        if (t.g == E) continue;                      // zeros: nothing to load
        for (int ks = 0; ks < nk; ++ks) {
          hp::bar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &full[ring.stage];
          unsigned char* st = smem + ring.stage * D_STAGE_BYTES;
          hp::bar_arrive_tx(bar, D_STAGE_BYTES);
          hp::tma_load_3d(st, &w_map, bar, t.n0, ks * BK, t.g);
          hp::tma_load_2d(st + D_W_BYTES, &x_map, bar, ks * BK, t.r0);
          ring.next();
        }
      }
    }
  } else {
    // ---- consumer warpgroup ------------------------------------------------
    const int gq = lane / 4, t4 = lane % 4;
    float acc[8] = {};
    Ring<D_STAGES> ring;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit t = find_unit<D_BT, D_BN>(groups, u, n_col_tiles, E);
      if (t.g == E) {
        store_zeros<D_BN>(out + (ll)t.r0 * N + t.n0, N, 0, t.nrows, N - t.n0,
                          tid, 128);
        continue;
      }
      int prev = -1;
      for (int ks = 0; ks < nk; ++ks) {
        hp::bar_wait(&full[ring.stage], ring.phase);
        const uint32_t ws = base + ring.stage * D_STAGE_BYTES;
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hp::Wgmma<D_BT>::ss<1, 0>(acc, hp::desc_mnmajor(ws, kk, D_W_BYTES),
                                    hp::desc_kmajor(ws + D_W_BYTES, kk),
                                    ks > 0 || kk > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<1>();
        if (prev >= 0) hp::bar_arrive(&empty[prev]);
        prev = ring.stage;
        ring.next();
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      hp::bar_arrive(&empty[prev]);
      // acc: column 16·warp + gq (+ 8) of the 64, row 8j + 2·t4 (+ 1) of 16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t.n0 + 16 * warp + gq + 8 * h;
        if (col >= N) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * j + 2 * t4 + e;
            if (r < t.nrows)
              out[(ll)(t.r0 + r) * N + col] =
                  __float2bfloat16_rn(acc[4 * j + 2 * h + e]);
          }
      }
    }
  }
}

// x as a (T, K) map with boxes of 64 x `rows`, w as an (E, K, N) map with
// boxes of 64 x 64 x 1.
bool gmm_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* w,
              int T, int K, int N, int E, int rows) {
  return tile_map(xm, x, T, K, rows) && tile_map(wm, w, K, N, 64, E);
}

}  // namespace

// x: (T, K) bf16 contiguous, rows sorted by expert; w: (E, K, N) bf16
// contiguous; group_sizes: (E,) int32 on the device; out: (T, N) bf16
// contiguous.  Needs K % 8 == 0, N % 8 == 0, 0 < E <= MAX_E and 16-byte
// aligned x, w and out.  Returns 0 or a CUDA error code; -1 for arguments
// the kernel does not take.  moe_gmm_fwd is the prefill design,
// moe_gmm_decode_fwd the decode design; both compute the same function.
extern "C" int moe_gmm_fwd(const void* x, const void* w,
                           const void* group_sizes, void* out, int T, int K,
                           int N, int E, void* stream) {
  if (!repro::gmm::args_ok(T, K, N, E)) return -1;
  CUtensorMap xm, wm;
  if (!gmm_maps(&xm, &wm, x, w, T, K, N, E, repro::gmm::P_BT))
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::gmm::launch_tiles<false>(xm, wm, group_sizes, out, T, K, N,
                                         E, static_cast<cudaStream_t>(stream));
}

extern "C" int moe_gmm_decode_fwd(const void* x, const void* w,
                                  const void* group_sizes, void* out, int T,
                                  int K, int N, int E, void* stream) {
  if (!repro::gmm::args_ok(T, K, N, E)) return -1;
  const int n_col_tiles = (N + D_BN - 1) / D_BN;
  const ll blocks = ((ll)(T + D_BT - 1) / D_BT + E) * n_col_tiles;
  if (blocks > INT_MAX) return -1;
  CUtensorMap xm, wm;
  if (!gmm_maps(&xm, &wm, x, w, T, K, N, E, D_BT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      D_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, moe_gmm_decode_kernel, D_THREADS, D_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::max(per_sm, 1);
  }
  const int grid = (int)std::min(blocks, (ll)per_sm * hp::sm_count());
  moe_gmm_decode_kernel<<<grid, D_THREADS, D_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      xm, wm, static_cast<const int*>(group_sizes), static_cast<bf16*>(out),
      T, K, N, E, n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}
