// The grouped matmul's shared pieces, used by its forward (moe_gmm.cu) and
// its backward (moe_gmm_bwd.cu).
//
// The work list.  Rows are sorted by expert; the E group sizes are read on
// the device, each counted as at least 0 and each end cut at T, and the
// rows past the last group (sum(group_sizes) < T) form one more group, E.
// Each group's rows are cut into row tiles of BT, and a work unit is
// (group, row tile, column tile): a block takes the sizes' prefix sums in
// shared memory (scan_groups, one warp, a shuffle scan 32 groups at a time)
// and finds a unit's group by a binary search (find_unit).
//
// The tile design on wgmma and TMA (P_*): a persistent grid of one block an
// SM; one producer thread keeps TMA loads in flight into a ring of 3 slices
// of 64 deep, each slice an A tile (128 rows x 64, 16 KB) and a B tile (64
// x 256 columns, 32 KB); two consumer warpgroups each run wgmma m64n256k16
// on 64 of the 128 rows (consume_unit), read from the 128-byte-swizzled
// TMA tiles, one wgmma group in flight while the next slice is waited for;
// the epilogue rounds to bf16 into shared memory and stores each row by one
// bulk copy (store_rows), which drains while the next unit's products run.
// moe_gmm_kernel runs it over the work list, with w[e] as the B operand
// read MN-major (the forward, x · w[e]) or K-major (the backward's dx =
// dy · w[e]^T, no transpose formed); moe_gmm_bwd.cu's gmm_dw_kernel runs
// the same ring with both operands MN-major.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#include <algorithm>

#include "hopper.cuh"

namespace repro {
namespace gmm {

using ll = long long;
using bf16 = __nv_bfloat16;
namespace hp = repro::hopper;

constexpr int MAX_E = 512;     // experts a call may have (MAX_EXPERTS in
                               // kernels/moe_gmm/kernel.py)

// What the kernels take: K and N multiples of 8 (16-byte rows for TMA and
// the bulk stores), 0 < E <= MAX_E.
inline bool args_ok(int T, int K, int N, int E) {
  return T > 0 && K > 0 && N > 0 && K % 8 == 0 && N % 8 == 0 && E > 0 &&
         E <= MAX_E;
}

// group g's end row and the row tiles of groups 0..g; group E is the rows
// past the last expert's
struct Groups {
  int row_end[MAX_E + 1];
  int tile_end[MAX_E + 1];
};

template <int BT>
__device__ void scan_groups(Groups& s, const int* __restrict__ group_sizes,
                            int T, int E, int lane) {
  ll row_carry = 0;
  int tile_carry = 0, prev_end = 0;
  for (int base = 0; base <= E; base += 32) {
    const int g = base + lane;
    // a size counts as at least 0; the group of the rest takes all of T,
    // and every end is cut at T
    ll v = g < E ? (ll)max(group_sizes[g], 0) : (g == E ? (ll)T : 0);
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const ll n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    const int end = (int)min(row_carry + v, (ll)T);
    int start = __shfl_up_sync(0xffffffffu, end, 1);
    if (lane == 0) start = prev_end;
    int tv = (end - start + BT - 1) / BT;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int n = __shfl_up_sync(0xffffffffu, tv, off);
      if (lane >= off) tv += n;
    }
    if (g <= E) {
      s.row_end[g] = end;
      s.tile_end[g] = tile_carry + tv;
    }
    row_carry += __shfl_sync(0xffffffffu, v, 31);
    prev_end = __shfl_sync(0xffffffffu, end, 31);
    tile_carry += __shfl_sync(0xffffffffu, tv, 31);
  }
}

struct Unit {
  int g;        // expert, or E for the rows past the last group
  int r0;       // first row
  int nrows;    // rows of the expert in this tile, 1..BT
  int n0;       // first output column
};

// Unit u of the list: row tile u / n_col_tiles, column tile u % n_col_tiles.
template <int BT, int BN>
__device__ __forceinline__ Unit find_unit(const Groups& s, int u,
                                          int n_col_tiles, int E) {
  const int tile = u / n_col_tiles;
  int lo = 0, hi = E;                              // first g: tile_end > tile
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s.tile_end[mid] > tile) hi = mid;
    else lo = mid + 1;
  }
  Unit t;
  t.g = lo;
  const int g_row0 = lo == 0 ? 0 : s.row_end[lo - 1];
  const int g_tile0 = lo == 0 ? 0 : s.tile_end[lo - 1];
  t.r0 = g_row0 + (tile - g_tile0) * BT;
  t.nrows = min(BT, s.row_end[lo] - t.r0);
  t.n0 = (u % n_col_tiles) * BN;
  return t;
}

// Zeros for rows [r_lo, r_hi) of a tile whose first element is `out` (rows
// `pitch` elements apart), columns [0, min(BN, ncols)); `nthr` threads from
// `tid`.
template <int BN>
__device__ void store_zeros(bf16* __restrict__ out, ll pitch, int r_lo,
                            int r_hi, int ncols, int tid, int nthr) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < (r_hi - r_lo) * (BN / 8); c += nthr) {
    const int r = r_lo + c / (BN / 8);
    const int col = (c % (BN / 8)) * 8;            // ncols % 8 == 0
    if (col < ncols) *reinterpret_cast<uint4*>(out + r * pitch + col) = zero;
  }
}

// A slot of a ring of S stages and the parity of its current phase.
template <int S>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------------------------
// the tile design: 128 x 256 tiles, 64-deep slices, wgmma m64n256k16
// ---------------------------------------------------------------------------

constexpr int BK = 64;         // depth of one slice: one 128-byte box row
constexpr int P_BT = 128;
constexpr int P_BN = 256;
constexpr int P_STAGES = 3;
constexpr int P_A_BYTES = P_BT * BK * 2;             // 16 KB
constexpr int P_BOX = BK * 64 * 2;                   // 8 KB: 64 x 64
constexpr int P_STAGE_BYTES = P_A_BYTES + (P_BN / 64) * P_BOX;   // 48 KB
// the epilogue's staging rows: 16 a consumer warp, padded by 16 bytes so
// that the 8 rows one store instruction writes fall in distinct banks
constexpr int P_EPI_PITCH = P_BN * 2 + 16;
constexpr int P_EPI_WARP = 16 * P_EPI_PITCH;
constexpr int P_SMEM =
    P_STAGES * P_STAGE_BYTES + 8 * P_EPI_WARP + 1024;   // + alignment
constexpr int P_THREADS = 384;                       // 2 consumer WGs + 1

using PRing = Ring<P_STAGES>;

// One slice's products into a consumer warpgroup's 64 x 256 accumulator: A
// (the warpgroup's 64 rows, 64 deep) at shared address `a`, B (64 deep x
// 256 columns) at `b`.  TA / TB = 1 for an MN-major operand, read as 64-wide
// boxes P_BOX apart; a K-major operand is rows of 128 bytes.
template <int TA, int TB>
__device__ __forceinline__ void mma_slice(float (&acc)[P_BN / 2], uint32_t a,
                                          uint32_t b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    hp::Wgmma<P_BN>::ss<TA, TB>(
        acc, TA ? hp::desc_mnmajor(a, kk, P_BOX) : hp::desc_kmajor(a, kk),
        TB ? hp::desc_mnmajor(b, kk, P_BOX) : hp::desc_kmajor(b, kk),
        accumulate || kk > 0);
}

// A unit's nk (>= 1) slices from the ring into acc (overwritten): one wgmma
// group stays in flight while the next slice is waited for, and each slot
// is released once its products are done.  last_slice(stage address) runs
// on the last slice before its products, in both consumer warpgroups.
template <int TA, int TB, class LastSlice>
__device__ __forceinline__ void consume_unit(float (&acc)[P_BN / 2],
                                             PRing& ring, uint64_t* full,
                                             uint64_t* empty, uint32_t base,
                                             int wg, int nk,
                                             LastSlice last_slice) {
  int prev = -1;
  for (int ks = 0; ks < nk; ++ks) {
    hp::bar_wait(&full[ring.stage], ring.phase);
    const uint32_t st = base + ring.stage * P_STAGE_BYTES;
    if (ks == nk - 1) last_slice(st);
    hp::wgmma_fence();
    mma_slice<TA, TB>(acc, st + wg * (P_A_BYTES / 2), st + P_A_BYTES, ks > 0);
    hp::wgmma_commit();
    // the products of the previous slice are done: release its stage
    hp::wgmma_wait<1>();
    if (prev >= 0) hp::bar_arrive(&empty[prev]);
    prev = ring.stage;
    ring.next();
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
  hp::bar_arrive(&empty[prev]);
}

// A consumer warp's epilogue: its 16 rows of the tile (acc: row lane/4
// (+ 8), columns 8j + 2·(lane%4) (+ 1)) rounded to bf16 into its staging
// rows `stg`, then lane r < 16 stores row r by one bulk copy of `bytes` to
// `dst` (null: that row is not stored).  The copies drain while the warp
// computes its next unit; the staging rows are written again only after
// they have been read.
__device__ __forceinline__ void store_rows(const float (&acc)[P_BN / 2],
                                           uint32_t stg, bf16* dst,
                                           uint32_t bytes, int lane) {
  const int gq = lane / 4, t4 = lane % 4;
  if (lane < 16) hp::bulk_wait_read();
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < P_BN / 8; ++j) {
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                               acc[4 * j + 2 * h + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       stg + (gq + 8 * h) * P_EPI_PITCH + (8 * j + 2 * t4) * 2),
                   "r"(*reinterpret_cast<uint32_t*>(&v))
                   : "memory");
    }
  hp::fence_proxy_async();
  __syncwarp();
  if (dst != nullptr) {
    hp::bulk_store(dst, stg + lane * P_EPI_PITCH, bytes);
    hp::bulk_commit();
  }
}

// out = x · B over the work list, where B is w[e] as (K, N) with N
// contiguous (W_KMAJOR false: the forward) or as (N, K) with K contiguous
// (W_KMAJOR true: the backward's dx, whose N is w's D and K its F).  x_map:
// (T, K), boxes of 64 x 128 rows (rows past T read zeros); w_map: (E, K, N)
// with 64 x 64 boxes, four a slice, or (E, N, K) with 64 x 256 boxes, one
// a slice; either way a box past K or N reads zeros and never the next
// expert's rows.  A row tile starts at its expert's first row: rows past
// the expert's last are multiplied but never stored; the units of the rows
// past the last group store zeros.
template <bool W_KMAJOR>
__global__ void __launch_bounds__(P_THREADS, 1)
    moe_gmm_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const int* __restrict__ group_sizes, bf16* __restrict__ out,
                   int T, int K, int N, int E, int n_col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Groups groups;
  __shared__ __align__(8) uint64_t full[P_STAGES];
  __shared__ __align__(8) uint64_t empty[P_STAGES];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (warp == 0) scan_groups<P_BT>(groups, group_sizes, T, E, lane);
  if (tid == 32) {
    for (int i = 0; i < P_STAGES; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], 256);                  // every consumer thread
    }
    hp::bar_init_fence();
  }
  __syncthreads();

  const int n_units = groups.tile_end[E] * n_col_tiles;
  const int nk = (K + BK - 1) / BK;
  const int wg = warp / 4;
  PRing ring;

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load --------------------
    if (tid == 256) {
      hp::tma_prefetch_map(&x_map);
      hp::tma_prefetch_map(&w_map);
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const Unit t = find_unit<P_BT, P_BN>(groups, u, n_col_tiles, E);
        if (t.g == E) continue;                      // zeros: nothing to load
        for (int ks = 0; ks < nk; ++ks) {
          hp::bar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &full[ring.stage];
          unsigned char* st = smem + ring.stage * P_STAGE_BYTES;
          hp::bar_arrive_tx(bar, P_STAGE_BYTES);
          hp::tma_load_2d(st, &x_map, bar, ks * BK, t.r0);
          if (W_KMAJOR) {
            hp::tma_load_3d(st + P_A_BYTES, &w_map, bar, ks * BK, t.n0, t.g);
          } else {
#pragma unroll
            for (int j = 0; j < P_BN / 64; ++j)
              hp::tma_load_3d(st + P_A_BYTES + j * P_BOX, &w_map, bar,
                              t.n0 + 64 * j, ks * BK, t.g);
          }
          ring.next();
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64·wg .. 64·wg + 63 ----------
    const int ctid = tid - wg * 128;
    const int w4 = ctid / 32;
    const uint32_t stg =
        base + P_STAGES * P_STAGE_BYTES + (4 * wg + w4) * P_EPI_WARP;
    float acc[P_BN / 2] = {};
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit t = find_unit<P_BT, P_BN>(groups, u, n_col_tiles, E);
      if (t.g == E) {
        store_zeros<P_BN>(out + (ll)t.r0 * N + t.n0, N, min(64 * wg, t.nrows),
                          min(64 * wg + 64, t.nrows), N - t.n0, ctid, 128);
        continue;
      }
      // (a warpgroup whose rows all lie past the unit's last multiplies
      // anyway: a branch around wgmma makes the compiler serialise them)
      consume_unit<0, W_KMAJOR ? 0 : 1>(acc, ring, full, empty, base, wg, nk,
                                        [](uint32_t) {});
      const int r = 64 * wg + 16 * w4 + lane;
      store_rows(acc, stg,
                 lane < 16 && r < t.nrows ? out + (ll)(t.r0 + r) * N + t.n0
                                          : nullptr,
                 min(P_BN, N - t.n0) * 2, lane);
    }
    if (lane < 16) hp::bulk_wait();
  }
}

// A bf16 map of (rows, cols), cols contiguous, with boxes of 64 columns by
// `box_rows`; of (E, rows, cols) where E > 0, a box in one matrix.
inline bool tile_map(CUtensorMap* m, const void* p, int rows, int cols,
                     int box_rows, int E = 0) {
  const cuuint64_t d[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t s[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t b[3] = {64, (cuuint32_t)box_rows, 1};
  return hp::encode_bf16(m, p, E > 0 ? 3 : 2, d, s, b);
}

// Launches moe_gmm_kernel<W_KMAJOR> on `stream` over a persistent grid of
// one block an SM (fewer where the units are fewer).  Returns 0 or a CUDA
// error code; -1 for more units than an int counts.
template <bool W_KMAJOR>
inline int launch_tiles(const CUtensorMap& xm, const CUtensorMap& wm,
                        const void* group_sizes, void* out, int T, int K,
                        int N, int E, cudaStream_t stream) {
  const int n_col_tiles = (N + P_BN - 1) / P_BN;
  const ll units = ((ll)(T + P_BT - 1) / P_BT + E) * n_col_tiles;
  if (units > INT_MAX) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_kernel<W_KMAJOR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (int)std::min(units, (ll)hp::sm_count());
  moe_gmm_kernel<W_KMAJOR><<<grid, P_THREADS, P_SMEM, stream>>>(
      xm, wm, static_cast<const int*>(group_sizes), static_cast<bf16*>(out),
      T, K, N, E, n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmm
}  // namespace repro
