// Grouped expert matmul for Hopper: out[i] = x[i] · w[e_i] over rows sorted
// by expert, fp32 accumulation, one bf16 rounding of each output.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py:moe_gmm_pallas (body
// _gmm_kernel), the three expert products of each MoE layer
// (src/repro/models/moe.py:_expert_compute).
//
// What bounds it on the H100, at granite-moe-3b-a800m's serving shapes
// (48 experts, each a 1536 -> 512 swiglu FFN):
//  * prefill gate/up (T = 48 x 2048 rows, K 1536, N 512): 154.6 GFLOP of
//    bf16 products (0.156 ms at 989 TFLOP/s) against 478 MB of x, w and out
//    (0.143 ms at 3.35 TB/s): about balanced;
//  * decode (T = 48 x 2 rows): the 75.5 MB of weights a call, 0.023 ms.
//
// Design:
//  * the TPU grid (T/128, F/512, E) walks every expert for every output tile
//    and masks the rows that are not the expert's, accumulating in place.
//    Carried over block by block, a decode call (T = 96) would be 4 blocks,
//    each streaming all 48 experts' weights in turn.  Here tiles are
//    scheduled by expert: each expert's rows are cut into row tiles of 128,
//    and one block computes one (expert, row tile, 128 output columns).  A
//    decode call is then 48 row tiles x 4 (or 12) column tiles, and the
//    weights of the call stream through ~200-600 blocks at once;
//  * the (expert, row tile) pairs number at most ceil(T/128) + E, so the
//    grid is that bound x the column tiles.  Each block reads the E group
//    sizes from device memory (no host sync), takes their prefix sums in
//    shared memory (warp 0, a shuffle scan 32 experts at a time), and finds
//    its pair by a binary search; blocks past the real count exit at once;
//  * rows past the last expert's (sum(group_sizes) < T) form one more group
//    whose blocks write zeros, as the TPU kernel's zeroed output tile.
//    Every output row is written by exactly one block: no zeroing pass and
//    no accumulation across blocks;
//  * x·w runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    accumulators; products of bf16 values are exact in fp32, as in the TPU
//    kernel's fp32 dot of the same values); 8 warps as 4 (rows) x 2
//    (columns), each warp a 32 x 64 tile; x and w are staged through shared
//    memory in 32-deep slices by cp.async, three slices in flight;
//    ldmatrix (transposed for w, which is (K, N) row-major) feeds the
//    products; rows are padded by 16 bytes for conflict-free reads (the tile
//    loop of cross_entropy.cu);
//  * the row tile is cut at the expert's last row: rows past it are
//    zero-filled on load without reading memory, never stored, and a warp
//    whose 32 rows all lie past it skips its products (a decode tile holds 2
//    rows, so 3 of its 4 row warps idle);
//  * consecutive blocks are the column tiles of one row tile, so the x tile
//    is read from device memory once and from L2 by the others, and the
//    blocks in flight share a few experts' weights in L2.
// Later work: wgmma + TMA with a warp-specialised producer; for decode a
// row tile of 16 (one mma row block) and a split over K.
#include "common.cuh"

#include <limits.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int BT = 128;        // rows per tile
constexpr int BN = 128;        // output columns per tile
constexpr int BKD = 32;        // depth of one staged slice
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;
constexpr int MAX_E = 512;     // experts a call may have (MAX_EXPERTS in
                               // kernels/moe_gmm/kernel.py)
constexpr int LDX = BKD + 8;   // padded pitch of the x slice (elements)
constexpr int LDW = BN + 8;    // padded pitch of the w slice
constexpr int X_ELEMS = BT * LDX;
constexpr int W_ELEMS = BKD * LDW;
constexpr int STAGE_ELEMS = X_ELEMS + W_ELEMS;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(bf16);

__global__ void __launch_bounds__(NTHREADS)
    moe_gmm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ group_sizes, bf16* __restrict__ out,
                   int T, int K, int N, int E, int n_col_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  // group g's end row and the row tiles of groups 0..g; group E is the rows
  // past the last expert's
  __shared__ int s_row_end[MAX_E + 1];
  __shared__ int s_tile_end[MAX_E + 1];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  if (warp == 0) {
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
        s_row_end[g] = end;
        s_tile_end[g] = tile_carry + tv;
      }
      row_carry += __shfl_sync(0xffffffffu, v, 31);
      prev_end = __shfl_sync(0xffffffffu, end, 31);
      tile_carry += __shfl_sync(0xffffffffu, tv, 31);
    }
  }
  __syncthreads();

  const int tile = blockIdx.x / n_col_tiles;
  const int n0 = (blockIdx.x % n_col_tiles) * BN;
  if (tile >= s_tile_end[E]) return;               // past the real tiles
  int lo = 0, hi = E;                              // first g: tile_end > tile
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (s_tile_end[mid] > tile) hi = mid;
    else lo = mid + 1;
  }
  const int g = lo;
  const int g_row0 = g == 0 ? 0 : s_row_end[g - 1];
  const int g_tile0 = g == 0 ? 0 : s_tile_end[g - 1];
  const int r0 = g_row0 + (tile - g_tile0) * BT;
  const int nrows = min(BT, s_row_end[g] - r0);

  if (g == E) {                                    // rows of no expert: 0
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int c = tid; c < nrows * (BN / 8); c += NTHREADS) {
      const int r = c / (BN / 8);
      const int col = n0 + (c % (BN / 8)) * 8;     // N % 8 == 0
      if (col < N)
        *reinterpret_cast<uint4*>(out + (ll)(r0 + r) * N + col) = zero;
    }
    return;
  }

  const bf16* wg = w + (ll)g * K * N;
  const int wt = warp & 3, wn = warp >> 2;         // 4 row x 2 column warps
  const int gq = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const bool active = wt * 32 < nrows;             // a row of this warp is real
  const int nk = (K + BKD - 1) / BKD;

  auto load_stage = [&](int ks, int slot) {
    const int d0 = ks * BKD;
    bf16* sX = smem + slot * STAGE_ELEMS;
    bf16* sW = sX + X_ELEMS;
#pragma unroll
    for (int j = 0; j < BT * BKD / 8 / NTHREADS; ++j) {   // x: 4 chunks a row
      const int c = tid + j * NTHREADS;
      const int r = c / (BKD / 8);
      const int col = (c % (BKD / 8)) * 8;
      const bool ok = r < nrows && d0 + col < K;          // K % 8 == 0
      const bf16* src = ok ? x + (ll)(r0 + r) * K + d0 + col : x;
      repro::cp_async_16(repro::smem_u32(sX + r * LDX + col), src,
                         ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < BKD * BN / 8 / NTHREADS; ++j) {   // w: 16 chunks a row
      const int c = tid + j * NTHREADS;
      const int r = c / (BN / 8);
      const int col = (c % (BN / 8)) * 8;
      const bool ok = d0 + r < K && n0 + col < N;         // N % 8 == 0
      const bf16* src = ok ? wg + (ll)(d0 + r) * N + n0 + col : wg;
      repro::cp_async_16(repro::smem_u32(sW + r * LDW + col), src,
                         ok ? 16 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    repro::cp_async_commit();
  }

  for (int ks = 0; ks < nk; ++ks) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice ks landed; every warp is done with ks - 1
    const int nxt = ks + STAGES - 1;
    if (nxt < nk) load_stage(nxt, nxt % STAGES);
    repro::cp_async_commit();
    if (!active) continue;

    const bf16* sX = smem + (ks % STAGES) * STAGE_ELEMS;
    const bf16* sW = sX + X_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BKD / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wt * 32 + mt * 16 + (lane % 16);
        const int col = kk * 16 + (lane / 16) * 8;
        repro::ldmatrix_x4(af[mt], repro::smem_u32(sX + row * LDX + col));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        const int row = kk * 16 + mr + 8 * (mi & 1);
        const int col = wn * 64 + np * 16 + 8 * (mi >> 1);
        repro::ldmatrix_x4_trans(bfr, repro::smem_u32(sW + row * LDW + col));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          repro::mma_bf16_16816(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          repro::mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  repro::cp_async_wait_all();
  if (!active) return;

  // each thread holds rows gq and gq + 8 of each 16-row block, columns
  // 2·t4 and 2·t4 + 1 of each 8-column block: one bf16 pair a store
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wt * 32 + mt * 16 + gq + h * 8;
      if (r >= nrows) continue;
      bf16* orow = out + (ll)(r0 + r) * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + 2 * t4;
        if (col < N)
          *reinterpret_cast<uint32_t*>(orow + col) =
              repro::pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

}  // namespace

// x: (T, K) bf16 contiguous, rows sorted by expert; w: (E, K, N) bf16
// contiguous; group_sizes: (E,) int32 on the device; out: (T, N) bf16
// contiguous.  Needs K % 8 == 0, N % 8 == 0, 0 < E <= MAX_E and 16-byte
// aligned x, w and out.  Returns 0 or a CUDA error code; -1 for arguments
// the kernel does not take.
extern "C" int moe_gmm_fwd(const void* x, const void* w,
                           const void* group_sizes, void* out, int T, int K,
                           int N, int E, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0) return -1;
  if (E <= 0 || E > MAX_E) return -1;
  const int n_col_tiles = (N + BN - 1) / BN;
  const ll blocks = ((ll)(T + BT - 1) / BT + E) * n_col_tiles;
  if (blocks > INT_MAX) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_gmm_kernel<<<(unsigned)blocks, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), T, K, N,
      E, n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}
