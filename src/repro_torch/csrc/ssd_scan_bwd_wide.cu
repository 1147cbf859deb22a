// Backward of the SSD scan at xlstm's wide state, N = 512 and P = 513 (the
// mLSTM: c = q, b = k with d_head 512, x = v plus the normalizer's column of
// ones), for Hopper, in the chunked form on the tensor cores: the gradients
// of the recurrence
//   S_t = a_t S_{t-1} + g_t b_t x_t^T,  y_t = S_t^T c_t  (a_t = exp(log_a_t))
// for the upstream dy (and an optional ds_final, the gradient of the last
// state).
//
// Replaces: no Pallas counterpart.  The JAX package cannot differentiate
// src/repro/kernels/ssd/kernel.py:92 ssd_scan_pallas (ported at this shape
// by csrc/ssd_scan_wide.cu); it trains through jax.vjp of its oracle,
// src/repro/kernels/ssd/ref.py:ssd_ref, and this is the gradient of that
// function.  Its plain twin, the same decomposition in fp32, is
// kernels/ssd/ref.py:ssd_chunked_bwd_ref; csrc/ssd_scan_bwd.cu is the same
// backward at zamba2's N = P = 64.
//
// The math is ssd_chunked_bwd_ref's (L = 64 rows a chunk; l the inclusive
// cumulative sum of log_a in the chunk, e_i = exp(l_i), u_j = exp(l_L - l_j),
// w_j = u_j g_j, D_ij = exp(l_i - l_j) g_j for j <= i, a select taken before
// the exp, CB = C B^T, M = CB o D, S_in the state entering the chunk and G
// the gradient reaching its end):
//   S_in <- exp(l_L) S_in + B^T (w o X),   G <- exp(l_L) G + C^T (e o dY)
//   dX = M^T dY + w o (B G)        dM = dY X^T
//   dC = e o (dY S_in^T) + (dM o D) B
//   dB = (dM o D)^T C + w o (X G^T)
//   dgate_j = sum_i dM_ij CB_ij E_ij + u_j q_j,  q_j = b_j.(G x_j)
// and dlog_a telescoped over the whole sequence: <G_t, S_t> - <G_{t-1},
// S_{t-1}> = c_t.dc_t - g_t dgate_t, so
//   dlog_a_t = sum_{u >= t} (c_u.dc_u - g_u dgate_u) + <ds_final, S_final>,
//   <ds_final, S_final> = exp(l_L) <ds_final, S_in> + sum_j w_j q_j
// (both of the last chunk): no pass reads S_in beside G, and at S 1 the
// constant is the twin's carry, sum_j w_j q_j, term for term.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations.
// At the train shape (B 4, H 4, S 2048: 512 (batch, head, chunk)s) the
// function's bytes are 235.6 MB (c, b, x, dy read and dc, db, dx written in
// bf16, the fp32 gates and their gradients: 0.070 ms); the chunked form's
// products are 9.7e10 operations, 0.098 ms.  With every fp32 operand of a
// product split into three bf16 parts (24 bits), this design's products
// are 3.1e11 operations, 0.31 ms at the bf16 peak.
//
// Design: the states never leave the chip.  Each is tiled into eight
// 64-row bands, one block a (band, batch, head), 128 blocks a pass at the
// train shape, one a streaming multiprocessor: the band (64 x 512 fp32) is
// held by two warpgroups (64 x 256 each, 128 registers a thread) for the
// whole pass, and every product that needs the state takes it from those
// registers as wgmma's A operand, split in three.  Five launches, one
// launch count (the wrapper's):
//  * wide_bwd_prep_kernel, one block (one warpgroup) a (chunk, head,
//    batch): C B^T and dY X^T (wgmma over K = 512 and 513, c, b, dy, x
//    streamed by TMA through a ring of 4 stages), the gates (l scanned in
//    fp64, the exps of fp64 values rounded once, as the twin takes them),
//    and a 51 KB record: M and dM o D in three bf16 parts each, laid out as
//    the 128-byte-swizzled tiles wgmma reads, and e, u, w, g, dgate's first
//    term, (M^T dY)[:, 512], x[:, 512], dy[:, 512], exp(l_L);
//  * wide_bwd_band_kernel<DC> over the chunks forward, state S_in[band, :]
//    (rows n; P's column 512 beside it in shared memory, fp32): each chunk
//    dC[:, band]^T = e o (S_in dY^T) + B^T (dM o D)^T (rs: A = the state's
//    parts; then ss: A = the b tile, B = the record's parts), out through a
//    TMA store, and its share of c.dc; then S += (w o B)^T X (ss, N 128:
//    A = the b tile scaled and split, B = the x tile).  At the last chunk
//    its share of <ds_final, S_in>;
//  * wide_bwd_band_kernel<DB> backward from ds_final, state G[band, :]:
//    dB[:, band]^T = w o (G X^T) + C^T (dM o D), its shares of q and of
//    (B G)[:, 512]; then G += (e o C)^T dY;
//  * wide_bwd_band_kernel<DX> backward, state G^T[band of P, :] (rows p,
//    all 512 columns n; P's 513th column is the DB pass's): dX[:,
//    band]^T = w o (G^T B^T) + dY^T M; then G^T += (e o dY)^T C;
//  * wide_bwd_finish_kernel, one block a (batch, head): dgate, (B G)[:, 512]
//    into dx's last column, and dlog_a, the reverse sum over the sequence in
//    fp64 plus the last chunk's constant.
// In a band block the two warpgroups split the state's 512 columns, so the
// rs product over them is two partial sums: each warpgroup scales its own,
// adds half of the small ss product (K = 32 of the chunk's 64 rows) and its
// share of c.dc or q; warpgroup 1 hands its partial to warpgroup 0 through
// shared memory, which adds it (0's + 1's) and stores.  Every sum across
// warpgroups, bands or chunks is taken in a fixed order: no atomics, equal
// bits from call to call.  Nothing between wgmma groups branches; the
// branches between them run after every group has been waited for.
// Precision: the tensor cores round their fp32 accumulator at every k16
// step, so no long sum stays in one accumulator.  The rs product takes 32
// columns at a time (low part's products first, high part's last) in an
// accumulator of its own and adds it to the sum by one rounded fp32 add;
// the update takes 128 columns at a time the same way and folds them into
// the state by one fma (exp(l_L) S + U); the small ss product and the
// first pass's C B^T and dY X^T (a box at a time) likewise.  Held in one
// accumulator over 256 columns, the rs product's 48 steps left an element
// of dx or db 2-3 bf16 ulps off the twin in most draws of the ds_final
// case.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's kernel rows,
// PERF.md §6): 0.9688 ms at the train shape, 9.9x the bound: the first
// pass 83 us, the dc, db and dx passes 286, 306 and 224 us, the last 15
// us.  scripts_ssd_bwd_wide_variants.py, the same card: without the rs
// product (its results wrong) 0.650 ms, so the rs product and its splits
// take a third; the dx pass, with the same products as the others but no
// column 512 and no c.dc or q share, is 60-80 us shorter than they are.
// Tried and dropped (that script rebuilds them): the rs product's 256
// columns in one accumulator, 0.916-0.924 ms, but 4 of 6 draws of the
// ds_final case with a dx or db element 2-3 ulps off; the update's parts
// straight into the state's accumulators (N 256), 0.980-0.983 ms, no
// faster, the state rounded at 12 steps a chunk instead of one.
// Workspace at the train shape: 512 records of 52,224 bytes (26.7 MB) and
// the shares (3.1 MB): 29.9 MB, where the first design wrote each chunk's
// S_in and G in fp32 (1.21 GB) and read them back three times (2.42 GB;
// ~3.6 GB with the rest).  This one's DRAM traffic, counted: c, b, x, dy
// read by the first pass (135 MB), the records written (26.7 MB), dc, db,
// dx written (101 MB): 0.26 GB.  The bands read each chunk's tiles and
// record again, 8 bands x 3 passes (2.07 GB), from L2 when a head's 8
// bands run together, as they do in a wave; how much of it misses L2 is
// not measured (no ncu on that machine).
// Later work: the rs product's fragments built while the previous group
// multiplies (two groups in flight need 48 more registers than the 255 a
// thread has); the shares and column 512 by the tensor cores; the three
// passes run as 384 blocks in three waves of 128 on 132 SMs.
// Rows at or past S read as zero (TMA's fill) and have log_a = gate = 0,
// so they add nothing; they are not written.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;

constexpr int L = 64;                  // chunk length
constexpr int NS = 512;                // state size N
constexpr int PD = 513;                // head dim P (with the ones column)
constexpr int BANDS = 8;               // 64-row bands of a state a pass
constexpr int BOX = L * 128;           // a 64 x 64 bf16 tile, 8 KB
constexpr int HALF = 4 * BOX;          // a warpgroup's 256 columns of a tile

// A chunk's record (bytes): M's three parts, the floats, dM o D's three
// parts, so that the dX pass copies [M, floats] and the others [floats,
// dM o D] in one bulk copy each, with the tiles 1024-byte aligned.
constexpr int REC_M = 0;
constexpr int REC_F = 3 * BOX;
constexpr int REC_FBYTES = 3072;
constexpr int REC_PD = REC_F + REC_FBYTES;
constexpr int REC = REC_PD + 3 * BOX;            // 52,224
constexpr int REC_LOAD = 3 * BOX + REC_FBYTES;   // what a band pass copies
// the floats (indices from REC_F)
constexpr int F_E = 0, F_U = L, F_W = 2 * L, F_G = 3 * L, F_DG1 = 4 * L,
              F_MD = 5 * L, F_DY = 6 * L, F_X = 7 * L, F_DECAY = 8 * L;
// A chunk's shares (floats): c.dc, q and (B G)[:, 512], by band
constexpr int SH_CDC = 0, SH_Q = BANDS * L, SH_X = 2 * BANDS * L;
constexpr int SHARE = 3 * BANDS * L;

enum Mode { DC = 0, DB = 1, DX = 2 };

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats → three bf16 parts (high, middle, low), each packed in pairs:
// each float is the sum of its parts to ~2^-26 of itself.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = repro::pack_bf16(ra - mf.x, rb - mf.y);
}

// The element (row, col) of a 64 x 64 bf16 tile with the 128-byte swizzle.
__device__ __forceinline__ float tile_at(const unsigned char* tile, int row,
                                         int col) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      tile + hp::swz(row, col >> 3) + 2 * (col & 7)));
}

// ---------------------------------------------------------------------------
// the records: M, dM o D and the gates of one chunk
// ---------------------------------------------------------------------------

constexpr int PREP_SLOTS = 4;          // (c, b) or (dy, x) box pairs
constexpr int PREP_Q = NS / 64 + 9;    // 8 pairs for C B^T, 9 for dY X^T
constexpr int PREP_SMEM = PREP_SLOTS * 2 * BOX + 1024;
static_assert(REC <= PREP_SLOTS * 2 * BOX, "the record is staged in the ring");

struct PrepParams {
  const float *log_a, *gate;
  ll la_s[3], g_s[3];
  const bf16 *x, *dy;
  ll x_s[3], dy_s[3];
  unsigned char* rec;
  int perm_c, perm_b, perm_x, perm_dy;
  int c_head, b_head;                  // 0: the map is over one head
  int H, S;
};

// A warpgroup's 64 x 64 accumulator (rows 16·w4 + g (+ 8), columns 8k + 2t)
// into three 128-byte-swizzled bf16 part tiles, rows as the accumulator's.
__device__ __forceinline__ void store_parts(const float (&a)[32], uint32_t hi,
                                            int w4, int lane) {
  const int mm = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    uint32_t h4[4], m4[4], l4[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int kk = k + (m >> 1), r = m & 1;
      split3(a[4 * kk + 2 * r], a[4 * kk + 2 * r + 1], h4[m], m4[m], l4[m]);
    }
    const uint32_t off = hp::swz(16 * w4 + 8 * (mm & 1) + mr, k + (mm >> 1));
    hp::stmatrix_x4(hi + off, h4[0], h4[1], h4[2], h4[3]);
    hp::stmatrix_x4(hi + BOX + off, m4[0], m4[1], m4[2], m4[3]);
    hp::stmatrix_x4(hi + 2 * BOX + off, l4[0], l4[1], l4[2], l4[3]);
  }
}

__global__ void __launch_bounds__(128)
    wide_bwd_prep_kernel(const __grid_constant__ CUtensorMap c_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap dy_map,
                         const PrepParams p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[PREP_SLOTS];
  __shared__ double lsh[L];
  __shared__ float gsh[L], d512[L];
  __shared__ __align__(16) float fl[F_DECAY + 4];
  __shared__ float red[2][4][L];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, r0 = k * L;
  const int tid = threadIdx.x, w4 = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, row0 = 16 * w4 + g;

  if (tid == 0) {
    for (int i = 0; i < PREP_SLOTS; ++i) hp::bar_init(&full[i], 1);
    hp::bar_init_fence();
  }
  __syncthreads();
  // pair q into slot q % 4: boxes 64q of c and b (q < 8), then 64(q - 8) of
  // dy and x
  auto load = [&](bool pred, int q) {
    const int s = q % PREP_SLOTS;
    const bool first = q < NS / 64;
    const int d = 64 * (first ? q : q - NS / 64);
    unsigned char* dst = smem + s * 2 * BOX;
    hp::bar_arrive_tx_if(pred, &full[s], 2 * BOX);
    hp::attn_load_box(pred, dst, first ? &c_map : &dy_map, &full[s],
                      first ? p.perm_c : p.perm_dy, d,
                      first ? h * p.c_head : h, r0, b);
    hp::attn_load_box(pred, dst + BOX, first ? &b_map : &x_map, &full[s],
                      first ? p.perm_b : p.perm_x, d,
                      first ? h * p.b_head : h, r0, b);
  };
#pragma unroll
  for (int q = 0; q < PREP_SLOTS; ++q) load(tid == 0, q);

  if (w4 == 0) {
    // the gates: l scanned in fp64 (lane holds rows 2·lane and + 1; log_a =
    // gate = 0 past S), the exps of fp64 values rounded once
    double v[2];
    float gv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + 2 * lane + e;
      const bool in = row < p.S;
      v[e] = in ? (double)p.log_a[b * p.la_s[0] + h * p.la_s[1] +
                                  row * p.la_s[2]]
                : 0.0;
      gv[e] = in ? p.gate[b * p.g_s[0] + h * p.g_s[1] + row * p.g_s[2]] : 0.f;
    }
    double incl = v[0] + v[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    const double ltot = __shfl_sync(0xffffffffu, incl, 31);
    const double l[2] = {excl + v[0], excl + v[0] + v[1]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * lane + e;
      lsh[r] = l[e];
      gsh[r] = gv[e];
      const float u = (float)exp(ltot - l[e]);
      fl[F_E + r] = (float)exp(l[e]);
      fl[F_U + r] = u;
      fl[F_W + r] = u * gv[e];
      fl[F_G + r] = gv[e];
    }
    if (lane == 0) fl[F_DECAY] = (float)exp(ltot);
  } else if (w4 >= 2) {
    // column 512 of dy and x (0 past S)
    const int i = tid - 64, row = r0 + i;
    const bool in = row < p.S;
    const float dv =
        in ? __bfloat162float(p.dy[b * p.dy_s[0] + h * p.dy_s[1] +
                                   row * p.dy_s[2] + NS])
           : 0.f;
    d512[i] = dv;
    fl[F_DY + i] = dv;
    fl[F_X + i] = in ? __bfloat162float(p.x[b * p.x_s[0] + h * p.x_s[1] +
                                            row * p.x_s[2] + NS])
                     : 0.f;
  }

  // C B^T (rows i, columns j) over K = 512, then dY X^T over K = 513 (box 8
  // holds column 512 and TMA's zeros)
  // (a box's four k16 steps in an accumulator of their own, added to the
  // sum by one rounded fp32 add; the slot refilled once they are done)
  float cb[32], dm[32];
#pragma unroll
  for (int q = 0; q < PREP_Q; ++q) {
    const int s = q % PREP_SLOTS;
    const uint32_t a_s = base + s * 2 * BOX, b_s = a_s + BOX;
    hp::bar_wait(&full[s], (q / PREP_SLOTS) & 1);
    float T[32];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::Wgmma<64>::ss<0, 0>(T, hp::desc_kmajor(a_s, kk),
                              hp::desc_kmajor(b_s, kk), kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(T);
    float(&acc)[32] = q < NS / 64 ? cb : dm;
    const bool first = q == 0 || q == NS / 64;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = first ? T[i] : acc[i] + T[i];
    if (q + PREP_SLOTS < PREP_Q) load(tid == 0, q + PREP_SLOTS);
  }
  __syncthreads();                     // the gates are in; the ring is free

  // M = CB o D and dM o D in place; dgate's first term sum_i dM CB E and
  // (M^T dY)[:, 512] by column, this thread's two rows first
  float dgc[16], mdc[16];
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * kc + 2 * t + e;
      float dsum = 0.f, msum = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r, a = 4 * kc + 2 * r + e;
        const float E = j <= i ? (float)exp(lsh[i] - lsh[j]) : 0.f;
        const float D = E * gsh[j];
        const float m = cb[a] * D;
        dsum += dm[a] * cb[a] * E;
        msum += m * d512[i];
        cb[a] = m;
        dm[a] = dm[a] * D;
      }
      dgc[2 * kc + e] = dsum;
      mdc[2 * kc + e] = msum;
    }
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      dgc[c] += __shfl_xor_sync(0xffffffffu, dgc[c], off);
      mdc[c] += __shfl_xor_sync(0xffffffffu, mdc[c], off);
    }
  if (g == 0) {
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[0][w4][8 * kc + 2 * t + e] = dgc[2 * kc + e];
        red[1][w4][8 * kc + 2 * t + e] = mdc[2 * kc + e];
      }
  }
  store_parts(cb, base + REC_M, w4, lane);
  store_parts(dm, base + REC_PD, w4, lane);
  __syncthreads();
  float* fo = reinterpret_cast<float*>(smem + REC_F);
  if (tid < L) {                       // the warps' sums, in their order
    fl[F_DG1 + tid] =
        ((red[0][0][tid] + red[0][1][tid]) + red[0][2][tid]) + red[0][3][tid];
    fl[F_MD + tid] =
        ((red[1][0][tid] + red[1][1][tid]) + red[1][2][tid]) + red[1][3][tid];
  }
  __syncthreads();
  for (int i = tid; i < F_DECAY + 4; i += 128) fo[i] = fl[i];
  hp::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    hp::bulk_store(p.rec + (((ll)b * p.H + h) * nc + k) * (ll)REC, base, REC);
    hp::bulk_commit();
    hp::bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// the band passes
// ---------------------------------------------------------------------------

// shared memory of a band block (bytes from the 1024-aligned base)
constexpr int B_V = 0;                 // each warpgroup's 4 boxes of V
constexpr int B_Z = 2 * HALF;          // each warpgroup's 4 boxes of Z
constexpr int B_BAND = 4 * HALF;       // the band's tiles (two)
constexpr int B_REC = B_BAND + 2 * BOX;          // the record's copy
constexpr int B_BUILT = B_REC + REC_LOAD;        // the scaled tile's parts
constexpr int B_XCH = B_BUILT + 3 * BOX;         // the hand-over, the store
constexpr int BAND_SMEM = B_XCH + 16384 + 1024;
static_assert(B_BUILT % 1024 == 0 && B_XCH % 1024 == 0, "tiles aligned");

struct BandParams {
  const float* ds_final;
  const unsigned char* rec;
  float* share;                        // (B·H·chunks) x SHARE
  float* ds_share;                     // (B·H) x BANDS: <ds_final, S_in>
  int perm_c, perm_b, perm_x, perm_dy, perm_dc, perm_dx;
  int c_head, b_head;
  int H, nc;
};

// A warpgroup's share, by column j, of sum_r tile(j, r) P[r, j] (P rows
// 16·w4 + g (+ 8), columns 8k + 2t (+ 1)) into red[w4][j].
__device__ __forceinline__ void column_share(const float (&P)[32],
                                             const unsigned char* tile,
                                             float (*red)[L], int w4,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3, row0 = 16 * w4 + g;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * kc + 2 * t + e;
      float s = tile_at(tile, j, row0) * P[4 * kc + e];
      s = fmaf(tile_at(tile, j, row0 + 8), P[4 * kc + 2 + e], s);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (g == 0) red[w4][j] = s;
    }
}

template <int MODE>
__device__ __forceinline__ void band_pass(
    const CUtensorMap* c_map, const CUtensorMap* b_map,
    const CUtensorMap* x_map, const CUtensorMap* dy_map,
    const CUtensorMap* dc_map, const CUtensorMap* db_map,
    const CUtensorMap* dx_map, const BandParams& p, unsigned char* smem,
    uint32_t base, uint64_t* vfull, uint64_t* zfull, uint64_t* rfull,
    float (*red)[4][L], float (*col)[L], float* dsred) {
  constexpr bool REV = MODE != DC;
  constexpr bool COL = MODE != DX;     // P's column 512 beside the state
  const int band = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, w4 = wt >> 5,
            lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * w4 + g;        // accumulator rows row0, row0 + 8
  const int nc = p.nc;
  const int hb = h * p.b_head, hc = h * p.c_head;
  // V: the rs product's B operand; Z: the update's; the band's tiles
  const CUtensorMap* vmap = MODE == DC ? dy_map : MODE == DB ? x_map : b_map;
  const int vperm = MODE == DC ? p.perm_dy : MODE == DB ? p.perm_x : p.perm_b;
  const int vh = MODE == DX ? hb : h;
  const CUtensorMap* zmap = MODE == DC ? x_map : MODE == DB ? dy_map : c_map;
  const int zperm = MODE == DC ? p.perm_x : MODE == DB ? p.perm_dy : p.perm_c;
  const int zh = MODE == DX ? hc : h;
  const CUtensorMap* t0map = MODE == DC ? b_map : MODE == DB ? c_map : dy_map;
  const int t0perm = MODE == DC ? p.perm_b : MODE == DB ? p.perm_c : p.perm_dy;
  const int t0h = MODE == DC ? hb : MODE == DB ? hc : h;
  const CUtensorMap* t1map = MODE == DC ? c_map : b_map;
  const int t1perm = MODE == DC ? p.perm_c : p.perm_b;
  const int t1h = MODE == DC ? hc : hb;
  const CUtensorMap* omap = MODE == DC ? dc_map : MODE == DB ? db_map : dx_map;
  const int operm = MODE == DX ? p.perm_dx : p.perm_dc;
  constexpr int FOFF = MODE == DX ? 3 * BOX : 0;   // the floats in the copy
  constexpr int POFF = MODE == DX ? 0 : REC_FBYTES; // the record's parts
  const unsigned char* tile0 = smem + B_BAND;
  const unsigned char* tile1 = smem + B_BAND + BOX;
  const float* fl = reinterpret_cast<const float*>(smem + B_REC + FOFF);

  auto chunk_of = [&](int it) { return REV ? nc - 1 - it : it; };
  // iteration it's V and Z boxes of this warpgroup's 256 columns (its
  // first thread), the record and the band's tiles (the block's first)
  auto issue_v = [&](int it) {
    const bool go = wt == 0 && it < nc;
    const int r0 = chunk_of(it) * L;
    hp::bar_arrive_tx_if(go, &vfull[wg], HALF);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      hp::attn_load_box(go, smem + B_V + wg * HALF + q * BOX, vmap,
                        &vfull[wg], vperm, 256 * wg + 64 * q, vh, r0, b);
  };
  auto issue_z = [&](int it) {
    const bool go = wt == 0 && it < nc;
    const int r0 = chunk_of(it) * L;
    hp::bar_arrive_tx_if(go, &zfull[wg], HALF);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      hp::attn_load_box(go, smem + B_Z + wg * HALF + q * BOX, zmap,
                        &zfull[wg], zperm, 256 * wg + 64 * q, zh, r0, b);
  };
  auto issue_rec = [&](int it) {
    const bool go = tid == 0 && it < nc;
    const int k = chunk_of(it);
    hp::bar_arrive_tx_if(go, rfull, REC_LOAD + (COL ? 2 : 1) * BOX);
    hp::bulk_load_if(go, smem + B_REC,
                     p.rec + ((ll)bh * nc + (go ? k : 0)) * REC +
                         (MODE == DX ? REC_M : REC_F),
                     REC_LOAD, rfull);
    hp::attn_load_box(go, smem + B_BAND, t0map, rfull, t0perm, 64 * band, t0h,
                      k * L, b);
    if (COL)
      hp::attn_load_box(go, smem + B_BAND + BOX, t1map, rfull, t1perm,
                        64 * band, t1h, k * L, b);
  };

  if (tid == 0) {
    hp::tma_prefetch_map(vmap);
    hp::tma_prefetch_map(zmap);
    hp::tma_prefetch_map(t0map);
  }
  issue_v(0);
  issue_z(0);
  issue_rec(0);

  // the state: S_in (0), G (ds_final) or G^T (ds_final^T); this warpgroup's
  // columns 256·wg ..
  float st[128];
  {
    const float* ds = REV && p.ds_final ? p.ds_final + (ll)bh * NS * PD
                                        : nullptr;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rr = 64 * band + row0 + 8 * r;
          const int cc = 256 * wg + 8 * j + 2 * t + e;
          st[4 * j + 2 * r + e] =
              ds ? (MODE == DX ? ds[(ll)cc * PD + rr] : ds[(ll)rr * PD + cc])
                 : 0.f;
        }
    if (COL && tid < L)
      col[0][tid] = ds ? ds[(ll)(64 * band + tid) * PD + NS] : 0.f;
  }
  __syncthreads();

  for (int it = 0; it < nc; ++it) {
    const int k = chunk_of(it), ph = it & 1;
    hp::bar_wait(rfull, ph);
    if (MODE == DC && it == nc - 1) {
      // the last chunk's S_in against ds_final (column 512 too)
      float d = 0.f;
      if (p.ds_final) {
        const float* ds = p.ds_final + (ll)bh * NS * PD;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              d = fmaf(st[4 * j + 2 * r + e],
                       ds[(ll)(64 * band + row0 + 8 * r) * PD + 256 * wg +
                          8 * j + 2 * t + e],
                       d);
        if (tid < L)
          d = fmaf(col[ph][tid], ds[(ll)(64 * band + tid) * PD + NS], d);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) dsred[tid >> 5] = d;
      hp::named_sync(1, 256);
      if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < 8; ++w) s += dsred[w];
        p.ds_share[(ll)bh * BANDS + band] = s;
      }
    }

    // (1) P = this warpgroup's share of T V^T: K over its 256 columns, A the
    // state's three parts from the accumulators.  Each group of 32 columns
    // (two k16 steps) goes to an accumulator of its own, the low part's
    // products first and the high part's last, and is added to P by one
    // rounded fp32 add: the tensor cores round their accumulator at every
    // step, so a long sum in one accumulator loses what the twin keeps
    hp::bar_wait(&vfull[wg], ph);
    float P[32];
    const uint32_t vb = base + B_V + wg * HALF;
#pragma unroll
    for (int gq = 0; gq < 8; ++gq) {
      uint32_t fr[3][2][4];
#pragma unroll
      for (int kq = 0; kq < 2; ++kq) {
        const int j0 = 4 * gq + 2 * kq, j1 = j0 + 1;
        split3(st[4 * j0], st[4 * j0 + 1], fr[0][kq][0], fr[1][kq][0],
               fr[2][kq][0]);
        split3(st[4 * j0 + 2], st[4 * j0 + 3], fr[0][kq][1], fr[1][kq][1],
               fr[2][kq][1]);
        split3(st[4 * j1], st[4 * j1 + 1], fr[0][kq][2], fr[1][kq][2],
               fr[2][kq][2]);
        split3(st[4 * j1 + 2], st[4 * j1 + 3], fr[0][kq][3], fr[1][kq][3],
               fr[2][kq][3]);
      }
      float T[32];
      hp::wgmma_fence();
#pragma unroll
      for (int pt = 0; pt < 3; ++pt)
#pragma unroll
        for (int kq = 0; kq < 2; ++kq)
          hp::Wgmma<64>::rs<0>(
              T, fr[2 - pt][kq],
              hp::desc_kmajor(vb + (gq >> 1) * BOX, 2 * (gq & 1) + kq),
              pt > 0 || kq > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(T);
      hp::fence_regs(fr[0]);
      hp::fence_regs(fr[1]);
      hp::fence_regs(fr[2]);
#pragma unroll
      for (int i = 0; i < 32; ++i) P[i] = gq > 0 ? P[i] + T[i] : T[i];
    }
    hp::named_sync(2 + wg, 128);       // the warpgroup's V boxes are read
    issue_v(it + 1);

    // (2) column 512's rank-1 term (warpgroup 0's share), q's share (DB),
    // the scale, half of the small product, c.dc's share (DC)
    if (COL) {
      const float* vec = fl + (MODE == DC ? F_DY : F_X);
      const float f = wg == 0 ? 1.f : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float cv = f * col[ph][row0 + 8 * r];
#pragma unroll
        for (int kc = 0; kc < 8; ++kc) {
          const float2 v =
              *reinterpret_cast<const float2*>(&vec[8 * kc + 2 * t]);
          P[4 * kc + 2 * r] = fmaf(cv, v.x, P[4 * kc + 2 * r]);
          P[4 * kc + 2 * r + 1] = fmaf(cv, v.y, P[4 * kc + 2 * r + 1]);
        }
      }
    }
    if (MODE == DB) column_share(P, tile1, red[wg], w4, lane);
    {
      const float* sc = fl + (MODE == DC ? F_E : F_W);
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        const float2 v = *reinterpret_cast<const float2*>(&sc[8 * kc + 2 * t]);
        P[4 * kc] *= v.x;
        P[4 * kc + 1] *= v.y;
        P[4 * kc + 2] *= v.x;
        P[4 * kc + 3] *= v.y;
      }
    }
    {
      // in an accumulator of its own, low part first, then added to P once
      const uint32_t t0 = base + B_BAND, parts = base + B_REC + POFF;
      float Q[32];
      hp::wgmma_fence();
#pragma unroll
      for (int pt = 0; pt < 3; ++pt)
#pragma unroll
        for (int kq = 0; kq < 2; ++kq) {
          const int kk = 2 * wg + kq, part = 2 - pt;
          if (MODE == DC)
            hp::Wgmma<64>::ss<1, 0>(Q, hp::desc_mnmajor(t0, kk, BOX),
                                    hp::desc_kmajor(parts + part * BOX, kk),
                                    pt > 0 || kq > 0);
          else
            hp::Wgmma<64>::ss<1, 1>(
                Q, hp::desc_mnmajor(t0, kk, BOX),
                hp::desc_mnmajor(parts + part * BOX, kk, BOX),
                pt > 0 || kq > 0);
        }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(Q);
#pragma unroll
      for (int i = 0; i < 32; ++i) P[i] += Q[i];
    }
    if (MODE == DC) column_share(P, tile1, red[wg], w4, lane);
    float4* xch = reinterpret_cast<float4*>(smem + B_XCH) + wt;
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xch[128 * i] =
            make_float4(P[4 * i], P[4 * i + 1], P[4 * i + 2], P[4 * i + 3]);
    }
    hp::named_sync(1, 256);            // the hand-over and the shares are in

    if (wg == 0) {
      // the sum, 0's + 1's, out in bf16 through the hand-over's first 8 KB,
      // transposed (rows j, 64 columns r), and a TMA store
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = xch[128 * i];
        P[4 * i] += v.x;
        P[4 * i + 1] += v.y;
        P[4 * i + 2] += v.z;
        P[4 * i + 3] += v.w;
      }
      hp::named_sync(4, 128);          // every thread has read the hand-over
      const uint32_t ot = base + B_XCH;
      const int mm = lane >> 3;
#pragma unroll
      for (int kc = 0; kc < 8; kc += 2) {
        const uint32_t off =
            hp::swz(8 * (kc + (mm >> 1)) + (lane & 7), 2 * w4 + (mm & 1));
        hp::stmatrix_x4_trans(ot + off,
                              repro::pack_bf16(P[4 * kc], P[4 * kc + 1]),
                              repro::pack_bf16(P[4 * kc + 2], P[4 * kc + 3]),
                              repro::pack_bf16(P[4 * kc + 4], P[4 * kc + 5]),
                              repro::pack_bf16(P[4 * kc + 6], P[4 * kc + 7]));
      }
      hp::fence_proxy_async();
      hp::named_sync(4, 128);
      hp::attn_store_box_if(wt == 0, omap, ot, operm, 64 * band, h, k * L, b);
      hp::bulk_commit_if(wt == 0);
    } else if (COL) {
      // the shares' sums (warpgroup 0's warps, then 1's); (DB) this band's
      // (B G)[:, 512] = sum_n b[j, n] G[n, 512]; column 512's update, S +=
      // (w o B)^T x[:, 512] (DC) or G += (e o C)^T dy[:, 512] (DB): two
      // threads an output, each half of the sum, added in the same order
      const int o = wt >> 1, half = wt & 1;
      float* sh = p.share + ((ll)bh * nc + k) * SHARE + band * L;
      if (half == 0) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int w = 0; w < 4; ++w) s += red[q][w][o];
        sh[(MODE == DC ? SH_CDC : SH_Q) + o] = s;
      }
      if (MODE == DB) {
        float x = 0.f;
#pragma unroll
        for (int n = 32 * half; n < 32 * half + 32; ++n)
          x = fmaf(tile_at(tile1, o, n), col[ph][n], x);
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        if (half == 0) sh[SH_X + o] = x;
      }
      const float* bs = fl + (MODE == DC ? F_W : F_E);
      const float* vec = fl + (MODE == DC ? F_X : F_DY);
      float s = 0.f;
#pragma unroll
      for (int j = 32 * half; j < 32 * half + 32; ++j)
        s = fmaf(bs[j] * tile_at(tile0, j, o), vec[j], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0) col[ph ^ 1][o] = fmaf(fl[F_DECAY], col[ph][o], s);
    }
    {
      // the update's A operand: the band's first tile, rows scaled (w for
      // DC, e for DB and DX), in three parts, layout as the tile's; each
      // warpgroup half of the rows
      const float* bs = fl + (MODE == DC ? F_W : F_E);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c16 = 256 * wg + 128 * i + wt;
        const float sv = bs[c16 >> 3];
        float f[8];
        repro::unpack8_bf16(*reinterpret_cast<const uint4*>(tile0 + 16 * c16),
                            f);
        uint4 hi, mid, lo;
        split3(f[0] * sv, f[1] * sv, hi.x, mid.x, lo.x);
        split3(f[2] * sv, f[3] * sv, hi.y, mid.y, lo.y);
        split3(f[4] * sv, f[5] * sv, hi.z, mid.z, lo.z);
        split3(f[6] * sv, f[7] * sv, hi.w, mid.w, lo.w);
        uint4* dst = reinterpret_cast<uint4*>(smem + B_BUILT) + c16;
        dst[0] = hi;
        dst[BOX / 16] = mid;
        dst[2 * BOX / 16] = lo;
      }
      hp::fence_proxy_async();
    }
    const float dec = fl[F_DECAY];
    // the store has read the hand-over before warpgroup 1 writes it again
    hp::bulk_wait_read_if(wg == 0 && wt == 0);
    hp::named_sync(1, 256);            // the scaled tile is in; the record
                                       // and the band's tiles are read
    issue_rec(it + 1);

    // (3) the update: T = exp(l_L) T + A^T Z over the chunk's rows, a
    // 128-column block at a time into an accumulator of its own (low part
    // first), folded into the state by one rounded fma an element: adding
    // the parts' products into the state's accumulators would round the
    // state at every step
    hp::bar_wait(&zfull[wg], ph);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t zb = base + B_Z + wg * HALF + q * 2 * BOX;
      const uint32_t bt = base + B_BUILT;
      float U[64];
      hp::wgmma_fence();
#pragma unroll
      for (int pt = 0; pt < 3; ++pt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hp::Wgmma<128>::ss<1, 1>(
              U, hp::desc_mnmajor(bt + (2 - pt) * BOX, kk, BOX),
              hp::desc_mnmajor(zb, kk, BOX), pt > 0 || kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(U);
#pragma unroll
      for (int i = 0; i < 64; ++i)
        st[64 * q + i] = fmaf(st[64 * q + i], dec, U[i]);
    }
    hp::named_sync(2 + wg, 128);       // the warpgroup's Z boxes are read
    issue_z(it + 1);
  }
  hp::bulk_wait_if(wg == 0 && wt == 0);   // the last store is done
}

template <int MODE>
__global__ void __launch_bounds__(256, 1)
    wide_bwd_band_kernel(const __grid_constant__ CUtensorMap c_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap dy_map,
                         const __grid_constant__ CUtensorMap dc_map,
                         const __grid_constant__ CUtensorMap db_map,
                         const __grid_constant__ CUtensorMap dx_map,
                         const BandParams p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t vfull[2], zfull[2], rfull;
  __shared__ float red[2][4][L];
  __shared__ __align__(16) float col[2][L];
  __shared__ float dsred[8];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hp::bar_init(&vfull[i], 1);
      hp::bar_init(&zfull[i], 1);
    }
    hp::bar_init(&rfull, 1);
    hp::bar_init_fence();
  }
  __syncthreads();
  band_pass<MODE>(&c_map, &b_map, &x_map, &dy_map, &dc_map, &db_map, &dx_map,
                  p, smem, base, vfull, zfull, &rfull, red, col, dsred);
}

// ---------------------------------------------------------------------------
// dgate, dlog_a and dx's column 512
// ---------------------------------------------------------------------------

constexpr int FIN = 1024;              // threads: rows a segment

struct FinishParams {
  const unsigned char* rec;
  const float *share, *ds_share;
  float *dlog_a, *dgate;
  ll dla_s[3], dg_s[3];
  bf16* dx;
  ll dx_s[3];
  int H, S, nc;
};

__global__ void __launch_bounds__(FIN) wide_bwd_finish_kernel(
    const FinishParams p) {
  __shared__ double wsum[FIN / 32];
  __shared__ double cst;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = p.nc;
  auto fl = [&](int k) {
    return reinterpret_cast<const float*>(
        p.rec + ((ll)bh * nc + k) * REC + REC_F);
  };
  auto band_sum = [&](int k, int which, int j) {
    const float* s = p.share + ((ll)bh * nc + k) * SHARE + which + j;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < BANDS; ++q) v += s[q * L];
    return v;
  };
  if (tid == 0) {
    // <ds_final, S_final> = exp(l_L) <ds_final, S_in> + sum_j w_j q_j, of
    // the last chunk
    const float* f = fl(nc - 1);
    float d = 0.f;
    for (int q = 0; q < BANDS; ++q) d += p.ds_share[(ll)bh * BANDS + q];
    double c = (double)f[F_DECAY] * (double)d;
    for (int j = 0; j < L; ++j)    // w_j q_j as u_j g_j q_j, as v takes it
      c += (double)f[F_U + j] * (double)f[F_G + j] *
           (double)band_sum(nc - 1, SH_Q, j);
    cst = c;
  }
  __syncthreads();
  double carry = cst;
  for (int end = p.S; end > 0; end -= FIN) {
    const int r = end - FIN + tid;
    double v = 0.0;
    if (r >= 0) {
      const int k = r / L, j = r % L;
      const float* f = fl(k);
      const float q = band_sum(k, SH_Q, j);
      const float dgate = f[F_DG1 + j] + f[F_U + j] * q;
      // c.dc - g dgate in fp64: the terms of u g q cancel the constant's
      v = (double)band_sum(k, SH_CDC, j) -
          (double)f[F_G + j] *
              ((double)f[F_DG1 + j] + (double)f[F_U + j] * (double)q);
      p.dgate[b * p.dg_s[0] + h * p.dg_s[1] + r * p.dg_s[2]] = dgate;
      p.dx[b * p.dx_s[0] + h * p.dx_s[1] + r * p.dx_s[2] + NS] =
          __float2bfloat16_rn(f[F_W + j] * band_sum(k, SH_X, j) + f[F_MD + j]);
    }
    // the sum over the rows at or after r: the warp's, the later warps',
    // the later segments' and the constant
    double s = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_down_sync(0xffffffffu, s, off);
      if (lane + off < 32) s += o;
    }
    if (lane == 0) wsum[warp] = s;
    __syncthreads();
    double later = 0.0, total = 0.0;
    for (int w = 0; w < FIN / 32; ++w) {
      if (w > warp) later += wsum[w];
      total += wsum[w];
    }
    if (r >= 0)
      p.dlog_a[b * p.dla_s[0] + h * p.dla_s[1] + r * p.dla_s[2]] =
          (float)(s + later + carry);
    carry += total;
    __syncthreads();
  }
}

template <int MODE>
cudaError_t launch_band(const CUtensorMap (&m)[7], const BandParams& p,
                        int B, int H, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_bwd_band_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BAND_SMEM);
  if (err != cudaSuccess) return err;
  wide_bwd_band_kernel<MODE><<<dim3(BANDS, B * H), 256, BAND_SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace for (B, H, S): each chunk's record and shares,
// and each (batch, head)'s shares of <ds_final, S_in>.
extern "C" long long ssd_scan_bwd_wide_workspace(int B, int H, int S) {
  const ll chunks = (ll)B * H * ((S + L - 1) / L);
  return chunks * (REC + 4ll * SHARE) + 4ll * B * H * BANDS;
}

// c, b: (B, H, S, 512) bf16; x, dy: (B, H, S, 513) bf16; log_a, gate: (B, H,
// S) fp32; each read through its (batch, head, seq) strides (TMA: unit
// stride on the last dim, the others multiples of 8 elements, 16-byte
// aligned bases; c's and b's head stride may be 0).  ds_final: (B, H, 512,
// 513) fp32 contiguous, or null for zero.  dc, db: (B, H, S, 512) bf16
// contiguous; dx: bf16 through its strides as x; dlog_a, dgate: fp32
// through their strides.  ws: ssd_scan_bwd_wide_workspace(B, H, S) bytes,
// 16-byte aligned.  Returns 0 or a CUDA error code; -1 for arguments the
// kernels do not take.
extern "C" int ssd_scan_bwd_wide(
    const void* c, const void* b, const void* x, const void* dy,
    const void* log_a, const void* gate, const void* ds_final, void* dc,
    void* db, void* dx, void* dlog_a, void* dgate, void* ws, int B, int H,
    int S, int N, int P, ll c_sb, ll c_sh, ll c_ss, ll b_sb, ll b_sh,
    ll b_ss, ll x_sb, ll x_sh, ll x_ss, ll dy_sb, ll dy_sh, ll dy_ss,
    ll dx_sb, ll dx_sh, ll dx_ss, ll la_sb, ll la_sh, ll la_ss, ll g_sb,
    ll g_sh, ll g_ss, ll dla_sb, ll dla_sh, ll dla_ss, ll dg_sb, ll dg_sh,
    ll dg_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return -1;
  if (N != NS || P != PD) return -1;   // xlstm's d_head 512 and the ones
  const int nc = (S + L - 1) / L;
  if ((ll)B * H > 65535 || nc > 65535 || B > 65535) return -1;
  // maps: c and b with a head stride of 0 over one head; the outputs
  CUtensorMap cm, bm, xm, dym, dcm, dbm, dxm;
  int perm_c, perm_b, perm_x, perm_dy, perm_dc, perm_dx;
  const ll o_ss = NS, o_sh = (ll)S * NS, o_sb = (ll)H * S * NS;
  if (!hp::attn_map(&cm, &perm_c, c, B, c_sh ? H : 1, S, NS, c_sb,
                    c_sh ? c_sh : c_sb, c_ss, L) ||
      !hp::attn_map(&bm, &perm_b, b, B, b_sh ? H : 1, S, NS, b_sb,
                    b_sh ? b_sh : b_sb, b_ss, L) ||
      !hp::attn_map(&xm, &perm_x, x, B, H, S, PD, x_sb, x_sh, x_ss, L) ||
      !hp::attn_map(&dym, &perm_dy, dy, B, H, S, PD, dy_sb, dy_sh, dy_ss, L) ||
      !hp::attn_map(&dcm, &perm_dc, dc, B, H, S, NS, o_sb, o_sh, o_ss, L) ||
      !hp::attn_map(&dbm, &perm_dc, db, B, H, S, NS, o_sb, o_sh, o_ss, L) ||
      !hp::attn_map(&dxm, &perm_dx, dx, B, H, S, PD, dx_sb, dx_sh, dx_ss, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const ll chunks = (ll)B * H * nc;
  unsigned char* rec = static_cast<unsigned char*>(ws);
  float* share = reinterpret_cast<float*>(rec + chunks * REC);
  float* ds_share = share + chunks * SHARE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  PrepParams pp{};
  pp.log_a = static_cast<const float*>(log_a);
  pp.gate = static_cast<const float*>(gate);
  pp.la_s[0] = la_sb; pp.la_s[1] = la_sh; pp.la_s[2] = la_ss;
  pp.g_s[0] = g_sb; pp.g_s[1] = g_sh; pp.g_s[2] = g_ss;
  pp.x = static_cast<const bf16*>(x);
  pp.dy = static_cast<const bf16*>(dy);
  pp.x_s[0] = x_sb; pp.x_s[1] = x_sh; pp.x_s[2] = x_ss;
  pp.dy_s[0] = dy_sb; pp.dy_s[1] = dy_sh; pp.dy_s[2] = dy_ss;
  pp.rec = rec;
  pp.perm_c = perm_c; pp.perm_b = perm_b;
  pp.perm_x = perm_x; pp.perm_dy = perm_dy;
  pp.c_head = c_sh != 0;
  pp.b_head = b_sh != 0;
  pp.H = H;
  pp.S = S;
  cudaError_t err = cudaFuncSetAttribute(
      wide_bwd_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PREP_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_bwd_prep_kernel<<<dim3(nc, H, B), 128, PREP_SMEM, st>>>(cm, bm, xm,
                                                                dym, pp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  BandParams bp{};
  bp.ds_final = static_cast<const float*>(ds_final);
  bp.rec = rec;
  bp.share = share;
  bp.ds_share = ds_share;
  bp.perm_c = perm_c; bp.perm_b = perm_b;
  bp.perm_x = perm_x; bp.perm_dy = perm_dy;
  bp.perm_dc = perm_dc; bp.perm_dx = perm_dx;
  bp.c_head = pp.c_head;
  bp.b_head = pp.b_head;
  bp.H = H;
  bp.nc = nc;
  const CUtensorMap maps[7] = {cm, bm, xm, dym, dcm, dbm, dxm};
  if ((err = launch_band<DC>(maps, bp, B, H, st)) != cudaSuccess ||
      (err = launch_band<DB>(maps, bp, B, H, st)) != cudaSuccess ||
      (err = launch_band<DX>(maps, bp, B, H, st)) != cudaSuccess)
    return static_cast<int>(err);

  FinishParams fp{};
  fp.rec = rec;
  fp.share = share;
  fp.ds_share = ds_share;
  fp.dlog_a = static_cast<float*>(dlog_a);
  fp.dgate = static_cast<float*>(dgate);
  fp.dla_s[0] = dla_sb; fp.dla_s[1] = dla_sh; fp.dla_s[2] = dla_ss;
  fp.dg_s[0] = dg_sb; fp.dg_s[1] = dg_sh; fp.dg_s[2] = dg_ss;
  fp.dx = static_cast<bf16*>(dx);
  fp.dx_s[0] = dx_sb; fp.dx_s[1] = dx_sh; fp.dx_s[2] = dx_ss;
  fp.H = H;
  fp.S = S;
  fp.nc = nc;
  wide_bwd_finish_kernel<<<B * H, FIN, 0, st>>>(fp);
  return static_cast<int>(cudaGetLastError());
}
