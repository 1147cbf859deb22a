// Backward of the SSD scan at xlstm's wide state, N = 512 and P = 513 (the
// mLSTM: c = q, b = k with d_head 512, x = v plus the normalizer's column of
// ones), for Hopper: the gradients of the recurrence
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
//   dlog_a_t = sum_{u >= t in the chunk} (c_u.dc_u - g_u dgate_u) + carry,
//   carry = exp(l_L) <G, S_in> + sum_j w_j q_j.
//
// What bounds it on the H100: operations.  At the train shape (B 4, H 4,
// S 2048: 512 (batch, head, chunk)s) the function's bytes are 235.6 MB
// (c, b, x, dy read and dc, db, dx written in bf16, 2 bytes an element, and
// the fp32 gates and their gradients: 0.070 ms at 3.35 TB/s); the chunked
// form's products are 9.7e10 operations, 0.098 ms on the bf16 tensor cores
// at 989 TFLOP/s.
//
// Design: a first kernel that is right, on the CUDA cores in fp32; the
// products at 67 TFLOP/s, ~1.5e-3 s at best, where a tensor-core design with
// its fp32 operands split into bf16 parts would be bound near 0.3 ms
// (ROADMAP.md B5).  Every operand is an exact fp32 value (bf16 inputs
// widened, fp32 states and gates), every product and sum is fp32, the gates'
// cumulative sums and exps are taken in fp64 and rounded once, as the twin
// takes them, so the kernel differs from the twin by summation order alone.
// Five launches, one launch count (the wrapper's):
//  * wide_bwd_state_kernel<false>, <true>: the two passes over the chunks,
//    one block a (64 x 64 tile of the 512 x 576 state, batch, head): 72
//    tiles a head (P's 9th tile holds column 512 and 63 zero columns), each
//    block's tile in registers (4 x 4 a thread) for the whole pass.  Before
//    each chunk's update a block stores its tile to the workspace (S_in,
//    then G, fp32, a row pitch of 576); the reverse pass, launched after
//    the forward one, also reads S_in there and sums its tile's share of
//    <G, S_in>;
//  * wide_bwd_chunk_kernel: one block a (chunk, batch, head): CB and dM (64 x
//    64, K = 512 and 513), then M, dM o D and its transpose and dgate's
//    first term to the workspace;
//  * wide_bwd_out_kernel: one block a (64-column tile, chunk, batch, head):
//    9 tiles of dX, 8 of dC with c.dc's share of the tile, 8 of dB with q's;
//  * wide_bwd_finish_kernel: one block a chunk sums the tiles' shares in a
//    fixed order, then dgate and dlog_a (a reverse sum over the rows).
// Each product runs over 32-deep slices of its operands staged in shared
// memory as fp32 (a [k][m] and a [k][n] slice, pitch 68), each thread
// holding a 4 x 4 tile of the 64 x 64 output.  Rows at or past S read as
// zero and are not written; so are columns of x and dy past 513 (a row's
// pitch is a multiple of 8 elements, so column 513..519 are read and
// dropped).  Every output element is summed in one block in a fixed order:
// no atomics, equal bits from call to call.  The workspace holds every
// chunk's S_in and G, 1.2 GB at the train shape.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int L = 64;                  // chunk length
constexpr int NS = 512;                // state size N
constexpr int PD = 513;                // head dim P (with the ones column)
constexpr int NT = NS / 64;            // 64-row tiles of N
constexpr int PT = (PD + 63) / 64;     // 64-column tiles of P
constexpr int PP = PT * 64;            // a workspace state's row pitch, fp32
constexpr ll STATE = (ll)NS * PP;      // floats of a workspace state
constexpr int KS = 32;                 // depth of a product's slice
constexpr int SP = 68;                 // a slice's row pitch in floats
constexpr int KP = (PD + KS - 1) / KS * KS;   // P in whole slices: 544
constexpr int NTH = 256;
constexpr int OUT_TILES = PT + 2 * NT; // dX, dC, dB tiles of a chunk
// a chunk's record: M [i][j], dM o D [i][j] and its transpose [j][i], and
// dgate's first term
constexpr int REC_P = L * L, REC_PT = 2 * L * L, REC_DG = 3 * L * L;
constexpr int REC = 3 * L * L + L;
// a chunk's shares: c.dc and q by N tile, <G, S_in> by state tile
constexpr int PART_Q = NT * L, PART_DOT = 2 * NT * L;
constexpr int PART = 2 * NT * L + NT * PT;

struct Slice {
  float a[KS][SP];                     // [k][m]
  float b[KS][SP];                     // [k][n]
};

struct Gates {
  double l[L];
  float g[L], e[L], u[L], w[L];
  float decay;
};

struct Args {
  const bf16 *c, *b, *x, *dy;
  const float *log_a, *gate, *ds_final;
  bf16 *dc, *db, *dx;
  float *dlog_a, *dgate;
  float *ws_s, *ws_g, *ws_rec, *ws_part;
  ll c_s[3], b_s[3], x_s[3], dy_s[3], dx_s[3];
  ll la_s[3], g_s[3], dla_s[3], dg_s[3];
  int H, S, nc;
};

// The chunk's first row of a (B, H, S, ·) tensor read through its strides.
template <typename T>
__device__ __forceinline__ const T* chunk_rows(const T* p, const ll* s,
                                               int b, int h, int k) {
  return p + b * s[0] + h * s[1] + (ll)k * L * s[2];
}

// Chunk k's gates, by one warp (lane holds rows 2·lane and 2·lane + 1;
// log_a = gate = 0 past S): l scanned in fp64, the exps of fp64 values
// rounded once, as the twin takes them.
__device__ __forceinline__ void chunk_gates(const Args& a, int b, int h,
                                            int k, int lane, Gates& gt) {
  double v[2];
  float gv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = k * L + 2 * lane + e;
    const bool in = row < a.S;
    v[e] = in ? (double)a.log_a[b * a.la_s[0] + h * a.la_s[1] +
                                 row * a.la_s[2]]
              : 0.0;
    gv[e] = in ? a.gate[b * a.g_s[0] + h * a.g_s[1] + row * a.g_s[2]] : 0.f;
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
    gt.l[r] = l[e];
    gt.g[r] = gv[e];
    gt.e[r] = (float)exp(l[e]);
    const float u = (float)exp(ltot - l[e]);
    gt.u[r] = u;
    gt.w[r] = u * gv[e];
  }
  if (lane == 0) gt.decay = (float)exp(ltot);
}

// dst[kk][m] = src[k0 + kk][col0 + m] · scale[k0 + kk] (scale null: 1), a
// bf16 source with rows of `rs` elements; rows at or past `rows` and
// columns at or past `cols` read as 0.  One 16-byte load a thread.
__device__ __forceinline__ void fill_nat_bf16(float (*dst)[SP],
                                              const bf16* src, ll rs,
                                              int rows, int k0, int col0,
                                              int cols, const float* scale) {
  const int t = threadIdx.x, kk = t >> 3, m = 8 * (t & 7);
  const int row = k0 + kk, col = col0 + m;
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (row < rows && col < cols) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * rs + col);
    repro::unpack8_bf16(raw, f);
    const float sc = scale ? scale[row] : 1.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = col + e < cols ? f[e] * sc : 0.f;
  }
  *reinterpret_cast<float4*>(&dst[kk][m]) = make_float4(f[0], f[1], f[2],
                                                        f[3]);
  *reinterpret_cast<float4*>(&dst[kk][m + 4]) = make_float4(f[4], f[5], f[6],
                                                            f[7]);
}

// dst[kk][m] = src[m][k0 + kk], a bf16 source with 64 rows of `rs`
// elements, K along the row; rows at or past `rows` and columns at or past
// `cols` read as 0.
__device__ __forceinline__ void fill_tr_bf16(float (*dst)[SP],
                                             const bf16* src, ll rs, int rows,
                                             int k0, int cols) {
  const int t = threadIdx.x, m = t & 63, g = t >> 6;
  const int col = k0 + 8 * g;
  float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (m < rows && col < cols) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + m * rs + col);
    repro::unpack8_bf16(raw, f);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e >= cols) f[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[8 * g + e][m] = f[e];
}

// dst[kk][m] = src[k0 + kk][col0 + m], an fp32 workspace source with rows
// of `rs` floats.
__device__ __forceinline__ void fill_nat_f32(float (*dst)[SP],
                                             const float* src, int rs,
                                             int k0, int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = threadIdx.x + NTH * r, kk = i >> 4, m = 4 * (i & 15);
    *reinterpret_cast<float4*>(&dst[kk][m]) =
        *reinterpret_cast<const float4*>(src + (ll)(k0 + kk) * rs + col0 + m);
  }
}

// dst[kk][m] = src[m][k0 + kk], an fp32 workspace source of 64 rows of `rs`
// floats, K along the row.
__device__ __forceinline__ void fill_tr_f32(float (*dst)[SP],
                                            const float* src, int rs,
                                            int k0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = threadIdx.x + NTH * r, m = i & 63, g = i >> 6;
    const float4 v =
        *reinterpret_cast<const float4*>(src + (ll)m * rs + k0 + 4 * g);
    dst[4 * g][m] = v.x;
    dst[4 * g + 1][m] = v.y;
    dst[4 * g + 2][m] = v.z;
    dst[4 * g + 3][m] = v.w;
  }
}

// acc[i][j] += sum_k a[k][4ty + i] · b[k][4tx + j] over the slice, in k's
// order.
__device__ __forceinline__ void fma_slice(const Slice& s, float (&acc)[4][4],
                                          int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < KS; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&s.a[k][4 * ty]);
    const float4 bv = *reinterpret_cast<const float4*>(&s.b[k][4 * tx]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// A 64-row product whose slices `fill(k0)` stages: each slice filled, then
// multiplied, by all the block's threads.
template <typename Fill>
__device__ __forceinline__ void product(Slice& s, float (&acc)[4][4], int ty,
                                        int tx, int depth, Fill fill) {
  for (int k0 = 0; k0 < depth; k0 += KS) {
    fill(k0);
    __syncthreads();
    fma_slice(s, acc, ty, tx);
    __syncthreads();
  }
}

// The 16 lanes of a thread row (same ty) sum r; every lane gets the sum.
__device__ __forceinline__ float row_sum16(float r) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

// ---------------------------------------------------------------------------
// the state passes
// ---------------------------------------------------------------------------

template <bool REV>
__global__ void __launch_bounds__(NTH) wide_bwd_state_kernel(const Args a) {
  __shared__ __align__(16) Slice s;
  __shared__ Gates gt;
  __shared__ float red[NTH / 32];
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int n0 = 64 * (tile / PT), p0 = 64 * (tile % PT);
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15, lane = t & 31,
            warp = t >> 5;
  // forward: S += B^T (w o X); reverse: G += C^T (e o dY)
  const bf16* A = REV ? a.c : a.b;
  const ll* as = REV ? a.c_s : a.b_s;
  const bf16* X = REV ? a.dy : a.x;
  const ll* xs = REV ? a.dy_s : a.x_s;
  float* slots = (REV ? a.ws_g : a.ws_s) + (ll)bh * a.nc * STATE;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * ty + i, p = p0 + 4 * tx + j;
      acc[i][j] = REV && a.ds_final && p < PD
                      ? a.ds_final[(ll)bh * NS * PD + (ll)n * PD + p]
                      : 0.f;
    }

  for (int it = 0; it < a.nc; ++it) {
    const int k = REV ? a.nc - 1 - it : it;
    if (warp == 0) chunk_gates(a, b, h, k, lane, gt);
    // the state entering chunk k (forward) or the gradient reaching its
    // end (reverse), to the workspace
    float* dst = slots + (ll)k * STATE;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&dst[(n0 + 4 * ty + i) * PP + p0 + 4 * tx]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (REV) {                         // this tile's share of <G, S_in>
      const float* sin = a.ws_s + ((ll)bh * a.nc + k) * STATE;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            &sin[(n0 + 4 * ty + i) * PP + p0 + 4 * tx]);
        d = fmaf(acc[i][0], v.x, d);
        d = fmaf(acc[i][1], v.y, d);
        d = fmaf(acc[i][2], v.z, d);
        d = fmaf(acc[i][3], v.w, d);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) red[warp] = d;
    }
    __syncthreads();                   // the gates and the shares are in
    if (REV && t == 0) {
      float d = 0.f;
      for (int w = 0; w < NTH / 32; ++w) d += red[w];
      a.ws_part[((ll)bh * a.nc + k) * PART + PART_DOT + tile] = d;
    }
    const float dec = gt.decay;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= dec;
    const int rows = a.S - k * L;
    const bf16* ak = chunk_rows(A, as, b, h, k);
    const bf16* xk = chunk_rows(X, xs, b, h, k);
    const float* scale = REV ? gt.e : gt.w;
    product(s, acc, ty, tx, L, [&](int k0) {
      fill_nat_bf16(s.a, ak, as[2], rows, k0, n0, NS, scale);
      fill_nat_bf16(s.b, xk, xs[2], rows, k0, p0, PD, nullptr);
    });
  }
}

// ---------------------------------------------------------------------------
// each chunk's 64 x 64 products
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTH) wide_bwd_chunk_kernel(const Args a) {
  __shared__ __align__(16) Slice s;
  __shared__ Gates gt;
  __shared__ float red[16][L];
  const int k = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15, lane = t & 31;
  if ((t >> 5) == 0) chunk_gates(a, b, h, k, lane, gt);
  const int rows = a.S - k * L;
  const bf16* ck = chunk_rows(a.c, a.c_s, b, h, k);
  const bf16* bk = chunk_rows(a.b, a.b_s, b, h, k);
  const bf16* xk = chunk_rows(a.x, a.x_s, b, h, k);
  const bf16* dyk = chunk_rows(a.dy, a.dy_s, b, h, k);
  float cb[4][4] = {}, dm[4][4] = {};  // rows i, columns j
  product(s, cb, ty, tx, NS, [&](int k0) {
    fill_tr_bf16(s.a, ck, a.c_s[2], rows, k0, NS);
    fill_tr_bf16(s.b, bk, a.b_s[2], rows, k0, NS);
  });
  product(s, dm, ty, tx, KP, [&](int k0) {
    fill_tr_bf16(s.a, dyk, a.dy_s[2], rows, k0, PD);
    fill_tr_bf16(s.b, xk, a.x_s[2], rows, k0, PD);
  });
  float* rec = a.ws_rec + ((ll)bh * a.nc + k) * REC;
  float dg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i4 = 0; i4 < 4; ++i4) {
    const int i = 4 * ty + i4;
    float m4[4], p4[4];
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      const int j = 4 * tx + j4;
      const float E = j <= i ? (float)exp(gt.l[i] - gt.l[j]) : 0.f;
      const float D = E * gt.g[j];
      m4[j4] = cb[i4][j4] * D;
      p4[j4] = dm[i4][j4] * D;
      dg[j4] += dm[i4][j4] * cb[i4][j4] * E;
      rec[REC_PT + j * L + i] = p4[j4];
    }
    *reinterpret_cast<float4*>(&rec[i * L + 4 * tx]) =
        make_float4(m4[0], m4[1], m4[2], m4[3]);
    *reinterpret_cast<float4*>(&rec[REC_P + i * L + 4 * tx]) =
        make_float4(p4[0], p4[1], p4[2], p4[3]);
  }
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4) red[ty][4 * tx + j4] = dg[j4];
  __syncthreads();
  if (t < L) {                         // sum over i, in the rows' order
    float d = 0.f;
    for (int r = 0; r < 16; ++r) d += red[r][t];
    rec[REC_DG + t] = d;
  }
}

// ---------------------------------------------------------------------------
// each chunk's dX, dC and dB tiles
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTH) wide_bwd_out_kernel(const Args a) {
  __shared__ __align__(16) Slice s;
  __shared__ Gates gt;
  const int tile = blockIdx.x, k = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15, lane = t & 31;
  if ((t >> 5) == 0) chunk_gates(a, b, h, k, lane, gt);
  const int rows = a.S - k * L;
  const bf16* ck = chunk_rows(a.c, a.c_s, b, h, k);
  const bf16* bk = chunk_rows(a.b, a.b_s, b, h, k);
  const bf16* xk = chunk_rows(a.x, a.x_s, b, h, k);
  const bf16* dyk = chunk_rows(a.dy, a.dy_s, b, h, k);
  const ll slot = (ll)bh * a.nc + k;
  const float* sin = a.ws_s + slot * STATE;
  const float* gk = a.ws_g + slot * STATE;
  const float* rec = a.ws_rec + slot * REC;
  float* part = a.ws_part + slot * PART;
  float acc[4][4] = {};
  auto scale_rows = [&](const float* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = v[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= f;
    }
  };

  if (tile < PT) {
    // dX[:, p0 ..] = w o (B G) + M^T dY: rows j, columns p
    const int p0 = 64 * tile;
    product(s, acc, ty, tx, NS, [&](int k0) {
      fill_tr_bf16(s.a, bk, a.b_s[2], rows, k0, NS);
      fill_nat_f32(s.b, gk, PP, k0, p0);
    });
    scale_rows(gt.w);
    product(s, acc, ty, tx, L, [&](int k0) {
      fill_nat_f32(s.a, rec, L, k0, 0);
      fill_nat_bf16(s.b, dyk, a.dy_s[2], rows, k0, p0, PD, nullptr);
    });
    bf16* dx = a.dx + b * a.dx_s[0] + h * a.dx_s[1] + (ll)k * L * a.dx_s[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * ty + i;
      if (j >= rows) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + 4 * tx + q;
        if (p < PD) dx[j * a.dx_s[2] + p] = __float2bfloat16_rn(acc[i][q]);
      }
    }
    return;
  }
  const bool is_dc = tile < PT + NT;
  const int nt = tile - (is_dc ? PT : PT + NT), n0 = 64 * nt;
  if (is_dc) {
    // dC[:, n0 ..] = e o (dY S_in^T) + (dM o D) B: rows i, columns n
    product(s, acc, ty, tx, KP, [&](int k0) {
      fill_tr_bf16(s.a, dyk, a.dy_s[2], rows, k0, PD);
      fill_tr_f32(s.b, sin + (ll)n0 * PP, PP, k0);
    });
    scale_rows(gt.e);
    product(s, acc, ty, tx, L, [&](int k0) {
      fill_nat_f32(s.a, rec + REC_PT, L, k0, 0);
      fill_nat_bf16(s.b, bk, a.b_s[2], rows, k0, n0, NS, nullptr);
    });
  } else {
    // dB[:, n0 ..] = w o (X G^T) + (dM o D)^T C: rows j, columns n
    product(s, acc, ty, tx, KP, [&](int k0) {
      fill_tr_bf16(s.a, xk, a.x_s[2], rows, k0, PD);
      fill_tr_f32(s.b, gk + (ll)n0 * PP, PP, k0);
    });
  }
  // c_i.dc_i (dC) or q_j = b_j.(X G^T)_j (dB, before w scales it), this
  // tile's share; rows past S have c = b = 0
  const bf16* vk = is_dc ? ck : bk;
  const ll vs = is_dc ? a.c_s[2] : a.b_s[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float d = 0.f;
    if (r < rows) {
      const bf16* v = vk + r * vs + n0 + 4 * tx;
#pragma unroll
      for (int q = 0; q < 4; ++q) d = fmaf(__bfloat162float(v[q]), acc[i][q], d);
    }
    d = row_sum16(d);
    if (tx == 0) part[(is_dc ? 0 : PART_Q) + nt * L + r] = d;
  }
  if (!is_dc) {
    scale_rows(gt.w);
    product(s, acc, ty, tx, L, [&](int k0) {
      fill_nat_f32(s.a, rec + REC_P, L, k0, 0);
      fill_nat_bf16(s.b, ck, a.c_s[2], rows, k0, n0, NS, nullptr);
    });
  }
  // dC and dB: (B, H, S, 512) contiguous
  bf16* out = (is_dc ? a.dc : a.db) + ((ll)bh * a.S + (ll)k * L) * NS + n0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    uint2 v;
    v.x = repro::pack_bf16(acc[i][0], acc[i][1]);
    v.y = repro::pack_bf16(acc[i][2], acc[i][3]);
    *reinterpret_cast<uint2*>(out + (ll)r * NS + 4 * tx) = v;
  }
}

// ---------------------------------------------------------------------------
// dgate and dlog_a
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(L) wide_bwd_finish_kernel(const Args a) {
  __shared__ Gates gt;
  __shared__ float v[L], wq[L], dot;
  const int k = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x;
  if (t < 32) chunk_gates(a, b, h, k, t, gt);
  const ll slot = (ll)bh * a.nc + k;
  const float* part = a.ws_part + slot * PART;
  if (t == 0) {
    float d = 0.f;
    for (int i = 0; i < NT * PT; ++i) d += part[PART_DOT + i];
    dot = d;
  }
  __syncthreads();
  float rc = 0.f, q = 0.f;
  for (int nt = 0; nt < NT; ++nt) {
    rc += part[nt * L + t];
    q += part[PART_Q + nt * L + t];
  }
  const float dgate = a.ws_rec[slot * REC + REC_DG + t] + gt.u[t] * q;
  v[t] = rc - gt.g[t] * dgate;
  wq[t] = gt.w[t] * q;
  __syncthreads();
  float wqs = 0.f;
  for (int j = 0; j < L; ++j) wqs += wq[j];
  const float carry = gt.decay * dot + wqs;
  float rsum = 0.f;                    // sum over the rows u >= t, from the end
  for (int u = L - 1; u >= t; --u) rsum += v[u];
  const int row = k * L + t;
  if (row < a.S) {
    a.dgate[b * a.dg_s[0] + h * a.dg_s[1] + row * a.dg_s[2]] = dgate;
    a.dlog_a[b * a.dla_s[0] + h * a.dla_s[1] + row * a.dla_s[2]] =
        rsum + carry;
  }
}

}  // namespace

// Bytes of the workspace for (B, H, S): every chunk's S_in and G (512 x 576
// fp32 each), its record and its shares.
extern "C" long long ssd_scan_bwd_wide_workspace(int B, int H, int S) {
  const ll nc = (S + L - 1) / L;
  return 4ll * B * H * nc * (2 * STATE + REC + PART);
}

// c, b: (B, H, S, 512) bf16; x, dy: (B, H, S, 513) bf16; log_a, gate: (B, H,
// S) fp32; each read through its (batch, head, seq) strides, which are
// multiples of 8 elements (c's and b's head stride may be 0), with a unit
// stride on the last dim and a 16-byte aligned base.  ds_final: (B, H, 512,
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
  if ((ll)B * H > 65535 || nc > 65535) return -1;
  Args a{};
  a.c = static_cast<const bf16*>(c);
  a.b = static_cast<const bf16*>(b);
  a.x = static_cast<const bf16*>(x);
  a.dy = static_cast<const bf16*>(dy);
  a.log_a = static_cast<const float*>(log_a);
  a.gate = static_cast<const float*>(gate);
  a.ds_final = static_cast<const float*>(ds_final);
  a.dc = static_cast<bf16*>(dc);
  a.db = static_cast<bf16*>(db);
  a.dx = static_cast<bf16*>(dx);
  a.dlog_a = static_cast<float*>(dlog_a);
  a.dgate = static_cast<float*>(dgate);
  const ll chunks = (ll)B * H * nc;
  a.ws_s = static_cast<float*>(ws);
  a.ws_g = a.ws_s + chunks * STATE;
  a.ws_rec = a.ws_g + chunks * STATE;
  a.ws_part = a.ws_rec + chunks * REC;
  const ll st[9][3] = {{c_sb, c_sh, c_ss},       {b_sb, b_sh, b_ss},
                       {x_sb, x_sh, x_ss},       {dy_sb, dy_sh, dy_ss},
                       {dx_sb, dx_sh, dx_ss},    {la_sb, la_sh, la_ss},
                       {g_sb, g_sh, g_ss},       {dla_sb, dla_sh, dla_ss},
                       {dg_sb, dg_sh, dg_ss}};
  ll* dst[9] = {a.c_s, a.b_s, a.x_s, a.dy_s, a.dx_s,
                a.la_s, a.g_s, a.dla_s, a.dg_s};
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = st[i][j];
  a.H = H;
  a.S = S;
  a.nc = nc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = B * H;
  wide_bwd_state_kernel<false><<<dim3(NT * PT, bh), NTH, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // after the forward pass: the reverse one reads S_in for <G, S_in>
  wide_bwd_state_kernel<true><<<dim3(NT * PT, bh), NTH, 0, s>>>(a);
  wide_bwd_chunk_kernel<<<dim3(nc, bh), NTH, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_bwd_out_kernel<<<dim3(OUT_TILES, nc, bh), NTH, 0, s>>>(a);
  wide_bwd_finish_kernel<<<dim3(nc, bh), L, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
