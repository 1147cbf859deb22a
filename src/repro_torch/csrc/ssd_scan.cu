// Chunked SSD scan (the Mamba2 state-space-duality recurrence) for Hopper.
//
// Replaces: src/repro/kernels/ssd/kernel.py:ssd_scan_pallas (body
// _ssd_kernel), the TPU kernel of the hybrid model's prefill.
//
// Per (batch, head), with chunk length L = 128, inclusive cumulative
// log-decay l_i within a chunk and state S (N x P, fp32) carried across
// chunks:
//   y_i   = sum_{j<=i} (c_i.b_j) exp(l_i - l_j) g_j x_j + exp(l_i) c_i S
//   S_new = exp(l_L) S + sum_j exp(l_L - l_j) g_j b_j x_j^T
//
// What bounds it on the H100: bytes.  At the prefill shape (B=8, H=64,
// S=1024, N=P=64) the four products are 25.8 GFLOP counted over whole L x L
// chunks (26 us at 989 TFLOP/s), against ~149 MB of traffic (x and y 67 MB
// each, b and c read once through their head stride of 0, the gates, the
// final state): 44 us at 3.35 TB/s.
//
// Design:
//  * one block of 8 warps per (head, batch); the TPU's sequential chunk
//    axis becomes the loop inside the block, and the state never leaves
//    the block: each warp holds a 16 x 32 tile of it in fp32 registers
//    (the accumulators of its mma tiles) from the first chunk to the last;
//  * per chunk, c, b and x (128 x 64 bf16 each) are copied to shared
//    memory with cp.async, rows padded by 16 bytes so the 8 rows of each
//    ldmatrix 8x8 matrix fall in distinct banks; rows at or past S are
//    zero-filled and never read from memory, and their log_a and gate are
//    taken as 0, which is what the JAX wrapper's zero padding gives: l stays
//    flat past S, those rows add nothing, and S_final is the padded one;
//  * warp 0 scans log_a (4 rows a lane, then a warp scan) into l, exp(l_i)
//    and w_j = exp(l_L - l_j) g_j;
//  * warp w computes y for rows 16w..16w+15: c_i.S_prev, scaled by
//    exp(l_i), then, for each 16-column block of j at or left of the
//    diagonal, c.b^T on the tensor cores, the decay and the gate applied in
//    the accumulator registers, and M.x;
//  * the decay above the diagonal is never evaluated: l falls within a
//    chunk, so l_i - l_j > 0 there and exceeds 88 at zamba2's gates (log_a
//    ~ -0.8 a step), where expf overflows.  The mask is a select taken
//    before the exp (the TPU kernel's jnp.where picks 0 over the inf it
//    formed; a product with a 0/1 mask would give NaN);
//  * all four products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//    fp32 accumulate).  c, b and x are bf16 already, so their products are
//    exact.  The fp32 operands (M, the state S, and w_j x_j) are each split
//    into a bf16 high part and a bf16 remainder, and both are multiplied:
//    the operand keeps 16 of fp32's 24 bits of mantissa (relative error
//    <= 2^-17), where the TPU kernel multiplies in fp32.  The card check in
//    chip_smoke.py holds y and S_final against the plain fp32 recurrence;
//  * the state update: warp w owns rows n0 = 16 (w mod 4) and columns
//    p0 = 32 (w / 4) of S; b^T comes from shared memory through
//    ldmatrix.trans, x through ldmatrix.trans scaled by w_j in registers;
//  * b, c, x and y are read and written through (batch, head, seq)
//    strides, so the model's (B, S, H, P) activations and the head-shared
//    (B, S, N) b and c are used without a copy.
// Later work: overlap the next chunk's loads with this chunk's products
// (a second buffer), balance the intra-chunk work across warps (warp 7
// does 8 column blocks, warp 0 one), wgmma.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int L = 128;         // chunk length
constexpr int NS = 64;         // state size N
constexpr int PD = 64;         // head dim P
constexpr int NWARPS = 8;      // one per 16 rows of the chunk
constexpr int NTHREADS = NWARPS * 32;
constexpr int LD = 64 + 8;     // padded row pitch of c, b, x (N == P == 64)
constexpr int LDS = PD + 8;    // padded row pitch of the state's bf16 parts

struct Smem {
  bf16 c[L * LD];
  bf16 b[L * LD];
  bf16 x[L * LD];
  bf16 s_hi[NS * LDS];         // the carried state, bf16 high part
  bf16 s_lo[NS * LDS];         // and remainder
  float la[L];                 // log_a of the chunk (0 past S)
  float g[L];                  // gate (0 past S)
  float lcum[L];               // inclusive cumulative log-decay l
  float e[L];                  // exp(l_i)
  float w[L];                  // exp(l_L - l_j) g_j
  float decay;                 // exp(l_L)
};

struct Strides {
  ll c[3], b[3], x[3], y[3], la[3], g[3];  // (batch, head, seq)
};

// Rows [row0, row0 + L) of an (S, 64) bf16 slice into shared memory; rows
// at or past S are zero-filled.
__device__ __forceinline__ void load_rows(bf16* s, const bf16* src, ll stride,
                                          int row0, int S, int tid) {
#pragma unroll
  for (int i = 0; i < L * 8 / NTHREADS; ++i) {
    const int ch = tid + i * NTHREADS;
    const int r = ch / 8;
    const int col = (ch % 8) * 8;
    const int row = row0 + r;
    repro::cp_async_16(repro::smem_u32(s + r * LD + col),
                       src + (ll)min(row, S - 1) * stride + col,
                       row < S ? 16 : 0);
  }
}

// Two floats → bf16 high parts and bf16 remainders, each packed in pairs.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = repro::pack_bf16(a - hf.x, b - hf.y);
}

// A pair of bf16 scaled by (w_lo, w_hi), split as above.
__device__ __forceinline__ void scale_split(uint32_t v, float w_lo, float w_hi,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * w_lo, f.y * w_hi, hi, lo);
}

__global__ void __launch_bounds__(NTHREADS, 2)
    ssd_scan_kernel(const bf16* __restrict__ c, const bf16* __restrict__ b,
                    const bf16* __restrict__ x,
                    const float* __restrict__ log_a,
                    const float* __restrict__ gate, bf16* __restrict__ y,
                    float* __restrict__ s_final, int H, int S, Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int h = blockIdx.x;
  const int bb = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;      // mma fragment row within an 8-row group
  const int t4 = lane % 4;      // mma fragment column pair
  const int mi = lane / 8;      // ldmatrix matrix index
  const int mr = lane % 8;      // ldmatrix row within it

  const bf16* cg = c + bb * st.c[0] + h * st.c[1];
  const bf16* bg = b + bb * st.b[0] + h * st.b[1];
  const bf16* xg = x + bb * st.x[0] + h * st.x[1];
  bf16* yg = y + bb * st.y[0] + h * st.y[1];
  const float* lag = log_a + bb * st.la[0] + h * st.la[1];
  const float* gg = gate + bb * st.g[0] + h * st.g[1];

  const int i0 = 16 * warp;              // this warp's rows of y
  const int n0 = 16 * (warp & 3);        // this warp's tile of the state
  const int p0 = 32 * (warp >> 2);
  float sacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int r0 = ci * L;
    load_rows(sm.c, cg, st.c[2], r0, S, tid);
    load_rows(sm.b, bg, st.b[2], r0, S, tid);
    load_rows(sm.x, xg, st.x[2], r0, S, tid);
    repro::cp_async_commit();
    if (tid < L) {
      const int row = r0 + tid;
      sm.la[tid] = row < S ? lag[(ll)row * st.la[2]] : 0.f;
      sm.g[tid] = row < S ? gg[(ll)row * st.g[2]] : 0.f;
    }
    __syncthreads();                     // la and g visible

    if (warp == 0) {                     // l = inclusive cumsum of log_a
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = sm.la[4 * lane + k];
      v[1] += v[0];
      v[2] += v[1];
      v[3] += v[2];
      float incl = v[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float ltot = __shfl_sync(0xffffffffu, excl + v[3], 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = 4 * lane + k;
        const float l = excl + v[k];
        sm.lcum[r] = l;
        sm.e[r] = expf(l);
        sm.w[r] = expf(ltot - l) * sm.g[r];
      }
      if (lane == 0) sm.decay = expf(ltot);
    }
    repro::cp_async_wait_all();
    __syncthreads();                     // c, b, x landed; l, e, w ready

    // ---- y for rows i0..i0+15 -------------------------------------------
    uint32_t cf[NS / 16][4];             // c rows: A operand, K = N
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)
      repro::ldmatrix_x4(cf[kk], repro::smem_u32(
          sm.c + (i0 + lane % 16) * LD + kk * 16 + (lane / 16) * 8));

    float acc[PD / 8][4];
#pragma unroll
    for (int nt = 0; nt < PD / 8; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    if (ci > 0) {                        // exp(l_i) · c_i · S_prev
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < PD / 16; ++dp) {
          uint32_t hi[4], lo[4];
          const int off = (kk * 16 + mr + 8 * (mi & 1)) * LDS + dp * 16 +
                          8 * (mi >> 1);
          repro::ldmatrix_x4_trans(hi, repro::smem_u32(sm.s_hi + off));
          repro::ldmatrix_x4_trans(lo, repro::smem_u32(sm.s_lo + off));
          repro::mma_bf16_16816(acc[2 * dp], cf[kk], hi[0], hi[1]);
          repro::mma_bf16_16816(acc[2 * dp], cf[kk], lo[0], lo[1]);
          repro::mma_bf16_16816(acc[2 * dp + 1], cf[kk], hi[2], hi[3]);
          repro::mma_bf16_16816(acc[2 * dp + 1], cf[kk], lo[2], lo[3]);
        }
      }
      const float e0 = sm.e[i0 + gq];
      const float e1 = sm.e[i0 + gq + 8];
#pragma unroll
      for (int nt = 0; nt < PD / 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
    }

    const float l_row[2] = {sm.lcum[i0 + gq], sm.lcum[i0 + gq + 8]};
    for (int jb = 0; jb <= warp; ++jb) { // column blocks at or left of the diagonal
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        uint32_t bfr[4];
        repro::ldmatrix_x4(bfr, repro::smem_u32(
            sm.b + (jb * 16 + mr + 8 * (mi >> 1)) * LD + kk * 16 +
            8 * (mi & 1)));
        repro::mma_bf16_16816(s[0], cf[kk], bfr[0], bfr[1]);
        repro::mma_bf16_16816(s[1], cf[kk], bfr[2], bfr[3]);
      }
      // M[i,j] = (c_i.b_j) exp(l_i - l_j) g_j for j <= i, else 0: the select
      // comes first, so the exp above the diagonal is never formed
      uint32_t mhi[4], mlo[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gq + 8 * (e >> 1);
          const int j = jb * 16 + nt * 8 + 2 * t4 + (e & 1);
          m[e] = 0.f;
          if (j <= i) m[e] = s[nt][e] * expf(l_row[e >> 1] - sm.lcum[j]) *
                             sm.g[j];
        }
        split_bf16(m[0], m[1], mhi[2 * nt], mlo[2 * nt]);
        split_bf16(m[2], m[3], mhi[2 * nt + 1], mlo[2 * nt + 1]);
      }
#pragma unroll
      for (int dp = 0; dp < PD / 16; ++dp) {
        uint32_t xf[4];
        repro::ldmatrix_x4_trans(xf, repro::smem_u32(
            sm.x + (jb * 16 + mr + 8 * (mi & 1)) * LD + dp * 16 +
            8 * (mi >> 1)));
        repro::mma_bf16_16816(acc[2 * dp], mhi, xf[0], xf[1]);
        repro::mma_bf16_16816(acc[2 * dp], mlo, xf[0], xf[1]);
        repro::mma_bf16_16816(acc[2 * dp + 1], mhi, xf[2], xf[3]);
        repro::mma_bf16_16816(acc[2 * dp + 1], mlo, xf[2], xf[3]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {        // rows past S are never stored
      const int row = r0 + i0 + gq + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int nt = 0; nt < PD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(yg + (ll)row * st.y[2] + nt * 8 +
                                     2 * t4) =
            repro::pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }

    // ---- S = exp(l_L) S + sum_j b_j (w_j x_j)^T, this warp's tile ---------
    const float decay = sm.decay;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] *= decay;
#pragma unroll 2
    for (int ks = 0; ks < L / 16; ++ks) {
      uint32_t af[4];                    // b^T: A operand (rows n, K = j)
      repro::ldmatrix_x4_trans(af, repro::smem_u32(
          sm.b + (ks * 16 + mr + 8 * (mi >> 1)) * LD + n0 + 8 * (mi & 1)));
      const float w0 = sm.w[ks * 16 + 2 * t4];
      const float w1 = sm.w[ks * 16 + 2 * t4 + 1];
      const float w8 = sm.w[ks * 16 + 8 + 2 * t4];
      const float w9 = sm.w[ks * 16 + 9 + 2 * t4];
#pragma unroll
      for (int dq = 0; dq < 2; ++dq) {
        uint32_t xf[4];                  // x rows j: B operand (K = j)
        repro::ldmatrix_x4_trans(xf, repro::smem_u32(
            sm.x + (ks * 16 + mr + 8 * (mi & 1)) * LD + p0 + dq * 16 +
            8 * (mi >> 1)));
        uint32_t hi[4], lo[4];
        scale_split(xf[0], w0, w1, hi[0], lo[0]);   // rows 2t, 2t+1
        scale_split(xf[1], w8, w9, hi[1], lo[1]);   // rows 2t+8, 2t+9
        scale_split(xf[2], w0, w1, hi[2], lo[2]);
        scale_split(xf[3], w8, w9, hi[3], lo[3]);
        repro::mma_bf16_16816(sacc[2 * dq], af, hi[0], hi[1]);
        repro::mma_bf16_16816(sacc[2 * dq], af, lo[0], lo[1]);
        repro::mma_bf16_16816(sacc[2 * dq + 1], af, hi[2], hi[3]);
        repro::mma_bf16_16816(sacc[2 * dq + 1], af, lo[2], lo[3]);
      }
    }
    __syncthreads();                     // every warp is done with this chunk

    // the new state's bf16 parts, for the next chunk's c·S
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (n0 + gq + 8 * r) * LDS + p0 + nt * 8 + 2 * t4;
        uint32_t hi, lo;
        split_bf16(sacc[nt][2 * r], sacc[nt][2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sm.s_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(sm.s_lo + off) = lo;
      }
    }
  }

  float* sf = s_final + ((ll)bb * H + h) * NS * PD;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(sf + (n0 + gq + 8 * r) * PD + p0 + nt * 8 +
                                 2 * t4) =
          make_float2(sacc[nt][2 * r], sacc[nt][2 * r + 1]);
  }
}

}  // namespace

// c, b: (B, H, S, N) bf16; x, y: (B, H, S, P) bf16; log_a, gate: (B, H, S)
// fp32; each read through its (batch, head, seq) strides with a unit stride
// on the last dim of c, b, x, y.  s_final: (B, H, N, P) fp32, contiguous.
// Returns 0 or a CUDA error code; -1 for arguments the kernel does not take.
extern "C" int ssd_scan_fwd(const void* c, const void* b, const void* x,
                            const void* log_a, const void* gate, void* y,
                            void* s_final, int B, int H, int S, int N, int P,
                            ll c_sb, ll c_sh, ll c_ss, ll b_sb, ll b_sh,
                            ll b_ss, ll x_sb, ll x_sh, ll x_ss, ll y_sb,
                            ll y_sh, ll y_ss, ll la_sb, ll la_sh, ll la_ss,
                            ll g_sb, ll g_sh, ll g_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535) return -1;
  if (N != NS || P != PD) return -1;  // zamba2's state 64, head dim 64
  const Strides st = {{c_sb, c_sh, c_ss},    {b_sb, b_sh, b_ss},
                      {x_sb, x_sh, x_ss},    {y_sb, y_sh, y_ss},
                      {la_sb, la_sh, la_ss}, {g_sb, g_sh, g_ss}};
  constexpr int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3(H, B), NTHREADS, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(c), static_cast<const bf16*>(b),
      static_cast<const bf16*>(x), static_cast<const float*>(log_a),
      static_cast<const float*>(gate), static_cast<bf16*>(y),
      static_cast<float*>(s_final), H, S, st);
  return static_cast<int>(cudaGetLastError());
}
