// Chunked SSD scan for a wide state (xlstm's mLSTM: N = 512, P = 513) on
// Hopper.
//
// Replaces: src/repro/kernels/ssd/kernel.py:ssd_scan_pallas (body
// _ssd_kernel) at the shape the xlstm model gives it: c = q, b = k with
// N = d_head = 512, and x = v plus a column of ones (the normalizer), P = 513.
// csrc/ssd_scan.cu covers zamba2's N = P = 64.
//
// Per (batch, head), with chunk length L, inclusive cumulative log-decay l_i
// within a chunk and state S (N x P, fp32) carried across chunks:
//   y_i   = sum_{j<=i} (c_i.b_j) exp(l_i - l_j) g_j x_j + exp(l_i) c_i S
//   S_new = exp(l_L) S + sum_j exp(l_L - l_j) g_j b_j x_j^T
//
// What bounds it on the H100: bytes.  At the prefill shape (B 8, H 4,
// S 1024, N 512, P 513) the traffic is 168 MB (c and b 67 MB, x and y 67 MB,
// s_final 34 MB): 50 us at 3.35 TB/s, against 43 GFLOP over whole 128-row
// chunks, 44 us at 989 TFLOP/s.
//
// Design:
//  * the state of one head is 512 x 513 x 4 B = 1.05 MB: no SM holds it.
//    Column p of S evolves from x[:, p] alone and y[:, p] = c . S[:, p], so
//    the grid splits P into 64-column tiles, (P tile, head, batch), and the
//    blocks never talk to each other: 9 tiles (the last holds only the ones
//    column), 288 blocks at B 8, H 4.  Each block carries its 512 x 64 slice
//    of S in shared memory in fp32 (136 KB with a row pitch of 68 floats, so
//    the B-operand loads of c.S fall in 32 distinct banks) from the first
//    chunk to the last;
//  * the chunk is L = 64 rows, not the TPU's 128: c and b of a 128-row chunk
//    are 128 KB each beside the state.  Any chunk length computes the same
//    function (the JAX wrapper's zero padding already makes it
//    chunk-invariant).  c and b are streamed through shared memory in
//    64-column slices of N, double-buffered with cp.async: slice n+1 loads
//    while slice n is multiplied;
//  * per slice: c.b^T accumulates into the L x L matrix (registers), c.S_prev
//    into the inter-chunk term (registers), then, after a barrier, this
//    slice's 64 rows of S are updated in place: S = exp(l_L) S + b^T (w x);
//  * c.b^T is recomputed in each of the 9 P tiles: 19.3 GFLOP in all at the
//    prefill shape (2.1 once), against 77 GFLOP for the two split fp32
//    products c.S and b^T (w x).  A first pass that writes the masked and
//    decayed M per chunk would save it at the cost of a second launch and
//    M's traffic;
//  * the mask is a select taken before the exp: the decay above the
//    diagonal is never evaluated (the tiles wholly above it skip c.b^T);
//  * rows at or past S are zero-filled and never read, with log_a = gate =
//    0, which is what the JAX wrapper's zero padding gives; columns of x at
//    or past P are zero-filled and never read, so the ragged last P tile
//    reads the one column it has (a 2-byte cp.async with a zero fill), and y
//    and s_final are stored only where the column is below P;
//  * all products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    accumulate).  c, b and x are bf16, so c.b^T is exact; the fp32 operands
//    (S, w_j x_j and M) are each split into a bf16 high part and a bf16
//    remainder, and both are multiplied: 16 bits of mantissa kept (relative
//    error <= 2^-17), where the TPU kernel multiplies in fp32;
//  * c, b, x and y are read and written through (batch, head, seq) strides
//    with unit stride on the last dim and rows 16-byte aligned: q and k are
//    (B, H, S, 512) views of (B, S, H, 512) tensors, x and y (B, H, S, 513)
//    views of (B, S, H, 520) buffers.
// Later work: one block per SM walking its tiles (288 blocks are 2.2 waves
// of 132), overlap of the next chunk's x and first slice with this chunk's
// M.x, wgmma.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int L = 64;              // chunk length
constexpr int NS = 512;            // state size N
constexpr int NSL = 64;            // N slice streamed through shared memory
constexpr int NSLICES = NS / NSL;
constexpr int PT = 64;             // P tile: the state columns of one block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LD = 64 + 8;         // bf16 tile pitch: 16 bytes of padding
constexpr int LDS = PT + 4;        // fp32 state pitch

struct Smem {
  float s[NS * LDS];               // S[:, p0:p0+64] of this block, fp32
  bf16 c[2][L * LD];               // c slices, double-buffered; after the
                                   // slice loop: M's bf16 high part and rest
  bf16 b[2][L * LD];               // b slices, double-buffered
  bf16 x[L * LD];                  // the chunk's x tile
  bf16 wx_hi[L * LD];              // w_j x_j, bf16 high part
  bf16 wx_lo[L * LD];              // and remainder
  float la[L];                     // log_a of the chunk (0 past S)
  float g[L];                      // gate (0 past S)
  float lcum[L];                   // inclusive cumulative log-decay l
  float e[L];                      // exp(l_i)
  float w[L];                      // exp(l_L - l_j) g_j
  float decay;                     // exp(l_L)
};

struct Strides {
  ll c[3], b[3], x[3], y[3], la[3], g[3];  // (batch, head, seq)
};

// Rows [row0, row0 + L), columns [col0, col0 + 64) of a bf16 slice into
// shared memory.  Rows at or past S and columns at or past ncols (relative
// to col0) are zero-filled and not read.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* src, ll stride,
                                          int row0, int S, int col0,
                                          int ncols, int tid) {
#pragma unroll
  for (int i = 0; i < L * 8 / NTHREADS; ++i) {
    const int ch = tid + i * NTHREADS;
    const int r = ch / 8;
    const int col = (ch % 8) * 8;
    const int row = row0 + r;
    const int bytes = row < S ? max(0, min(16, (ncols - col) * 2)) : 0;
    repro::cp_async_16(repro::smem_u32(s + r * LD + col),
                       src + (ll)min(row, S - 1) * stride + col0 +
                           (bytes > 0 ? col : 0),
                       bytes);
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

__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_scan_wide_kernel(const bf16* __restrict__ c,
                         const bf16* __restrict__ b,
                         const bf16* __restrict__ x,
                         const float* __restrict__ log_a,
                         const float* __restrict__ gate,
                         bf16* __restrict__ y, float* __restrict__ s_final,
                         int H, int S, int P, Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int pw = min(PT, P - p0);        // valid columns of this tile
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;               // mma fragment row within 8 rows
  const int t4 = lane % 4;               // mma fragment column pair
  const int mi = lane / 8;               // ldmatrix matrix index
  const int mr = lane % 8;               // ldmatrix row within it

  const bf16* cg = c + bb * st.c[0] + h * st.c[1];
  const bf16* bg = b + bb * st.b[0] + h * st.b[1];
  const bf16* xg = x + bb * st.x[0] + h * st.x[1];
  bf16* yg = y + bb * st.y[0] + h * st.y[1] + p0;
  const float* lag = log_a + bb * st.la[0] + h * st.la[1];
  const float* gg = gate + bb * st.g[0] + h * st.g[1];

  // warp w: 16 rows wr (of y and c.b^T: i; of each S slice: n) and 32
  // columns wc (of y and S: p; of c.b^T: j)
  const int wr = 16 * (warp & 3);
  const int wc = 32 * (warp >> 2);
  const bool cb_live = wc <= wr + 15;    // the c.b^T tile reaches j <= i

  for (int k = tid; k < NS * LDS; k += NTHREADS) sm.s[k] = 0.f;

  const int n_chunks = (S + L - 1) / L;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int r0 = ci * L;
    load_tile(sm.x, xg, st.x[2], r0, S, p0, pw, tid);
    load_tile(sm.c[0], cg, st.c[2], r0, S, 0, NSL, tid);
    load_tile(sm.b[0], bg, st.b[2], r0, S, 0, NSL, tid);
    repro::cp_async_commit();
    if (tid < L) {
      const int row = r0 + tid;
      sm.la[tid] = row < S ? lag[(ll)row * st.la[2]] : 0.f;
      sm.g[tid] = row < S ? gg[(ll)row * st.g[2]] : 0.f;
    }
    __syncthreads();                     // la and g visible

    if (warp == 0) {                     // l = inclusive cumsum of log_a
      const float v0 = sm.la[2 * lane];
      const float v1 = v0 + sm.la[2 * lane + 1];
      float incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float ltot = __shfl_sync(0xffffffffu, excl + v1, 31);
      const float lv[2] = {excl + v0, excl + v1};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k;
        sm.lcum[r] = lv[k];
        sm.e[r] = expf(lv[k]);
        sm.w[r] = expf(ltot - lv[k]) * sm.g[r];
      }
      if (lane == 0) sm.decay = expf(ltot);
    }
    repro::cp_async_wait_all();
    __syncthreads();                     // x, slice 0 landed; l, e, w ready

    // w_j x_j as bf16 high part + remainder, the B operand of b^T (w x)
    for (int k = tid; k < L * PT / 2; k += NTHREADS) {
      const int j = k / (PT / 2);
      const int col = 2 * (k % (PT / 2));
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sm.x + j * LD + col));
      uint32_t hi, lo;
      split_bf16(f.x * sm.w[j], f.y * sm.w[j], hi, lo);
      *reinterpret_cast<uint32_t*>(sm.wx_hi + j * LD + col) = hi;
      *reinterpret_cast<uint32_t*>(sm.wx_lo + j * LD + col) = lo;
    }
    __syncthreads();                     // wx visible

    float cb[4][4], yi[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[nt][e] = yi[nt][e] = 0.f;
    const float decay = sm.decay;

    for (int sl = 0; sl < NSLICES; ++sl) {
      const int buf = sl & 1;
      if (sl + 1 < NSLICES) {            // prefetch the next slice of N
        load_tile(sm.c[buf ^ 1], cg, st.c[2], r0, S, (sl + 1) * NSL, NSL,
                  tid);
        load_tile(sm.b[buf ^ 1], bg, st.b[2], r0, S, (sl + 1) * NSL, NSL,
                  tid);
        repro::cp_async_commit();
      }
      const bf16* cs = sm.c[buf];
      const bf16* bs = sm.b[buf];
      float* ss = sm.s + sl * NSL * LDS;  // this slice's 64 rows of S

      uint32_t cf[NSL / 16][4];          // c rows wr: A operand, K = n
#pragma unroll
      for (int kk = 0; kk < NSL / 16; ++kk)
        repro::ldmatrix_x4(cf[kk], repro::smem_u32(
            cs + (wr + lane % 16) * LD + kk * 16 + (lane / 16) * 8));

      if (cb_live) {                     // c.b^T, columns j of wc..wc+31
#pragma unroll
        for (int kk = 0; kk < NSL / 16; ++kk) {
#pragma unroll
          for (int jb = 0; jb < 2; ++jb) {
            uint32_t bfr[4];
            repro::ldmatrix_x4(bfr, repro::smem_u32(
                bs + (wc + jb * 16 + mr + 8 * (mi >> 1)) * LD + kk * 16 +
                8 * (mi & 1)));
            repro::mma_bf16_16816(cb[2 * jb], cf[kk], bfr[0], bfr[1]);
            repro::mma_bf16_16816(cb[2 * jb + 1], cf[kk], bfr[2], bfr[3]);
          }
        }
      }
      if (ci > 0) {                      // c.S_prev, columns p of wc..wc+31
#pragma unroll
        for (int kk = 0; kk < NSL / 16; ++kk) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float* sp = ss + (kk * 16 + 2 * t4) * LDS + wc + nt * 8 +
                              gq;
            uint32_t hi0, lo0, hi1, lo1;
            split_bf16(sp[0], sp[LDS], hi0, lo0);
            split_bf16(sp[8 * LDS], sp[9 * LDS], hi1, lo1);
            repro::mma_bf16_16816(yi[nt], cf[kk], hi0, hi1);
            repro::mma_bf16_16816(yi[nt], cf[kk], lo0, lo1);
          }
        }
      }
      __syncthreads();                   // every read of this S slice done

      // S[slice] = exp(l_L) S[slice] + b^T (w x): rows wr, columns wc
      float sa[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              ss + (wr + gq + 8 * r) * LDS + wc + nt * 8 + 2 * t4);
          sa[nt][2 * r] = v.x * decay;
          sa[nt][2 * r + 1] = v.y * decay;
        }
      }
#pragma unroll
      for (int ks = 0; ks < L / 16; ++ks) {
        uint32_t af[4];                  // b^T: A operand (rows n, K = j)
        repro::ldmatrix_x4_trans(af, repro::smem_u32(
            bs + (ks * 16 + mr + 8 * (mi >> 1)) * LD + wr + 8 * (mi & 1)));
#pragma unroll
        for (int dq = 0; dq < 2; ++dq) {
          const int off = (ks * 16 + mr + 8 * (mi & 1)) * LD + wc + dq * 16 +
                          8 * (mi >> 1);
          uint32_t hi[4], lo[4];         // w x rows j: B operand (K = j)
          repro::ldmatrix_x4_trans(hi, repro::smem_u32(sm.wx_hi + off));
          repro::ldmatrix_x4_trans(lo, repro::smem_u32(sm.wx_lo + off));
          repro::mma_bf16_16816(sa[2 * dq], af, hi[0], hi[1]);
          repro::mma_bf16_16816(sa[2 * dq], af, lo[0], lo[1]);
          repro::mma_bf16_16816(sa[2 * dq + 1], af, hi[2], hi[3]);
          repro::mma_bf16_16816(sa[2 * dq + 1], af, lo[2], lo[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(ss + (wr + gq + 8 * r) * LDS + wc +
                                     nt * 8 + 2 * t4) =
              make_float2(sa[nt][2 * r], sa[nt][2 * r + 1]);
      repro::cp_async_wait_all();
      __syncthreads();                   // next slice landed; this one free
    }

    // M[i,j] = (c_i.b_j) exp(l_i - l_j) g_j for j <= i, else 0, as bf16
    // high part and remainder into the c buffers (free after the loop).  The
    // select comes first, so the exp above the diagonal is never formed.
    bf16* m_hi = sm.c[0];
    bf16* m_lo = sm.c[1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = wr + gq + 8 * r;
        const int j = wc + nt * 8 + 2 * t4;
        float m[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          m[q] = 0.f;
          if (j + q <= i)
            m[q] = cb[nt][2 * r + q] * expf(sm.lcum[i] - sm.lcum[j + q]) *
                   sm.g[j + q];
        }
        uint32_t hi, lo;
        split_bf16(m[0], m[1], hi, lo);
        *reinterpret_cast<uint32_t*>(m_hi + i * LD + j) = hi;
        *reinterpret_cast<uint32_t*>(m_lo + i * LD + j) = lo;
      }
    }
    __syncthreads();                     // M visible

    // y = exp(l_i) c_i.S_prev + M.x for rows wr, columns wc
    const float e0 = sm.e[wr + gq];
    const float e1 = sm.e[wr + gq + 8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      yi[nt][0] *= e0;
      yi[nt][1] *= e0;
      yi[nt][2] *= e1;
      yi[nt][3] *= e1;
    }
    for (int jb = 0; jb <= (warp & 3); ++jb) {   // j blocks at or left of i
      uint32_t mh[4], ml[4];
      const int aoff = (wr + lane % 16) * LD + jb * 16 + (lane / 16) * 8;
      repro::ldmatrix_x4(mh, repro::smem_u32(m_hi + aoff));
      repro::ldmatrix_x4(ml, repro::smem_u32(m_lo + aoff));
#pragma unroll
      for (int dq = 0; dq < 2; ++dq) {
        uint32_t xf[4];
        repro::ldmatrix_x4_trans(xf, repro::smem_u32(
            sm.x + (jb * 16 + mr + 8 * (mi & 1)) * LD + wc + dq * 16 +
            8 * (mi >> 1)));
        repro::mma_bf16_16816(yi[2 * dq], mh, xf[0], xf[1]);
        repro::mma_bf16_16816(yi[2 * dq], ml, xf[0], xf[1]);
        repro::mma_bf16_16816(yi[2 * dq + 1], mh, xf[2], xf[3]);
        repro::mma_bf16_16816(yi[2 * dq + 1], ml, xf[2], xf[3]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {        // rows past S are never stored
      const int row = r0 + wr + gq + 8 * r;
      if (row >= S) continue;
      bf16* yr = yg + (ll)row * st.y[2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wc + nt * 8 + 2 * t4;
        if (col + 1 < pw) {
          *reinterpret_cast<uint32_t*>(yr + col) =
              repro::pack_bf16(yi[nt][2 * r], yi[nt][2 * r + 1]);
        } else if (col < pw) {           // the ragged last column
          yr[col] = __float2bfloat16_rn(yi[nt][2 * r]);
        }
      }
    }
    __syncthreads();                     // before the next chunk's loads
  }

  float* sf = s_final + ((ll)bb * H + h) * NS * P + p0;
  for (int k = tid; k < NS * PT; k += NTHREADS) {
    const int n = k / PT;
    const int col = k % PT;
    if (col < pw) sf[(ll)n * P + col] = sm.s[n * LDS + col];
  }
}

}  // namespace

// c, b: (B, H, S, 512) bf16; x, y: (B, H, S, P) bf16; log_a, gate: (B, H, S)
// fp32; each read through its (batch, head, seq) strides with a unit stride
// on the last dim of c, b, x, y and rows 16-byte aligned.  s_final:
// (B, H, 512, P) fp32, contiguous.  Returns 0 or a CUDA error code; -1 for
// arguments the kernel does not take.
extern "C" int ssd_scan_wide_fwd(const void* c, const void* b, const void* x,
                                 const void* log_a, const void* gate, void* y,
                                 void* s_final, int B, int H, int S, int N,
                                 int P, ll c_sb, ll c_sh, ll c_ss, ll b_sb,
                                 ll b_sh, ll b_ss, ll x_sb, ll x_sh, ll x_ss,
                                 ll y_sb, ll y_sh, ll y_ss, ll la_sb,
                                 ll la_sh, ll la_ss, ll g_sb, ll g_sh,
                                 ll g_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0 || B > 65535 || H > 65535)
    return -1;
  if (N != NS) return -1;              // xlstm's d_head 512
  const Strides st = {{c_sb, c_sh, c_ss},    {b_sb, b_sh, b_ss},
                      {x_sb, x_sh, x_ss},    {y_sb, y_sh, y_ss},
                      {la_sb, la_sh, la_ss}, {g_sb, g_sh, g_ss}};
  constexpr int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_wide_kernel<<<dim3((P + PT - 1) / PT, H, B), NTHREADS, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(c), static_cast<const bf16*>(b),
      static_cast<const bf16*>(x), static_cast<const float*>(log_a),
      static_cast<const float*>(gate), static_cast<bf16*>(y),
      static_cast<float*>(s_final), H, S, P, st);
  return static_cast<int>(cudaGetLastError());
}
