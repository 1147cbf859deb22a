// Backward of the SSD scan at zamba2's state N = 64 and head dim P = 64,
// for Hopper: the gradients of the sequential recurrence
//   S_t = a_t S_{t-1} + g_t b_t x_t^T,   y_t = S_t^T c_t   (a_t = exp(log_a_t))
// for the upstream dy (and an optional ds_final, the gradient of the last
// state).
//
// Replaces: no Pallas counterpart.  The JAX package cannot differentiate
// src/repro/kernels/ssd/kernel.py:92 ssd_scan_pallas (the TPU kernel of the
// hybrid model's prefill, which csrc/ssd_scan.cu ports); it trains through
// jax.vjp of its oracle, src/repro/kernels/ssd/ref.py:ssd_ref, and this is
// the gradient of that function.  Its plain twin, computing the same
// function the same way, is kernels/ssd/ref.py:ssd_bwd_ref.
//
// With G_t = dL/dS_t = c_t dy_t^T + a_{t+1} G_{t+1} (G after the last row
// is ds_final, else 0), per (batch, head):
//   forward sweep:  S_t again in fp32; dc_t = S_t dy_t; r_t = c_t . dc_t
//   reverse sweep:  G_t; db_t = g_t G_t x_t; dx_t = g_t G_t^T b_t;
//                   dgate_t = b_t . G_t x_t
//   dlog_a_t = sum_{u >= t} (r_u - g_u dgate_u) + <ds_final, S_last>
//   (a_t <G_t, S_{t-1}> = <G_t, S_t> - g_t dgate_t, and <G_t, S_t> =
//   r_t + a_{t+1} <G_{t+1}, S_t>: a reverse cumulative sum, so no S_{t-1}
//   is kept.)
//
// What bounds the function on the H100: bytes.  At the train shape (B 4,
// H 64, S 2048, b and c shared by the heads) it must read x and dy and
// write dx in bf16, read the gates and write their gradients in fp32, and
// read c, b and write dc, db once: 214 MB, 0.064 ms; the chunked form on
// the tensor cores needs 4.3e10 bf16 operations, 0.043 ms.  This kernel
// steps row by row instead: ~12 N P fp32 operations a (batch, head, row)
// (the two rank-one updates with their decay and the three matrix-vector
// products), 2.6e10, 0.39 ms at 67 TFLOP/s on the CUDA cores, and it
// writes dc and db per head in fp32.
//
// Design (a first, simple kernel; PERF.md has its time against that bound):
//  * one block of 256 threads a (batch, head); the whole 64 x 64 fp32 state
//    lives in registers, so dc and dgate need no reduction across blocks.
//    Thread i holds row n = i / 4 of S (then of G) at the 16 columns
//    16 j + 4 q + e (q = i % 4, j, e < 4): the four threads of a row sum
//    their parts of S dy and G x with two shuffles.  The reverse sweep also
//    keeps G^T (row p = i / 4, the same columns) for G^T b, updated with the
//    same products, so no product needs a reduction across warps;
//  * the rows go in chunks of 32: the block stages a chunk's c, b, x, dy in
//    fp32 and its a_t and g_t in shared memory, then every thread steps
//    through the chunk with no barrier, writing its row's per-row result to
//    shared memory; at the chunk's end the block writes dc (or db and dx)
//    out in full rows, and a warp per row reduces c . dc (or b . G x).
//    r_t waits in dlog_a's buffer for the reverse sweep, whose last warp
//    turns each chunk's r_t - g_t dgate_t into the running reverse sum;
//  * every input is read through its strides (dy as autograd hands it back,
//    b and c with a head stride of 0), one element a thread, in rows;
//  * every output element is summed by one thread or warp in a fixed order:
//    no atomics, equal bits from call to call.  db and dc are written per
//    head; the caller folds heads that share b and c.
// Later work: the chunked (tensor-core) form of the backward, as the forward
// has.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int NS = 64;                 // state size N
constexpr int PD = 64;                 // head dim P
constexpr int T = 32;                  // rows a chunk
constexpr int NTHREADS = 256;
constexpr int TILE = T * 64;           // floats of one staged (T, 64) input
// staged c, b, x, dy; two (T, 64) result tiles; a_t, g_t; reduction slots
constexpr int SMEM_FLOATS = 4 * TILE + 2 * TILE + 2 * T + 16;
constexpr int SMEM = SMEM_FLOATS * 4;

struct Params {
  const bf16 *c, *b, *x, *dy;
  const float *log_a, *gate, *ds_final;   // ds_final (B, H, N, P) or null
  float *dc, *db, *dx, *dlog_a, *dgate;   // dense (B, H, S, .) fp32
  ll c_s[4], b_s[4], x_s[4], dy_s[4];     // (batch, head, seq, last) strides
  ll la_s[3], g_s[3];
  int H, S;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A thread's 8 elements of the (T, 64) rows r0 .. r0 + rows - 1 of one
// (batch, head) of a bf16 tensor (base: its (batch, head) origin), as fp32;
// rows past the chunk's end read as 0.  All loads of a chunk are issued
// before any store to shared memory.
__device__ __forceinline__ void load8(float (&v)[8], const bf16* base, ll ss,
                                      ll sl, int r0, int rows) {
#pragma unroll
  for (int it = 0; it < TILE / NTHREADS; ++it) {
    const int i = threadIdx.x + it * NTHREADS, t = i >> 6, k = i & 63;
    v[it] = t < rows ? __bfloat162float(base[(r0 + t) * ss + k * sl]) : 0.f;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
#pragma unroll
  for (int it = 0; it < TILE / NTHREADS; ++it)
    dst[threadIdx.x + it * NTHREADS] = v[it];
}

__global__ void __launch_bounds__(NTHREADS, 2)
    ssd_scan_bwd_kernel(const Params p) {
  extern __shared__ float sm[];
  float* cs = sm;                      // staged inputs, (T, 64) each
  float* bs = cs + TILE;
  float* xs = bs + TILE;
  float* dys = xs + TILE;
  float* out1 = dys + TILE;            // per-row results, (T, 64) each
  float* out2 = out1 + TILE;
  float* as_ = out2 + TILE;            // a_t
  float* gs = as_ + T;                 // g_t
  float* red = gs + T;                 // reduction slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tid >> 2, q = tid & 3; // row n (or p), column group q
  const int bh = blockIdx.x, bi = bh / p.H, h = bh % p.H;
  const int S = p.S, n_chunks = (S + T - 1) / T;
  const ll row_base = (ll)bh * S;      // of the dense outputs
  const float* la = p.log_a + bi * p.la_s[0] + h * p.la_s[1];
  const float* ga = p.gate + bi * p.g_s[0] + h * p.g_s[1];
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const float4* dys4 = reinterpret_cast<const float4*>(dys);
  const float4* cs4 = reinterpret_cast<const float4*>(cs);
  const float4* bs4 = reinterpret_cast<const float4*>(bs);

  const bf16* c0 = p.c + bi * p.c_s[0] + h * p.c_s[1];
  const bf16* b0 = p.b + bi * p.b_s[0] + h * p.b_s[1];
  const bf16* x0 = p.x + bi * p.x_s[0] + h * p.x_s[1];
  const bf16* dy0 = p.dy + bi * p.dy_s[0] + h * p.dy_s[1];
  // a chunk's c, b, x, dy, a_t and g_t into shared memory, two tensors'
  // loads in flight at a time (four would hold 32 more registers beside
  // the state's and spill under the two-blocks-an-SM bound)
  auto stage_chunk = [&](int r0, int rows) {
    float v[2][TILE / NTHREADS];
    const bool in = tid < rows;
    const float lv = tid < T && in ? la[(r0 + tid) * p.la_s[2]] : 0.f;
    const float gv = tid < T && in ? ga[(r0 + tid) * p.g_s[2]] : 0.f;
    load8(v[0], c0, p.c_s[2], p.c_s[3], r0, rows);
    load8(v[1], b0, p.b_s[2], p.b_s[3], r0, rows);
    store8(cs, v[0]);
    store8(bs, v[1]);
    load8(v[0], x0, p.x_s[2], p.x_s[3], r0, rows);
    load8(v[1], dy0, p.dy_s[2], p.dy_s[3], r0, rows);
    store8(xs, v[0]);
    store8(dys, v[1]);
    if (tid < T) {
      as_[tid] = in ? expf(lv) : 1.f;
      gs[tid] = gv;
    }
  };

  // ---- forward sweep: S_t, dc_t = S_t dy_t, r_t = c_t . dc_t -------------
  float st[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) st[i] = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int r0 = k * T, rows = min(T, S - r0);
    __syncthreads();                   // the last chunk's reads are done
    stage_chunk(r0, rows);
    __syncthreads();
    for (int t = 0; t < rows; ++t) {
      const float a = as_[t], g = gs[t], bn = bs[t * 64 + n];
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 xv = xs4[t * 16 + 4 * j + q];
        const float4 dv = dys4[t * 16 + 4 * j + q];
        float* s4 = st + 4 * j;
        s4[0] = a * s4[0] + g * (bn * xv.x);
        s4[1] = a * s4[1] + g * (bn * xv.y);
        s4[2] = a * s4[2] + g * (bn * xv.z);
        s4[3] = a * s4[3] + g * (bn * xv.w);
        part = fmaf(s4[0], dv.x, part);
        part = fmaf(s4[1], dv.y, part);
        part = fmaf(s4[2], dv.z, part);
        part = fmaf(s4[3], dv.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0) out1[t * 64 + n] = part;
    }
    __syncthreads();
    float* dc = p.dc + (row_base + r0) * NS;
    for (int i = tid; i < rows * 64; i += NTHREADS) dc[i] = out1[i];
    for (int t = warp; t < rows; t += NTHREADS / 32) {
      const float v = warp_sum(cs[t * 64 + lane] * out1[t * 64 + lane] +
                               cs[t * 64 + lane + 32] *
                                   out1[t * 64 + lane + 32]);
      if (lane == 0) p.dlog_a[row_base + r0 + t] = v;    // r_t, for now
    }
  }

  // <ds_final, S_last>, and G (and G^T) start at ds_final
  float gr[16], gt[16];
  float carry = 0.f;
  if (p.ds_final) {
    const float* ds = p.ds_final + (ll)bh * NS * PD;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * j + 4 * q + e;
        gr[4 * j + e] = ds[n * PD + col];
        gt[4 * j + e] = ds[col * PD + n];
        v = fmaf(st[4 * j + e], gr[4 * j + e], v);
      }
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < NTHREADS / 32; ++w) tot += red[w];
      red[8] = tot;
    }
    __syncthreads();
    carry = red[8];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) gr[i] = gt[i] = 0.f;
  }

  // ---- reverse sweep: G_t, db_t, dx_t, dgate_t, dlog_a_t ------------------
  float m = 1.f;                       // a_{t+1}: none after the last row
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int r0 = k * T, rows = min(T, S - r0);
    __syncthreads();
    stage_chunk(r0, rows);
    __syncthreads();
    for (int t = rows - 1; t >= 0; --t) {
      const float cn = cs[t * 64 + n], dp = dys[t * 64 + n];
      float gx = 0.f, gtb = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v4 = t * 16 + 4 * j + q;
        const float4 dv = dys4[v4], xv = xs4[v4], cv = cs4[v4], bv = bs4[v4];
        float* g4 = gr + 4 * j;
        float* h4 = gt + 4 * j;
        g4[0] = fmaf(m, g4[0], cn * dv.x);
        g4[1] = fmaf(m, g4[1], cn * dv.y);
        g4[2] = fmaf(m, g4[2], cn * dv.z);
        g4[3] = fmaf(m, g4[3], cn * dv.w);
        h4[0] = fmaf(m, h4[0], cv.x * dp);
        h4[1] = fmaf(m, h4[1], cv.y * dp);
        h4[2] = fmaf(m, h4[2], cv.z * dp);
        h4[3] = fmaf(m, h4[3], cv.w * dp);
        gx = fmaf(g4[0], xv.x, gx);
        gx = fmaf(g4[1], xv.y, gx);
        gx = fmaf(g4[2], xv.z, gx);
        gx = fmaf(g4[3], xv.w, gx);
        gtb = fmaf(h4[0], bv.x, gtb);
        gtb = fmaf(h4[1], bv.y, gtb);
        gtb = fmaf(h4[2], bv.z, gtb);
        gtb = fmaf(h4[3], bv.w, gtb);
      }
      gx += __shfl_xor_sync(0xffffffffu, gx, 1);
      gtb += __shfl_xor_sync(0xffffffffu, gtb, 1);
      gx += __shfl_xor_sync(0xffffffffu, gx, 2);
      gtb += __shfl_xor_sync(0xffffffffu, gtb, 2);
      if (q == 0) {
        out1[t * 64 + n] = gx;         // (G x)_n
        out2[t * 64 + n] = gtb;        // (G^T b)_p, p = n
      }
      m = as_[t];
    }
    __syncthreads();
    float* db = p.db + (row_base + r0) * NS;
    float* dx = p.dx + (row_base + r0) * PD;
    for (int i = tid; i < rows * 64; i += NTHREADS) {
      const float g = gs[i >> 6];
      db[i] = g * out1[i];
      dx[i] = g * out2[i];
    }
    // dgate_t = b_t . (G x)_t, and the row's term r_t - g_t dgate_t of
    // dlog_a in place of a_t (m already holds the a_t the next chunk needs)
    for (int t = warp; t < rows; t += NTHREADS / 32) {
      const float v = warp_sum(bs[t * 64 + lane] * out1[t * 64 + lane] +
                               bs[t * 64 + lane + 32] *
                                   out1[t * 64 + lane + 32]);
      if (lane == 0) {
        p.dgate[row_base + r0 + t] = v;
        as_[t] = p.dlog_a[row_base + r0 + t] - gs[t] * v;
      }
    }
    __syncthreads();
    if (warp == 0) {
      // the reverse sum over the chunk's rows (lane = row), plus the rows
      // after it
      float v = lane < rows ? as_[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, v, off);
        if (lane + off < 32) v += o;
      }
      if (lane < rows) p.dlog_a[row_base + r0 + lane] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 0);
    }
  }
}

}  // namespace

// c, b: (B, H, S, N) bf16; x, dy: (B, H, S, P) bf16; log_a, gate: (B, H, S)
// fp32; each read through its strides (c and b may have a head stride of
// 0).  ds_final: (B, H, N, P) fp32 contiguous, or null for zero.  dc, db:
// (B, H, S, N), dx: (B, H, S, P), dlog_a, dgate: (B, H, S), all fp32 and
// contiguous.  Returns 0 or a CUDA error code; -1 for arguments the kernel
// does not take.
extern "C" int ssd_scan_bwd(const void* c, const void* b, const void* x,
                            const void* dy, const void* log_a,
                            const void* gate, const void* ds_final, void* dc,
                            void* db, void* dx, void* dlog_a, void* dgate,
                            int B, int H, int S, int N, int P, ll c_sb,
                            ll c_sh, ll c_ss, ll c_sn, ll b_sb, ll b_sh,
                            ll b_ss, ll b_sn, ll x_sb, ll x_sh, ll x_ss,
                            ll x_sp, ll dy_sb, ll dy_sh, ll dy_ss, ll dy_sp,
                            ll la_sb, ll la_sh, ll la_ss, ll g_sb, ll g_sh,
                            ll g_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return -1;
  if (N != NS || P != PD) return -1;   // zamba2's state 64, head dim 64
  const ll blocks = (ll)B * H;
  if (blocks > (1ll << 31) - 1) return -1;
  Params p{};
  p.c = static_cast<const bf16*>(c);
  p.b = static_cast<const bf16*>(b);
  p.x = static_cast<const bf16*>(x);
  p.dy = static_cast<const bf16*>(dy);
  p.log_a = static_cast<const float*>(log_a);
  p.gate = static_cast<const float*>(gate);
  p.ds_final = static_cast<const float*>(ds_final);
  p.dc = static_cast<float*>(dc);
  p.db = static_cast<float*>(db);
  p.dx = static_cast<float*>(dx);
  p.dlog_a = static_cast<float*>(dlog_a);
  p.dgate = static_cast<float*>(dgate);
  const ll cs[4] = {c_sb, c_sh, c_ss, c_sn}, bs[4] = {b_sb, b_sh, b_ss, b_sn},
           xs[4] = {x_sb, x_sh, x_ss, x_sp},
           ds[4] = {dy_sb, dy_sh, dy_ss, dy_sp};
  for (int i = 0; i < 4; ++i) {
    p.c_s[i] = cs[i];
    p.b_s[i] = bs[i];
    p.x_s[i] = xs[i];
    p.dy_s[i] = ds[i];
  }
  p.la_s[0] = la_sb; p.la_s[1] = la_sh; p.la_s[2] = la_ss;
  p.g_s[0] = g_sb; p.g_s[1] = g_sh; p.g_s[2] = g_ss;
  p.H = H;
  p.S = S;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_bwd_kernel<<<static_cast<unsigned>(blocks), NTHREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
