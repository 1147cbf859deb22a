// Flash attention backward (causal / windowed GQA self-attention) for Hopper:
// dq, dk, dv from q, k, v, the forward's output o and row log-sum-exp lse,
// and the upstream gradient do.
//
// Replaces: nothing on the TPU.  The JAX package cannot differentiate
// through src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (pallas_call has no reverse-mode rule and the kernel no custom_vjp); this
// computes the gradient of repro.kernels.flash_attention.ref.attention_ref,
// the function the forward kernel computes.
//
// What bounds it on the H100: operations.  At the training path's shape
// (B=4, Hq=28, Hkv=4, S=2048, D=128, causal) the five products (S = QK^T and
// dP = dO V^T in both kernels below, dV = P^T dO, dK = dS^T Q, dQ = dS K;
// S is recomputed once more, counted in the five) need 5 · 2·S²·D per
// (b, q head), halved by the mask: 3.0e11 FLOP, 0.30 ms at 989 TFLOP/s,
// against 268 MB of q, k, v, o, do, dq, dk, dv: 0.08 ms at 3.35 TB/s.
//
// Design (FlashAttention-2's backward, three kernels, no atomics):
//  * delta_kernel: Delta = rowsum(dO ∘ O) in fp32, (B, Hq, S);
//  * dkdv_kernel: one block of 4 warps per (k tile of 64 keys, kv head,
//    batch); each warp owns 16 keys.  The block loops over the q heads of
//    the GQA group (7 for qwen2-7b, not a power of two) and over 32-row q
//    tiles, and accumulates dK and dV for its keys in registers, in fp32:
//    no other block writes them, so they are never reduced across blocks;
//  * dq_kernel: one block per (q tile of 64 rows, q head, batch), looping
//    over 64-key tiles, accumulating dQ in registers;
//  * P = exp2(S·scale·log2e − lse·log2e) is rebuilt from the forward's lse,
//    so no (S, S) matrix reaches memory;
//  * all products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    accumulators); P and dS are rounded to bf16 as their operands;
//    kernels/common.py states the tolerance that follows;
//  * q, k, v, o, do, dq, dk, dv are read and written through (batch, head,
//    seq) strides, so the model's (B, S, H, D) tensors need no transpose;
//  * tiles of keys above the causal diagonal, or of queries that cannot see
//    a key tile, are skipped in both kernels; rows past S are zero-filled on
//    load and never stored;
//  * the next q tile (dkdv) or k/v tile (dq) is copied with cp.async while
//    the current one is used.
// Later work: wgmma + TMA, and a dq accumulation that avoids recomputing S
// and dP a second time (FlashAttention-2 uses fp32 atomics for that; this
// kernel keeps the result deterministic instead).
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int NTHREADS = 128;
constexpr int BKV = 64;    // keys per dk/dv block (16 per warp)
constexpr int BQS = 32;    // query rows per step of the dk/dv block
constexpr int BQ = 64;     // query rows per dq block (16 per warp)
constexpr int BK = 64;     // keys per step of the dq block
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Pitch {
  static constexpr int LD = D + 8;  // padded row pitch: conflict-free ldmatrix
};

// Copy rows [row0, row0 + ROWS) of a (S, D) slice into shared memory; rows at
// or past S are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, ll stride,
                                          int row0, int S, int tid) {
  constexpr int CPR = D / 8;                    // 16-byte chunks per row
  constexpr int PER_THREAD = ROWS * CPR / NTHREADS;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int row = row0 + r;
    const bf16* src = g + (ll)min(row, S - 1) * stride + col;
    repro::cp_async_16(repro::smem_u32(s + r * Pitch<D>::LD + col), src,
                       row < S ? 16 : 0);
  }
}

__device__ __forceinline__ bool visible(int q, int key, int S, int causal,
                                        int window) {
  return q < S && key < S && (!causal || key <= q) &&
         (window <= 0 || key > q - window);
}

// ---------------------------------------------------------------------------
// Delta = rowsum(dO ∘ O): one warp a row, 4 elements a lane (D = 128).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int S, ll o_sb, ll o_sh, ll o_ss,
                 ll d_sb, ll d_sh, ll d_ss) {
  constexpr int PER_LANE = D / 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (int)blockIdx.x * 64;
  for (int row = row0 + warp; row < min(S, row0 + 64); row += NTHREADS / 32) {
    const bf16* op = o + b * o_sb + h * o_sh + row * o_ss + lane * PER_LANE;
    const bf16* dp = dout + b * d_sb + h * d_sh + row * d_ss +
                     lane * PER_LANE;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      acc = fmaf(__bfloat162float(op[i]), __bfloat162float(dp[i]), acc);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[((ll)b * gridDim.y + h) * S + row] = acc;
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (k tile, kv head, batch).
// ---------------------------------------------------------------------------
template <int D>
struct DkdvSmem {
  static constexpr int LD = Pitch<D>::LD;
  static constexpr int KV = BKV * LD;          // elements of the K (or V) tile
  static constexpr int QS = BQS * LD;          // elements of a Q (or dO) tile
  static constexpr int BYTES =
      (2 * KV + 4 * QS) * (int)sizeof(bf16) + 4 * BQS * (int)sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int group, int S,
    ll q_sb, ll q_sh, ll q_ss, ll k_sb,
    ll k_sh, ll k_ss, ll v_sb, ll v_sh, ll v_ss, ll do_sb, ll do_sh,
    ll do_ss, ll dk_sb, ll dk_sh, ll dk_ss, ll dv_sb, ll dv_sh, ll dv_ss,
    float scale, int causal, int window) {
  using SM = DkdvSmem<D>;
  constexpr int LD = SM::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + SM::KV;
  bf16* sQ = sV + SM::KV;                      // [2][BQS][LD]
  bf16* sO = sQ + 2 * SM::QS;                  // dO, [2][BQS][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * SM::QS);   // [2][BQS] lse·log2e
  float* sD = sL + 2 * BQS;                    // [2][BQS] Delta

  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BKV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const float scale_log2 = scale * LOG2E;

  // the queries that can see a key of this tile
  int q_lo = causal ? k0 : 0;
  int q_hi = window > 0 ? min(S, k0 + BKV - 1 + window) : S;
  q_lo = (q_lo / BQS) * BQS;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQS - 1) / BQS : 0;
  const int n_steps = group * n_qt;

  load_rows<D, BKV>(sK, k + b * k_sb + hk * k_sh, k_ss, k0, S, tid);
  load_rows<D, BKV>(sV, v + b * v_sb + hk * v_sh, v_ss, k0, S, tid);

  // step i: q head hk·group + i / n_qt, q rows q_lo + (i % n_qt)·BQS
  auto load_step = [&](int i, int buf) {
    const int h = hk * group + i / n_qt;
    const int q0 = q_lo + (i % n_qt) * BQS;
    load_rows<D, BQS>(sQ + buf * SM::QS, q + b * q_sb + h * q_sh, q_ss, q0,
                      S, tid);
    load_rows<D, BQS>(sO + buf * SM::QS, dout + b * do_sb + h * do_sh, do_ss,
                      q0, S, tid);
    if (tid < BQS) {
      const int row = q0 + tid;
      const ll at = ((ll)b * Hq + h) * S + row;
      sL[buf * BQS + tid] = row < S ? lse[at] * LOG2E : INFINITY;
      sD[buf * BQS + tid] = row < S ? delta[at] : 0.f;
    }
  };
  if (n_steps > 0) load_step(0, 0);
  repro::cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int key_r0 = k0 + warp * 16 + gq;      // keys key_r0 and key_r0 + 8

  for (int i = 0; i < n_steps; ++i) {
    const int buf = i & 1;
    repro::cp_async_wait_all();
    __syncthreads();   // step i landed; every warp is done with step i - 1
    if (i + 1 < n_steps) load_step(i + 1, buf ^ 1);
    repro::cp_async_commit();

    const bf16* cQ = sQ + buf * SM::QS;
    const bf16* cO = sO + buf * SM::QS;
    const float* cL = sL + buf * BQS;
    const float* cD = sD + buf * BQS;
    const int q0 = q_lo + (i % n_qt) * BQS;

    // S^T = K Q^T: 16 keys (this warp) x 32 queries
    float s[BQS / 8][4];
    float dp[BQS / 8][4];
#pragma unroll
    for (int j = 0; j < BQS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4], vf[4];
      const int arow = warp * 16 + (lane % 16);
      const int acol = kk * 16 + (lane / 16) * 8;
      repro::ldmatrix_x4(af, repro::smem_u32(sK + arow * LD + acol));
      repro::ldmatrix_x4(vf, repro::smem_u32(sV + arow * LD + acol));
#pragma unroll
      for (int np = 0; np < BQS / 16; ++np) {
        uint32_t bq[4], bo[4];
        const int row = np * 16 + mr + 8 * (mi >> 1);
        const int col = kk * 16 + 8 * (mi & 1);
        repro::ldmatrix_x4(bq, repro::smem_u32(cQ + row * LD + col));
        repro::ldmatrix_x4(bo, repro::smem_u32(cO + row * LD + col));
        repro::mma_bf16_16816(s[2 * np], af, bq[0], bq[1]);
        repro::mma_bf16_16816(s[2 * np + 1], af, bq[2], bq[3]);
        // dP^T = V dO^T
        repro::mma_bf16_16816(dp[2 * np], vf, bo[0], bo[1]);
        repro::mma_bf16_16816(dp[2 * np + 1], vf, bo[2], bo[3]);
      }
    }

    // P^T and dS^T, each as the A operand (keys x queries) of a product
    // over the 32 queries: n-tiles 2j and 2j+1 form k-step j
    uint32_t pf[BQS / 16][4], dsf[BQS / 16][4];
#pragma unroll
    for (int nt = 0; nt < BQS / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t4 + (e & 1);
        const int key = key_r0 + (e >> 1) * 8;
        const bool ok = visible(q0 + ql, key, S, causal, window);
        p[e] = ok ? exp2f(s[nt][e] * scale_log2 - cL[ql]) : 0.f;
        ds[e] = p[e] * (dp[nt][e] - cD[ql]);
      }
      pf[nt / 2][(nt & 1) * 2] = repro::pack_bf16(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = repro::pack_bf16(p[2], p[3]);
      dsf[nt / 2][(nt & 1) * 2] = repro::pack_bf16(ds[0], ds[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = repro::pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q: B operands (queries x D) transposed
#pragma unroll
    for (int kk = 0; kk < BQS / 16; ++kk) {
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        uint32_t bo[4], bq[4];
        const int row = kk * 16 + mr + 8 * (mi & 1);
        const int col = dpi * 16 + 8 * (mi >> 1);
        repro::ldmatrix_x4_trans(bo, repro::smem_u32(cO + row * LD + col));
        repro::ldmatrix_x4_trans(bq, repro::smem_u32(cQ + row * LD + col));
        repro::mma_bf16_16816(dv_acc[2 * dpi], pf[kk], bo[0], bo[1]);
        repro::mma_bf16_16816(dv_acc[2 * dpi + 1], pf[kk], bo[2], bo[3]);
        repro::mma_bf16_16816(dk_acc[2 * dpi], dsf[kk], bq[0], bq[1]);
        repro::mma_bf16_16816(dk_acc[2 * dpi + 1], dsf[kk], bq[2], bq[3]);
      }
    }
  }
  repro::cp_async_wait_all();

  bf16* dkg = dk + b * dk_sb + hk * dk_sh;
  bf16* dvg = dv + b * dv_sb + hk * dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_r0 + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkg + key * dk_ss + col) = repro::pack_bf16(
          dk_acc[dt][2 * r] * scale, dk_acc[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvg + key * dv_ss + col) =
          repro::pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, q head, batch).
// ---------------------------------------------------------------------------
template <int D>
struct DqSmem {
  static constexpr int LD = Pitch<D>::LD;
  static constexpr int T = 64 * LD;            // elements of one 64-row tile
  static constexpr int BYTES = 6 * T * (int)sizeof(bf16);  // Q, dO, 2x(K, V)
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int group, int S, ll q_sb, ll q_sh, ll q_ss,
    ll k_sb, ll k_sh, ll k_ss, ll v_sb, ll v_sh, ll v_ss, ll do_sb, ll do_sh,
    ll do_ss, ll dq_sb, ll dq_sh, ll dq_ss, float scale, int causal,
    int window) {
  using SM = DqSmem<D>;
  constexpr int LD = SM::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + SM::T;
  bf16* sK = sO + SM::T;                       // [2][64][LD]
  bf16* sV = sK + 2 * SM::T;                   // [2][64][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const float scale_log2 = scale * LOG2E;

  const bf16* kg = k + b * k_sb + hk * k_sh;
  const bf16* vg = v + b * v_sb + hk * v_sh;
  const int k_end = causal ? min(S, q0 + BQ) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_kt = (k_end - k_begin + BK - 1) / BK;

  load_rows<D, BQ>(sQ, q + b * q_sb + h * q_sh, q_ss, q0, S, tid);
  load_rows<D, BQ>(sO, dout + b * do_sb + h * do_sh, do_ss, q0, S, tid);
  if (n_kt > 0) {
    load_rows<D, BK>(sK, kg, k_ss, k_begin, S, tid);
    load_rows<D, BK>(sV, vg, v_ss, k_begin, S, tid);
  }
  repro::cp_async_commit();

  const int qrow0 = q0 + warp * 16 + gq;       // rows qrow0 and qrow0 + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow0 + 8 * r;
    const ll at = ((ll)b * gridDim.y + h) * S + row;
    lse2[r] = row < S ? lse[at] * LOG2E : INFINITY;
    dl[r] = row < S ? delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int i = 0; i < n_kt; ++i) {
    const int buf = i & 1;
    const int kb0 = k_begin + i * BK;
    repro::cp_async_wait_all();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    if (i + 1 < n_kt) {
      load_rows<D, BK>(sK + (buf ^ 1) * SM::T, kg, k_ss, kb0 + BK, S, tid);
      load_rows<D, BK>(sV + (buf ^ 1) * SM::T, vg, v_ss, kb0 + BK, S, tid);
    }
    repro::cp_async_commit();
    const bf16* cK = sK + buf * SM::T;
    const bf16* cV = sV + buf * SM::T;

    // S = Q K^T and dP = dO V^T: 16 rows (this warp) x 64 keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], of[4];
      const int arow = warp * 16 + (lane % 16);
      const int acol = kk * 16 + (lane / 16) * 8;
      repro::ldmatrix_x4(qf, repro::smem_u32(sQ + arow * LD + acol));
      repro::ldmatrix_x4(of, repro::smem_u32(sO + arow * LD + acol));
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk_[4], bv[4];
        const int row = np * 16 + mr + 8 * (mi >> 1);
        const int col = kk * 16 + 8 * (mi & 1);
        repro::ldmatrix_x4(bk_, repro::smem_u32(cK + row * LD + col));
        repro::ldmatrix_x4(bv, repro::smem_u32(cV + row * LD + col));
        repro::mma_bf16_16816(s[2 * np], qf, bk_[0], bk_[1]);
        repro::mma_bf16_16816(s[2 * np + 1], qf, bk_[2], bk_[3]);
        repro::mma_bf16_16816(dp[2 * np], of, bv[0], bv[1]);
        repro::mma_bf16_16816(dp[2 * np + 1], of, bv[2], bv[3]);
      }
    }

    // dS = P ∘ (dP − Delta) as the A operand of dS K over the 64 keys
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb0 + nt * 8 + 2 * t4 + (e & 1);
        const int r = e >> 1;
        const bool ok = visible(qrow0 + 8 * r, key, S, causal, window);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
        ds[e] = p * (dp[nt][e] - dl[r]);
      }
      dsf[nt / 2][(nt & 1) * 2] = repro::pack_bf16(ds[0], ds[1]);
      dsf[nt / 2][(nt & 1) * 2 + 1] = repro::pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K: B operand (keys x D) transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        uint32_t bfr[4];
        const int row = kk * 16 + mr + 8 * (mi & 1);
        const int col = dpi * 16 + 8 * (mi >> 1);
        repro::ldmatrix_x4_trans(bfr, repro::smem_u32(cK + row * LD + col));
        repro::mma_bf16_16816(acc[2 * dpi], dsf[kk], bfr[0], bfr[1]);
        repro::mma_bf16_16816(acc[2 * dpi + 1], dsf[kk], bfr[2], bfr[3]);
      }
    }
  }
  repro::cp_async_wait_all();

  bf16* dqg = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dqg + row * dq_ss + col) = repro::pack_bf16(
          acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk,
                   void* dv, float* delta, int B, int Hq, int Hkv, int S,
                   const ll* st, float scale, int causal, int window,
                   cudaStream_t stream) {
  const int group = Hq / Hkv;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* O = static_cast<const bf16*>(o);
  const bf16* DO = static_cast<const bf16*>(dout);
  // st: (b, h, s) strides of q, k, v, o, do, dq, dk, dv
  const ll* sq = st;
  const ll* sk = st + 3;
  const ll* sv = st + 6;
  const ll* so = st + 9;
  const ll* sdo = st + 12;
  const ll* sdq = st + 15;
  const ll* sdk = st + 18;
  const ll* sdv = st + 21;

  delta_kernel<D><<<dim3((S + 63) / 64, Hq, B), NTHREADS, 0, stream>>>(
      O, DO, delta, S, so[0], so[1], so[2], sdo[0], sdo[1], sdo[2]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kv_bytes = DkdvSmem<D>::BYTES;
  err = cudaFuncSetAttribute(dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3((S + BKV - 1) / BKV, Hkv, B), NTHREADS, kv_bytes,
                   stream>>>(
      Q, K, V, DO, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Hq, group, S, sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0],
      sv[1], sv[2], sdo[0], sdo[1], sdo[2], sdk[0], sdk[1], sdk[2], sdv[0],
      sdv[1], sdv[2], scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = DqSmem<D>::BYTES;
  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3((S + BQ - 1) / BQ, Hq, B), NTHREADS, q_bytes,
                 stream>>>(
      Q, K, V, DO, lse, delta, static_cast<bf16*>(dq), group, S, sq[0], sq[1],
      sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], sdo[0], sdo[1], sdo[2],
      sdq[0], sdq[1], sdq[2], scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q, o, do, dq: (B, Hq, S, D); k, v, dk, dv: (B, Hkv, S, D); all bf16 with unit
// stride on D and the given (batch, head, seq) strides, 24 in the order q, k,
// v, o, do, dq, dk, dv.  lse: (B, Hq, S) fp32 from the forward; delta: (B, Hq,
// S) fp32 scratch.  Returns 0 or a CUDA error code; -1 for arguments the
// kernels do not take.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int S, int D, ll s0, ll s1, ll s2,
    ll s3, ll s4, ll s5, ll s6, ll s7, ll s8, ll s9, ll s10, ll s11, ll s12,
    ll s13, ll s14, ll s15, ll s16, ll s17, ll s18, ll s19, ll s20, ll s21,
    ll s22, ll s23, float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (D != 128) return -1;  // the one head dim of the ported models
  const ll st[24] = {s0,  s1,  s2,  s3,  s4,  s5,  s6,  s7,
                     s8,  s9,  s10, s11, s12, s13, s14, s15,
                     s16, s17, s18, s19, s20, s21, s22, s23};
  const cudaError_t err = launch<128>(
      q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
      static_cast<float*>(delta), B, Hq, Hkv, S, st, scale, causal, window,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
