// Flash attention forward (causal / windowed GQA self-attention) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _fa_kernel), the TPU kernel of the dense model's prefill.
//
// What bounds it on the H100: operations.  At the prefill shape (B=8, Hq=28,
// S=1024, D=128, causal) the two products are ~60 GFLOP of bf16 tensor-core
// work against ~134 MB of q/k/v/o traffic: 61 us at 989 TFLOP/s against
// 40 us at 3.35 TB/s.
//
// Design:
//  * one block of 4 warps per (q tile of 64 rows, q head, batch); each warp
//    owns 16 query rows.  Blocks run in parallel with nothing carried between
//    them: the TPU's sequential K grid axis becomes the loop inside the block;
//  * Q·K^T and P·V run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    accumulators); operands come from shared memory through ldmatrix, whose
//    rows are padded by 16 bytes so the 8 rows of each 8x8 matrix fall in
//    distinct banks;
//  * the online softmax (m, l, acc) stays in registers, in fp32, with the
//    scale applied to the fp32 scores (log2 domain, exp2);
//  * K and V tiles of 64 keys are copied with cp.async: the V tile is in
//    flight while Q·K^T runs and the next K tile while P·V runs;
//  * K tiles entirely above the causal diagonal or before the window are
//    never visited; masks are evaluated only on tiles that straddle an edge;
//  * loads past S are zero-filled and never read from memory; rows past S
//    are never stored;
//  * GQA: the kv head of q head h is h / (Hq / Hkv); K/V are not repeated;
//  * q, k, v and o are read through (batch, head, seq) strides, so the
//    (B, S, H, D) activations of the model are used without a transpose;
//  * P is rounded to bf16 for the P·V product (the TPU kernel kept it in
//    fp32); the card tolerance in kernels/common.py states what that costs.
//  * causal q tiles are scheduled heaviest first;
//  * head dims 128 (qwen2-7b, starcoder2-15b, llama3-405b), 64 (zamba2-1.2b's
//    shared attention block, granite-moe-3b-a800m) and 192 (nemotron-4-340b):
//    the tiles stay 64 x 64 and the loops over D change length; the block
//    needs 27, 54 and 77 KB of shared memory.  At 64 and 128 each warp keeps
//    its Q fragments in registers for the whole K loop; at 192 the output
//    accumulators alone are 96 registers a thread, so the Q fragments (48
//    more) are read again from sQ, which stays resident anyway, at each K
//    tile;
//  * for training, the row log-sum-exp of the scaled scores is written to
//    lse (B, Hq, S) fp32 when the caller passes a buffer (the backward in
//    flash_attention_bwd.cu rebuilds P from it); it is m and l, which the
//    block holds at the end anyway.  Serving passes none.
// Later work: wgmma + TMA with a warp-specialised producer, and sharing each
// K/V tile across the q heads of a group.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128;

template <int D>
struct Tile {
  static constexpr int LD = D + 8;            // padded row pitch (elements)
  static constexpr int ELEMS = 64 * LD;
  static constexpr int SMEM_BYTES = 3 * ELEMS * (int)sizeof(bf16);
};

// Copy rows [row0, row0 + 64) of a (S, D) slice into shared memory; rows at
// or past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, ll stride,
                                          int row0, int S, int tid) {
  constexpr int CPR = D / 8;                  // 16-byte chunks per row
  constexpr int PER_THREAD = 64 * CPR / NTHREADS;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const int row = row0 + r;
    const bf16* src = g + (ll)min(row, S - 1) * stride + col;
    repro::cp_async_16(repro::smem_u32(s + r * Tile<D>::LD + col), src,
                       row < S ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int group, int S, ll q_sb, ll q_sh, ll q_ss, ll k_sb,
                     ll k_sh, ll k_ss, ll v_sb, ll v_sh, ll v_ss, ll o_sb,
                     ll o_sh, ll o_ss, float scale_log2, int causal,
                     int window, float* __restrict__ lse) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + Tile<D>::ELEMS;
  bf16* sV = sK + Tile<D>::ELEMS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const bf16* qg = q + b * q_sb + h * q_sh;
  const bf16* kg = k + b * k_sb + hk * k_sh;
  const bf16* vg = v + b * v_sb + hk * v_sh;

  // keys any row of this tile can see
  const int k_end = causal ? min(S, q0 + BQ) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  load_tile<D>(sQ, qg, q_ss, q0, S, tid);
  load_tile<D>(sK, kg, k_ss, k_begin, S, tid);
  repro::cp_async_commit();
  repro::cp_async_wait_all();
  __syncthreads();

  // Q fragments: in registers for the whole K loop where D <= 128, else
  // read from sQ at each use
  constexpr bool Q_IN_REGS = D <= 128;
  uint32_t qf[Q_IN_REGS ? D / 16 : 1][4];
  const bf16* q_frag = sQ + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      repro::ldmatrix_x4(qf[kk], repro::smem_u32(q_frag + kk * 16));
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const int gq = lane / 4;                    // row within the 8-row group
  const int t4 = lane % 4;
  const int qrow0 = q0 + warp * 16 + gq;      // rows qrow0 and qrow0 + 8
  const int mi = lane / 8;                    // ldmatrix matrix index
  const int mr = lane % 8;                    // ldmatrix row within it

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_tile<D>(sV, vg, v_ss, k0, S, tid);   // in flight during Q·K^T
    repro::cp_async_commit();

    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t(&a)[4] = qf[Q_IN_REGS ? kk : 0];
      if constexpr (!Q_IN_REGS)
        repro::ldmatrix_x4(a, repro::smem_u32(q_frag + kk * 16));
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bfr[4];
        const int row = np * 16 + mr + 8 * (mi >> 1);
        const int col = kk * 16 + 8 * (mi & 1);
        repro::ldmatrix_x4(bfr, repro::smem_u32(sK + row * LD + col));
        repro::mma_bf16_16816(s[2 * np], a, bfr[0], bfr[1]);
        repro::mma_bf16_16816(s[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }

    const bool need_mask = (k0 + BK > S) ||
                           (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qr = qrow0 + (e >> 1) * 8;
          const bool ok = key < S && (!causal || key <= qr) &&
                          (window <= 0 || key > qr - window);
          x = ok ? x : -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_r[r];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no visible key yet keeps m = -inf; exp2 of -inf is 0
      m_use[r] = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m_r[r] - m_use[r]);
      m_r[r] = mx;
      l_r[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // P as the A operand of P·V: n-tiles 2kk and 2kk+1 form k-step kk
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_use[0]);
      const float p1 = exp2f(s[nt][1] - m_use[0]);
      const float p2 = exp2f(s[nt][2] - m_use[1]);
      const float p3 = exp2f(s[nt][3] - m_use[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pf[nt / 2][(nt & 1) * 2] = repro::pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = repro::pack_bf16(p2, p3);
    }

    repro::cp_async_wait_all();
    __syncthreads();                          // V landed; sK no longer read
    if (k0 + BK < k_end) {
      load_tile<D>(sK, kg, k_ss, k0 + BK, S, tid);  // in flight during P·V
      repro::cp_async_commit();
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bfr[4];
        const int row = kk * 16 + mr + 8 * (mi & 1);
        const int col = dp * 16 + 8 * (mi >> 1);
        repro::ldmatrix_x4_trans(bfr, repro::smem_u32(sV + row * LD + col));
        repro::mma_bf16_16816(acc[2 * dp], pf[kk], bfr[0], bfr[1]);
        repro::mma_bf16_16816(acc[2 * dp + 1], pf[kk], bfr[2], bfr[3]);
      }
    }
    repro::cp_async_wait_all();
    __syncthreads();                          // next K landed; sV no longer read
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
    const int row = qrow0 + 8 * r;
    if (lse != nullptr && t4 == 0 && row < S)   // natural log: (m + log2 l)·ln 2
      lse[((ll)b * gridDim.y + h) * S + row] =
          (m_r[r] + log2f(l)) * 0.6931471805599453f;
  }
  bf16* og = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(og + row * o_ss + col) = repro::pack_bf16(
          acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int group, int S, const ll* st,
                   float scale_log2, int causal, int window, float* lse,
                   cudaStream_t stream) {
  constexpr int bytes = Tile<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), group, S, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale_log2, causal, window, lse);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, S, D), o: (B, Hq, S, D), all bf16 with unit
// stride on D and the given (batch, head, seq) strides; lse: (B, Hq, S) fp32,
// contiguous, or null.  Returns 0 or a CUDA error code; -1 for arguments the
// kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Hq, int Hkv, int S,
                                   int D, ll q_sb, ll q_sh, ll q_ss, ll k_sb,
                                   ll k_sh, ll k_ss, ll v_sb, ll v_sh, ll v_ss,
                                   ll o_sb, ll o_sh, ll o_ss, float scale,
                                   int causal, int window, void* lse,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  const ll st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                     v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const float scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  if (D == 128)        // qwen2-7b, starcoder2-15b, llama3-405b
    err = launch<128>(q, k, v, o, B, Hq, Hq / Hkv, S, st, scale_log2, causal,
                      window, lse_f, s);
  else if (D == 64)    // zamba2-1.2b's shared block, granite-moe-3b-a800m
    err = launch<64>(q, k, v, o, B, Hq, Hq / Hkv, S, st, scale_log2, causal,
                     window, lse_f, s);
  else if (D == 192)   // nemotron-4-340b
    err = launch<192>(q, k, v, o, B, Hq, Hq / Hkv, S, st, scale_log2, causal,
                      window, lse_f, s);
  else
    return -1;         // the head dims of the repo's models only
  return static_cast<int>(err);
}
