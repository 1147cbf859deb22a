// Decode attention (one query token per sequence over a KV cache) for Hopper,
// flash-decode style: split over the cache length, then merge.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas
// (body _dec_kernel), the TPU kernel of the dense model's decode step.
//
// What bounds it on the H100: bytes.  Each step reads every valid K and V row
// of the cache once (B=8, Hkv=4, D=128, lengths ~1.1k: ~17.8 MB a layer,
// 5.3 us at 3.35 TB/s) and does ~2 FLOP per byte, far below the ~295 FLOP a
// byte at which the tensor cores would become the limit.  So the design is
// about keeping enough loads in flight, not about the tensor cores.
//
// Design:
//  * B·Hkv (batch, kv head) pairs are too few to fill 132 SMs (32 at B=8,
//    Hkv=4), so the cache length is split in chunks of 128 keys: grid
//    (n_split, Hkv, B).  The TPU kernel walked S sequentially in one program;
//    here a second, small pass merges the per-chunk (acc, m, l);
//  * one block serves all G = Hq/Hkv query heads of its kv head, so each K/V
//    byte is read once for the whole group (G = 7 for qwen2-7b);
//  * K and V rows are read with 16-byte loads, D/8 neighbouring threads on
//    one row; q·k dot products, the softmax and P·V are fp32, with q·scale
//    applied in fp32 as the TPU kernel does (p is never rounded to bf16);
//  * blocks whose chunk starts at or past lengths[b] exit at once, and keys
//    at or past lengths[b] are never read (the TPU kernel skipped whole
//    blocks past the length, kernel.py:49);
//  * head dims 128 (qwen2-7b) and 64 (zamba2-1.2b's shared attention, 32 q
//    heads over 32 kv heads, G = 1): D/8 threads share a key row, so at 64
//    a pass covers 16 rows instead of 8 and the reduction scratch keeps its
//    size;
//  * with lengths[b] == 0 the merge has no chunk and writes 0 (the JAX
//    reference gives NaN there); no caller passes 0.
// Later work: more loads in flight per thread (cp.async ring) and a fused
// merge for long caches.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int CHUNK = 128;     // keys per split block
constexpr int NTHREADS = 128;
constexpr int MAX_G = 8;       // query heads per kv head

template <int D>
__global__ void __launch_bounds__(NTHREADS) decode_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ part_o, float* __restrict__ part_m,
    float* __restrict__ part_l, int Hkv, int G, int S, int n_split, ll q_sb,
    ll q_sh, ll k_sb, ll k_ss, ll k_sh, ll v_sb, ll v_ss, ll v_sh,
    float scale) {
  constexpr int TPR = D / 8;             // threads on one key row
  constexpr int RPP = NTHREADS / TPR;    // key rows per pass
  static_assert(TPR >= MAX_G, "thread g of a key row stores head g's score");
  __shared__ float sS[MAX_G][CHUNK];
  __shared__ float sM[MAX_G], sL[MAX_G];
  __shared__ __align__(16) float sRed[RPP][MAX_G * D];

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int s_lo = split * CHUNK;
  if (s_lo >= len) return;
  const int n = min(CHUNK, len - s_lo);
  const int tid = threadIdx.x;
  const int rr = tid / TPR;
  const int c = tid % TPR;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // this thread's 8 dims of each query head of the group, times scale
  float qv[MAX_G][8];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + b * q_sb + (ll)(hk * G + g) * q_sh + c * 8);
      repro::unpack8_bf16(raw, qv[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[g][e] = 0.f;
    }
  }

  // scores: TPR threads per key row, RPP rows per pass
  const bf16* kb = k + b * k_sb + hk * k_sh + c * 8;
  for (int j0 = 0; j0 < n; j0 += RPP) {  // uniform trip count: full-warp shuffles
    const int j = j0 + rr;
    const bool valid = j < n;
    float kf[8];
    if (valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(kb + (ll)(s_lo + j) * k_ss);
      repro::unpack8_bf16(raw, kf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = 0.f;
    }
    float dot[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) a = fmaf(qv[g][e], kf[e], a);
      dot[g] = a;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
    }
    if (valid) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G && c == g) sS[g][j] = dot[g];
    }
  }
  __syncthreads();

  // softmax of the chunk, one warp per head
  for (int g = warp; g < G; g += NTHREADS / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sS[g][j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sS[g][j] - mx);
      sS[g][j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      sM[g] = mx;
      sL[g] = sum;
    }
  }
  __syncthreads();

  // P·V: each thread sums its rows for its 8 dims of every head
  float acc[MAX_G][8];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  const bf16* vb = v + b * v_sb + hk * v_sh + c * 8;
  for (int j = rr; j < n; j += RPP) {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(vb + (ll)(s_lo + j) * v_ss);
    float vf[8];
    repro::unpack8_bf16(raw, vf);
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float p = sS[g][j];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sRed[rr][g * D + c * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();

  const ll slot = ((ll)b * Hkv + hk) * n_split + split;  // (b, hk, split)
  float* po = part_o + slot * G * D;
  for (int idx = tid; idx < G * D; idx += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < RPP; ++r) s += sRed[r][idx];
    po[idx] = s;
  }
  if (tid < G) {
    part_m[slot * G + tid] = sM[tid];
    part_l[slot * G + tid] = sL[tid];
  }
}

// One block per (q head, batch), one thread per dim: combine the chunks.
__global__ void decode_merge_kernel(const float* __restrict__ part_o,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const int* __restrict__ lengths,
                                    bf16* __restrict__ out,
                                    float* __restrict__ m_out,
                                    float* __restrict__ l_out, int Hq, int Hkv,
                                    int G, int S, int D, int n_split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int hk = h / G;
  const int g = h % G;
  const int len = min(max(lengths[b], 0), S);
  const int nv = (len + CHUNK - 1) / CHUNK;
  const ll base = ((ll)b * Hkv + hk) * n_split;
  float M = -INFINITY;
  for (int i = 0; i < nv; ++i) M = fmaxf(M, part_m[(base + i) * G + g]);
  float L = 0.f, acc = 0.f;
  for (int i = 0; i < nv; ++i) {
    const float w = expf(part_m[(base + i) * G + g] - M);
    L = fmaf(w, part_l[(base + i) * G + g], L);
    acc = fmaf(w, part_o[((base + i) * G + g) * D + d], acc);
  }
  out[((ll)b * Hq + h) * D + d] = __float2bfloat16(L > 0.f ? acc / L : 0.f);
  if (m_out != nullptr && d == 0) {
    m_out[(ll)b * Hq + h] = nv > 0 ? M : -1e30f;  // the TPU kernel's NEG_INF
    l_out[(ll)b * Hq + h] = L;
  }
}

template <int D>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* lengths, float* po, float* pm, float* pl,
                         int B, int Hkv, int G, int S, int n_split,
                         const ll* st, float scale, cudaStream_t stream) {
  const dim3 grid(n_split, Hkv, B);
  decode_split_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, po, pm, pl, Hkv, G, S, n_split,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return cudaGetLastError();
}

}  // namespace

// Keys per split: the caller sizes the (B, Hkv, n_split, G, D) scratch with it.
extern "C" int decode_attention_chunk() { return CHUNK; }

// q: (B, Hq, D) with strides (q_sb, q_sh, 1); k/v: (B, S, Hkv, D) with strides
// (sb, ss, sh, 1); lengths: (B,) int32; out: (B, Hq, D) contiguous bf16;
// m_out/l_out: (B, Hq) fp32 or null; part_*: fp32 scratch of
// B·Hkv·n_split·G·D and B·Hkv·n_split·G floats.  Returns 0 or a CUDA error
// code; -1 for arguments the kernel does not take.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* m_out, void* l_out,
                                    void* part_o, void* part_m, void* part_l,
                                    int B, int Hq, int Hkv, int S, int D,
                                    int n_split, ll q_sb, ll q_sh, ll k_sb,
                                    ll k_ss, ll k_sh, ll v_sb, ll v_ss,
                                    ll v_sh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  const int G = Hq / Hkv;
  if (G > MAX_G || n_split != (S + CHUNK - 1) / CHUNK) return -1;
  if ((m_out == nullptr) != (l_out == nullptr)) return -1;
  const ll st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* po = static_cast<float*>(part_o);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  cudaError_t err;
  if (D == 128)        // qwen2-7b
    err = launch_split<128>(q, k, v, lens, po, pm, pl, B, Hkv, G, S, n_split,
                            st, scale, s);
  else if (D == 64)    // zamba2-1.2b's shared attention block
    err = launch_split<64>(q, k, v, lens, po, pm, pl, B, Hkv, G, S, n_split,
                           st, scale, s);
  else
    return -1;         // the head dims of the ported models only
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<<<dim3(Hq, B), D, 0, s>>>(
      po, pm, pl, lens, static_cast<bf16*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), Hq, Hkv, G, S, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

// Message for a status returned by the entry points above.
extern "C" const char* repro_cuda_error_string(int status) {
  if (status < 0) return "arguments the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
