// Decode attention (one query token per sequence over a KV cache) for Hopper,
// flash-decode style: split over the cache length, then merge.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas
// (body _dec_kernel), the TPU kernel of the dense model's decode step.
//
// What bounds it on the H100: bytes.  Each step reads every valid K and V row
// of the cache once (B=8, Hkv=4, D=128, lengths ~1.1k: ~17.8 MB a layer,
// 5.3 us at 3.35 TB/s).  The TPU kernel's products are fp32 (q·scale, k, p
// and v in fp32): ~2 FLOP per byte for each query head of a group, so at
// G = 16 the fp32 arithmetic on the CUDA cores (67 TFLOP/s) would take 0.8 of
// the byte time.  Here both products run on the tensor cores instead, with
// the fp32 operand split in two bf16 parts, and the bytes remain the limit.
//
// Design:
//  * B·Hkv (batch, kv head) pairs are too few to fill 132 SMs (32 at B=8,
//    Hkv=4), so the cache length is split in chunks of 128 keys: grid
//    (n_split, Hkv, B·n_tiles).  The TPU kernel walked S sequentially in one
//    program; here a second, small pass merges the per-chunk (acc, m, l);
//  * one block serves a tile of up to 16 query heads of its kv head: the 16
//    rows of an mma.sync m16n8k16 product.  For G <= 16 (every model of the
//    repo: qwen2 7, starcoder2 and nemotron 12, llama3 16, granite 3,
//    zamba2 1) the tile is the whole group, so each K/V byte of a (batch,
//    kv head, chunk) is read from device memory once for the whole group.
//    A group of more than 16 heads is split across blocks (n_tiles =
//    ceil(G / 16)), each of which reads the chunk again;
//  * the chunk's K and V rows are copied to shared memory with cp.async
//    (16-byte copies, keys past the length zero-filled and never read), V
//    in flight while the scores are computed; rows are padded by 16 bytes so
//    ldmatrix reads them without bank conflicts;
//  * scores S = (q·scale)·K^T: q·scale is formed in fp32, as the TPU kernel
//    does, and split in three bf16 parts, hi = bf16(x), mid = bf16(x - hi),
//    lo = bf16(x - hi - mid), which hold all 24 bits of its mantissa (k is
//    bf16, so each product is exact).  The three products of each 16-dim
//    step are summed in a fresh accumulator and added to the score in fp32
//    (round to nearest), so the tensor cores' accumulation error is that of
//    a 16-term partial, not of the whole score: a score keeps fp32's
//    accuracy, and so do the row max m and sum l returned for an LSE merge.
//    Each warp takes 32 keys of the chunk;
//  * the softmax of the chunk is fp32, one warp per head; p is split into
//    bf16 hi + lo the same way for P·V, so p keeps 16 bits (the TPU kernel
//    keeps p in fp32; a bf16 p would cost 2^-9 of each weight).  Each warp
//    takes D/4 columns of the output over all keys of the chunk, so no
//    reduction across warps is needed;
//  * blocks whose chunk starts at or past lengths[b] exit at once (the TPU
//    kernel skipped whole blocks past the length, kernel.py:49);
//  * head dims 64 (zamba2, granite), 128 (qwen2, starcoder2, llama3) and 192
//    (nemotron): D is a template parameter; the tiles stay 16 x 128 and the
//    loops over D change length.  Shared memory: 61,312 bytes at 64,
//    100,224 at 128, 139,136 at 192 (dynamic, set with
//    cudaFuncSetAttribute), so 3, 2 and 1 blocks an SM;
//  * with lengths[b] == 0 the merge has no chunk and writes 0 (the JAX
//    reference gives NaN there); no caller passes 0.
// Later work: a fused merge for long caches; TMA for the chunk copies.
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int CHUNK = 128;     // keys per split block
constexpr int NTHREADS = 128;  // 4 warps
constexpr int GT = 16;         // query heads per block: the mma's 16 rows

// Byte offsets into the block's dynamic shared memory.
template <int D>
struct Smem {
  static constexpr int LD = D + 8;            // K, V, Q row pitch (bf16)
  static constexpr int LDS = CHUNK + 8;       // score and P row pitch
  static constexpr int K = 0;
  static constexpr int V = K + CHUNK * LD * 2;
  static constexpr int Q = V + CHUNK * LD * 2;  // three planes: hi, mid, lo
  static constexpr int PH = Q + 3 * GT * LD * 2;
  static constexpr int PL = PH + GT * LDS * 2;
  static constexpr int S = PL + GT * LDS * 2;  // fp32 scores
  static constexpr int M = S + GT * LDS * 4;
  static constexpr int L = M + GT * 4;
  static constexpr int BYTES = L + GT * 4;
};

// Two floats → bf16 high parts and bf16 remainders, each packed in pairs.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = repro::pack_bf16(a - hf.x, b - hf.y);
}

// Two floats → three bf16 parts each (hi + mid + lo holds a float's 24-bit
// mantissa), packed in pairs.
__device__ __forceinline__ void split3_bf16(float a, float b, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  split_bf16(a - hf.x, b - hf.y, mid, lo);
}

// Rows s_lo .. s_lo + CHUNK of a (S, D) slice → shared memory; rows at or
// past n are zero-filled and not read.
template <int D>
__device__ __forceinline__ void load_chunk(bf16* s, const bf16* g, ll stride,
                                           int s_lo, int n, int tid) {
  constexpr int CPR = D / 8;                  // 16-byte copies per row
#pragma unroll
  for (int i = 0; i < CHUNK * CPR / NTHREADS; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    const bf16* src = g + (ll)(s_lo + min(r, n - 1)) * stride + col;
    repro::cp_async_16(repro::smem_u32(s + r * Smem<D>::LD + col), src,
                       r < n ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) decode_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ part_o, float* __restrict__ part_m,
    float* __restrict__ part_l, int Hkv, int G, int n_tiles, int S,
    int n_split, ll q_sb, ll q_sh, ll k_sb, ll k_ss, ll k_sh, ll v_sb,
    ll v_ss, ll v_sh, float scale) {
  using Off = Smem<D>;
  constexpr int LD = Off::LD;
  constexpr int LDS = Off::LDS;
  constexpr int WC = D / 4;                   // output columns of a warp
  constexpr int NT = WC / 8;                  // its n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw + Off::K);
  bf16* sV = reinterpret_cast<bf16*>(smem_raw + Off::V);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + Off::Q);
  bf16* sPh = reinterpret_cast<bf16*>(smem_raw + Off::PH);
  bf16* sPl = reinterpret_cast<bf16*>(smem_raw + Off::PL);
  float* sS = reinterpret_cast<float*>(smem_raw + Off::S);
  float* sM = reinterpret_cast<float*>(smem_raw + Off::M);
  float* sL = reinterpret_cast<float*>(smem_raw + Off::L);

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / n_tiles;
  const int h0 = (blockIdx.z % n_tiles) * GT;  // first head of the tile
  const int gt = min(GT, G - h0);              // heads of the tile
  const int len = min(max(lengths[b], 0), S);
  const int s_lo = split * CHUNK;
  if (s_lo >= len) return;
  const int n = min(CHUNK, len - s_lo);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  load_chunk<D>(sK, k + b * k_sb + hk * k_sh, k_ss, s_lo, n, tid);
  repro::cp_async_commit();
  load_chunk<D>(sV, v + b * v_sb + hk * v_sh, v_ss, s_lo, n, tid);
  repro::cp_async_commit();

  // q·scale of the tile's heads in fp32, split in bf16 hi + mid + lo; the
  // rows past the tile's heads are zero
  constexpr int CPR = D / 8;
  constexpr int QPLANE = GT * LD;
  for (int c = tid; c < GT * CPR; c += NTHREADS) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < gt) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + b * q_sb + (ll)(hk * G + h0 + r) * q_sh + col);
      repro::unpack8_bf16(raw, f);
    }
    uint32_t part[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split3_bf16(f[2 * e] * scale, f[2 * e + 1] * scale, part[0][e],
                  part[1][e], part[2][e]);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint4*>(sQ + pl * QPLANE + r * LD + col) =
          make_uint4(part[pl][0], part[pl][1], part[pl][2], part[pl][3]);
  }
  repro::cp_async_wait<1>();                  // K landed; V may be in flight
  __syncthreads();

  // scores: warp w takes keys [32w, 32w + 32) for all 16 rows
  const int mi = lane / 8;                    // ldmatrix matrix index
  const int mr = lane % 8;                    // ldmatrix row within it
  const int gq = lane / 4;                    // accumulator row (and + 8)
  const int t4 = lane % 4;
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[3][4];
    const int qoff = (lane % 16) * LD + kk * 16 + (lane / 16) * 8;
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      repro::ldmatrix_x4(qf[pl], repro::smem_u32(sQ + pl * QPLANE + qoff));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bfr[4];
      const int row = warp * 32 + np * 16 + mr + 8 * (mi >> 1);
      const int col = kk * 16 + 8 * (mi & 1);
      repro::ldmatrix_x4(bfr, repro::smem_u32(sK + row * LD + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          repro::mma_bf16_16816(part, qf[pl], bfr[2 * h], bfr[2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * np + h][e] += part[e];
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = warp * 32 + nt * 8 + 2 * t4 + (e & 1);
      sS[(gq + 8 * (e >> 1)) * LDS + key] = key < n ? s[nt][e] : -INFINITY;
    }
  }
  __syncthreads();

  // softmax of the chunk in fp32, one warp per head; p → bf16 hi + lo.  Key
  // 0 is always valid, so the row max is finite.
  for (int r = warp; r < GT; r += NTHREADS / 32) {
    float x[CHUNK / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      x[i] = sS[r * LDS + lane + 32 * i];
      mx = fmaxf(mx, x[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      const float p = r < gt ? expf(x[i] - mx) : 0.f;
      sum += p;
      const bf16 hi = __float2bfloat16(p);
      sPh[r * LDS + lane + 32 * i] = hi;
      sPl[r * LDS + lane + 32 * i] = __float2bfloat16(p - __bfloat162float(hi));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      sM[r] = mx;
      sL[r] = sum;
    }
  }
  repro::cp_async_wait<0>();                  // V landed
  __syncthreads();

  // P·V: warp w takes columns [w·D/4, (w+1)·D/4) over all keys of the chunk
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    uint32_t ph[4], pl[4];
    const int poff = (lane % 16) * LDS + kk * 16 + (lane / 16) * 8;
    repro::ldmatrix_x4(ph, repro::smem_u32(sPh + poff));
    repro::ldmatrix_x4(pl, repro::smem_u32(sPl + poff));
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bfr[4];
      const int row = kk * 16 + mr + 8 * (mi & 1);
      const int col = warp * WC + dp * 16 + 8 * (mi >> 1);
      repro::ldmatrix_x4_trans(bfr, repro::smem_u32(sV + row * LD + col));
      repro::mma_bf16_16816(acc[2 * dp], ph, bfr[0], bfr[1]);
      repro::mma_bf16_16816(acc[2 * dp], pl, bfr[0], bfr[1]);
      repro::mma_bf16_16816(acc[2 * dp + 1], ph, bfr[2], bfr[3]);
      repro::mma_bf16_16816(acc[2 * dp + 1], pl, bfr[2], bfr[3]);
    }
  }

  // the chunk's unnormalised (acc, m, l) of each head of the tile
  const ll slot = ((ll)b * Hkv + hk) * n_split + split;  // (b, hk, split)
  float* po = part_o + (slot * G + h0) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = gq + 8 * half;
    if (r >= gt) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<float2*>(po + r * D + warp * WC + nt * 8 + 2 * t4) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
  if (tid < gt) {
    part_m[slot * G + h0 + tid] = sM[tid];
    part_l[slot * G + h0 + tid] = sL[tid];
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
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (G + GT - 1) / GT;
  const dim3 grid(n_split, Hkv, B * n_tiles);
  decode_split_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, po, pm, pl, Hkv, G, n_tiles, S,
      n_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return cudaGetLastError();
}

}  // namespace

// Keys per split: the caller sizes the (B, Hkv, n_split, G, D) scratch with it.
extern "C" int decode_attention_chunk() { return CHUNK; }

// q: (B, Hq, D) with strides (q_sb, q_sh, 1); k/v: (B, S, Hkv, D) with strides
// (sb, ss, sh, 1); lengths: (B,) int32; out: (B, Hq, D) contiguous bf16;
// m_out/l_out: (B, Hq) fp32 or null; part_*: fp32 scratch of
// B·Hkv·n_split·G·D and B·Hkv·n_split·G floats.  Any G = Hq / Hkv; D 64, 128
// or 192.  Returns 0 or a CUDA error code; -1 for arguments the kernel does
// not take.
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
  if (n_split != (S + CHUNK - 1) / CHUNK) return -1;
  if ((m_out == nullptr) != (l_out == nullptr)) return -1;
  const ll st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* po = static_cast<float*>(part_o);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  cudaError_t err;
  if (D == 128)        // qwen2-7b, starcoder2-15b, llama3-405b
    err = launch_split<128>(q, k, v, lens, po, pm, pl, B, Hkv, G, S, n_split,
                            st, scale, s);
  else if (D == 64)    // zamba2-1.2b's shared block, granite-moe-3b-a800m
    err = launch_split<64>(q, k, v, lens, po, pm, pl, B, Hkv, G, S, n_split,
                           st, scale, s);
  else if (D == 192)   // nemotron-4-340b
    err = launch_split<192>(q, k, v, lens, po, pm, pl, B, Hkv, G, S, n_split,
                            st, scale, s);
  else
    return -1;         // the head dims of the repo's models only
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
