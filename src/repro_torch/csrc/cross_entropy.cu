// Fused LM-head cross-entropy forward for Hopper: per token, the log-sum-exp
// of x·w over the valid vocabulary and the logit of its label, without ever
// writing the (T, V) logits.
//
// Replaces: src/repro/kernels/cross_entropy/kernel.py:ce_forward_pallas (body
// _ce_kernel), and the chunked jnp forward _forward_chunked (ops.py) that
// the JAX package takes when the head is padded (n_valid < V): columns at or
// past n_valid are masked here, so one kernel serves both branches.
//
// What bounds it on the H100: operations.  At the training path's shape
// (T = 8192 tokens, D = 3584, V = 152064) the product is 2·T·D·V = 8.93
// TFLOP: 9.03 ms at 989 TFLOP/s, against 1.09 GB of w (0.33 ms at 3.35 TB/s).
//
// Design:
//  * the TPU grid is (T/256, V/2048) with V sequential, carried in VMEM
//    scratch.  Here T = 8192 gives 64 token tiles of 128, which alone would
//    fill half the 132 SMs, so V is split across blocks too: grid (T/128,
//    V/2048), each block walking its 2048 columns in tiles of 128, keeping a
//    running (max, sum, label logit) per row; a second small kernel merges
//    the per-split partials (the split-and-merge of decode_attention.cu);
//  * the token tile index is the fastest grid axis, so the blocks in flight
//    share a few 2048-column slices of w (15 MB each) in L2 while x streams;
//  * x·w runs on the tensor cores in the block's own body: mma.sync
//    m16n8k16, bf16 in, fp32 accumulators.  Products of bf16 values are
//    exact in fp32, as in the TPU kernel's fp32 dot of the same values; only
//    the order of the fp32 sums differs;
//  * 8 warps as 4 (tokens) x 2 (vocab), each warp a 32 x 64 tile; x and w
//    are staged through shared memory in 32-deep slices by cp.async, three
//    slices in flight; ldmatrix (transposed for w, which is (D, V) row-major)
//    feeds the products; rows are padded by 16 bytes for conflict-free reads;
//  * the online logsumexp runs in the log2 domain (exp2); each thread keeps
//    its own running (m, l) over its columns, merged across the quad and the
//    two vocab warps once at the end of the block;
//  * V = 152064 is 74 full 2048-column splits and a 512-column tail; columns
//    at or past V are zero-filled on load and never read, columns at or past
//    n_valid are masked to -inf; a split wholly past n_valid writes an empty
//    partial at once;
//  * a label lies in exactly one split: the "hit" logit is a max over splits
//    in which every other split contributes -inf.
// Later work: wgmma + TMA with a warp-specialised producer, and 128 x 256
// tiles (each x and w byte is read from L2 once per 128 columns/tokens).
#include "common.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;

constexpr int BT = 128;        // tokens per block
constexpr int BV = 128;        // vocab columns per tile
constexpr int BKD = 32;        // depth of one staged slice
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;
constexpr int SPLIT_V = 2048;  // columns per block (the TPU kernel's BLOCK_V)
constexpr int LDX = BKD + 8;   // padded pitch of the x slice (elements)
constexpr int LDW = BV + 8;    // padded pitch of the w slice
constexpr int X_ELEMS = BT * LDX;
constexpr int W_ELEMS = BKD * LDW;
constexpr int STAGE_ELEMS = X_ELEMS + W_ELEMS;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(bf16);
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// (m, l) merge in the log2 domain; an empty side has m = -inf and l = 0.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * exp2f(m - M)) +
      (m2 == -INFINITY ? 0.f : l2 * exp2f(m2 - M));
  m = M;
}

__global__ void __launch_bounds__(NTHREADS)
    ce_split_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_ll,
                    int T, int D, int V, int n_valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int v_begin = split * SPLIT_V;
  const int v_end = min(V, v_begin + SPLIT_V);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wt = warp & 3, wv = warp >> 2;     // 4 token x 2 vocab warps
  const int gq = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;

  if (v_begin >= n_valid) {                    // nothing valid in this split
    if (tid < BT && t0 + tid < T) {
      const ll at = (ll)split * T + t0 + tid;
      part_m[at] = -INFINITY;
      part_l[at] = 0.f;
      part_ll[at] = -INFINITY;
    }
    return;
  }

  const int n_tiles = (v_end - v_begin + BV - 1) / BV;
  const int nk = D / BKD;
  const int total = n_tiles * nk;

  auto load_stage = [&](int g, int slot) {
    const int tile = g / nk;
    const int d0 = (g % nk) * BKD;
    const int c0 = v_begin + tile * BV;
    bf16* sX = smem + slot * STAGE_ELEMS;
    bf16* sW = sX + X_ELEMS;
#pragma unroll
    for (int j = 0; j < BT * BKD / 8 / NTHREADS; ++j) {   // x: 4 chunks a row
      const int c = tid + j * NTHREADS;
      const int r = c / (BKD / 8);
      const int col = (c % (BKD / 8)) * 8;
      const int row = t0 + r;
      const bf16* src = x + (ll)min(row, T - 1) * D + d0 + col;
      repro::cp_async_16(repro::smem_u32(sX + r * LDX + col), src,
                         row < T ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < BKD * BV / 8 / NTHREADS; ++j) {   // w: 16 chunks a row
      const int c = tid + j * NTHREADS;
      const int r = c / (BV / 8);
      const int col = (c % (BV / 8)) * 8;
      const int gcol = c0 + col;                  // V % 8 == 0: whole chunks
      const bf16* src = w + (ll)(d0 + r) * V + min(gcol, V - 8);
      repro::cp_async_16(repro::smem_u32(sW + r * LDW + col), src,
                         gcol < V ? 16 : 0);
    }
  };

  int lab[4];                                  // row slot rs = 2·mt + half
#pragma unroll
  for (int rs = 0; rs < 4; ++rs) {
    const int row = t0 + wt * 32 + (rs >> 1) * 16 + gq + (rs & 1) * 8;
    lab[rs] = row < T ? labels[row] : -1;
  }
  float m[4], l[4], hit[4];
#pragma unroll
  for (int rs = 0; rs < 4; ++rs) {
    m[rs] = -INFINITY;
    l[rs] = 0.f;
    hit[rs] = -INFINITY;
  }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s, s);
    repro::cp_async_commit();
  }

  for (int g = 0; g < total; ++g) {
    repro::cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice g landed; every warp is done with slice g - 1
    const int nxt = g + STAGES - 1;
    if (nxt < total) load_stage(nxt, nxt % STAGES);
    repro::cp_async_commit();

    const bf16* sX = smem + (g % STAGES) * STAGE_ELEMS;
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
        const int col = wv * 64 + np * 16 + 8 * (mi >> 1);
        repro::ldmatrix_x4_trans(bfr, repro::smem_u32(sW + row * LDW + col));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          repro::mma_bf16_16816(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          repro::mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }

    if (g % nk == nk - 1) {                    // a 128-column tile is done
      const int c_base = v_begin + (g / nk) * BV + wv * 64 + 2 * t4;
#pragma unroll
      for (int rs = 0; rs < 4; ++rs) {
        const int mt = rs >> 1, h2 = (rs & 1) * 2;
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c_base + nt * 8 + e;
            const float logit = acc[mt][nt][h2 + e];
            if (col < n_valid) {
              mx = fmaxf(mx, logit);
              if (col == lab[rs]) hit[rs] = logit;
            }
          }
        if (mx != -INFINITY) {
          const float m_new = fmaxf(m[rs], mx * LOG2E);
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c_base + nt * 8 + e;
              if (col < n_valid)
                sum += exp2f(acc[mt][nt][h2 + e] * LOG2E - m_new);
            }
          l[rs] = (m[rs] == -INFINITY ? 0.f : l[rs] * exp2f(m[rs] - m_new)) +
                  sum;
          m[rs] = m_new;
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
  repro::cp_async_wait_all();
  __syncthreads();                             // the slices are free for reuse

  // merge over the quad (the 4 lanes of a row), then over the 2 vocab warps
#pragma unroll
  for (int rs = 0; rs < 4; ++rs) {
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[rs], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[rs], off);
      const float h2 = __shfl_xor_sync(0xffffffffu, hit[rs], off);
      merge(m[rs], l[rs], m2, l2);
      hit[rs] = fmaxf(hit[rs], h2);
    }
  }
  float* red = reinterpret_cast<float*>(smem_raw);   // [3][2][BT]
  if (t4 == 0) {
#pragma unroll
    for (int rs = 0; rs < 4; ++rs) {
      const int r = wt * 32 + (rs >> 1) * 16 + gq + (rs & 1) * 8;
      red[(0 * 2 + wv) * BT + r] = m[rs];
      red[(1 * 2 + wv) * BT + r] = l[rs];
      red[(2 * 2 + wv) * BT + r] = hit[rs];
    }
  }
  __syncthreads();
  if (tid < BT && t0 + tid < T) {
    float mm = red[0 * BT + tid], lm = red[2 * BT + tid];
    merge(mm, lm, red[1 * BT + tid], red[3 * BT + tid]);
    const ll at = (ll)split * T + t0 + tid;
    part_m[at] = mm;
    part_l[at] = lm;
    part_ll[at] = fmaxf(red[4 * BT + tid], red[5 * BT + tid]);
  }
}

// One thread a token: merge the splits' (m, l, label logit).
__global__ void ce_merge_kernel(const float* __restrict__ part_m,
                                const float* __restrict__ part_l,
                                const float* __restrict__ part_ll,
                                float* __restrict__ lse,
                                float* __restrict__ label_logit, int T,
                                int n_split) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float M = -INFINITY, L = 0.f, H = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    const ll at = (ll)s * T + t;
    merge(M, L, part_m[at], part_l[at]);
    H = fmaxf(H, part_ll[at]);
  }
  // the TPU kernel's m + log(max(l, 1e-30)), from the log2 domain
  lse[t] = M == -INFINITY ? -INFINITY : (M + log2f(fmaxf(L, 1e-30f))) * LN2;
  label_logit[t] = H;
}

}  // namespace

// Vocabulary columns per split: the caller sizes the (n_split, T) scratch.
extern "C" int cross_entropy_split() { return SPLIT_V; }

// x: (T, D) bf16 contiguous; w: (D, V) bf16 contiguous; labels: (T,) int32;
// lse, label_logit: (T,) fp32; part_m, part_l, part_ll: (n_split, T) fp32
// scratch.  Needs D % 32 == 0, V % 8 == 0, 0 < n_valid <= V and n_split ==
// ceil(V / 2048).  Returns 0 or a CUDA error code; -1 for arguments the
// kernel does not take.
extern "C" int cross_entropy_fwd(const void* x, const void* w,
                                 const void* labels, void* lse,
                                 void* label_logit, void* part_m,
                                 void* part_l, void* part_ll, int T, int D,
                                 int V, int n_valid, int n_split,
                                 void* stream) {
  if (T <= 0 || D <= 0 || D % BKD != 0 || V <= 0 || V % 8 != 0) return -1;
  if (n_valid <= 0 || n_valid > V) return -1;
  if (n_split != (V + SPLIT_V - 1) / SPLIT_V) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ce_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pll = static_cast<float*>(part_ll);
  ce_split_kernel<<<dim3((T + BT - 1) / BT, n_split), NTHREADS, SMEM_BYTES,
                    s>>>(static_cast<const bf16*>(x),
                         static_cast<const bf16*>(w),
                         static_cast<const int*>(labels), pm, pl, pll, T, D, V,
                         n_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_merge_kernel<<<(T + 255) / 256, 256, 0, s>>>(
      pm, pl, pll, static_cast<float*>(lse), static_cast<float*>(label_logit),
      T, n_split);
  return static_cast<int>(cudaGetLastError());
}
