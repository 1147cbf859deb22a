// Backward of the SSD scan at zamba2's state N = 64 and head dim P = 64,
// for Hopper, in the chunked form on the tensor cores: the gradients of the
// recurrence
//   S_t = a_t S_{t-1} + g_t b_t x_t^T,  y_t = S_t^T c_t  (a_t = exp(log_a_t))
// for the upstream dy (and an optional ds_final, the gradient of the last
// state).
//
// Replaces: no Pallas counterpart.  The JAX package cannot differentiate
// src/repro/kernels/ssd/kernel.py:92 ssd_scan_pallas (the TPU kernel of the
// hybrid model's prefill, which csrc/ssd_scan.cu ports); it trains through
// jax.vjp of its oracle, src/repro/kernels/ssd/ref.py:ssd_ref, and this is
// the gradient of that function.  Its plain twin, the same decomposition in
// fp32, is kernels/ssd/ref.py:ssd_chunked_bwd_ref.
//
// The math: the forward's chunks (csrc/ssd_scan.cu), L = 64 rows.  In a
// chunk, l is the inclusive cumulative sum of log_a, e_i = exp(l_i),
// u_j = exp(l_L - l_j), w_j = u_j g_j, D_ij = exp(l_i - l_j) g_j for j <= i
// (a select taken before the exp: l can fall by more than 128 a chunk),
// CB = C B^T, M = CB o D, S_in the state entering the chunk and G the
// gradient that reaches its last state from later chunks (ds_final or 0 at
// the last).  Two passes carry them across the chunks,
//   S_in <- exp(l_L) S_in + B^T (w o X),   G <- exp(l_L) G + C^T (e o dY),
// and then every chunk is independent of the others:
//   dX = M^T dY + w o (B G)        dM = tril(dY X^T)
//   dC = e o (dY S_in^T) + (dM o D) B
//   dB = (dM o D)^T C + w o (X G^T)
//   dgate_j = sum_i dM_ij CB_ij exp(l_i - l_j) + u_j q_j,  q_j = b_j.(G x_j)
//   dlog_a_t = sum_{u >= t in the chunk} (c_u.dc_u - g_u dgate_u) + carry,
//   carry = <G, S_out> = exp(l_L) <G, S_in> + sum_j w_j q_j
// (a_t <G_t, S_{t-1}> = <G_t, S_t> - g_t dgate_t, and <G_t, S_t> telescopes
// to the chunk's end: no pass over the rows remains).  dgate is never
// divided by g.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): bytes.  At the
// train shape (B 4, H 64, S 2048: 8,192 (batch, head, chunk)s; b and c
// shared by the heads) the function must read x, dy and write dx in bf16,
// read the gates and write their gradients in fp32, and read c, b and write
// dc, db once: 214 MB, 0.064 ms.  This design also writes each chunk's S_in
// and G to a workspace in fp32 and reads them back (268 MB each way), and
// reads x and dy in both kernels: ~0.88 GB in all, 0.26 ms.  Its products,
// every fp32 operand in three bf16 parts, are 80 m64n64k16 wgmma a (batch,
// head, chunk) in the chunk kernel and 12 a chunk of each pass: 1.1e11
// operations, 0.11 ms.  Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// the state passes ~0.17 ms, ~2.4 TB/s, so bytes bind them; the chunk
// kernel ~0.34 ms, bound by its per-head chain of instructions: ~2,700 a
// thread (the exps, the three-way splits, the reductions) against the
// ~2,700 cycles its 84 wgmma take at peak, two warpgroups an SM.
//
// Design:
//  * two kernels, one launch count (the wrapper's);
//  * ssd_bwd_state_kernel: one block (one warpgroup) a (batch, head,
//    direction), four blocks an SM, the 64 x 64 fp32 state as the
//    accumulators of one m64n64 wgmma, stepping over the chunks (forward
//    for S_in, backward from ds_final for G) with a ring of two TMA stages.
//    Before each step it stores the state to the workspace in fp32 in the
//    accumulators' order, interleaved so that a warp's store is 512
//    contiguous bytes (the first layout, each thread's 128 bytes together,
//    took twice as long).  The step's product B^T (w o X) takes A =
//    (w o B)^T in registers (ldmatrix.trans of the b tile, scaled, split in
//    three) and B = the x tile; the reverse pass the same with c, e and dy;
//  * ssd_bwd_chunk_kernel<SHARED>: one block a (batch, chunk) when b and c
//    are shared by the heads (head dim 1), walking the heads; one a (batch,
//    head, chunk) for per-head b and c.  Two warpgroups take every other
//    head, each with a share of shared memory of its own: its head's x and
//    dy (TMA), G and S_in split into three bf16 part tiles (read from the
//    workspace into registers a head ahead, coalesced as they were
//    written), and its running sums of dc and db (fp32; the two
//    warpgroups' sums are added, wg 0's + wg 1's, at the end).  The gates
//    are scanned in fp64 so that l_i - l_j keeps fp32's relative precision
//    however far l falls (l as an fp32 pair).  A head: X dY^T and X G^T
//    (ss); (dM o D)^T and dgate's first term while X G^T runs; db = w o
//    (X G^T) + (dM o D)^T C (rs, in an accumulator of its own: summed over
//    the 64 heads in the tensor cores' accumulators, db's bf16 rounding
//    flipped for 0.27% of its values against an fp64 truth, the twin's for
//    0.014%); B G (ss) while M^T is built; dX = w o (B G) +
//    M^T dY (rs), out through a staging tile and a TMA store; dY X^T and
//    dY S_in^T (ss) while dM o D is built; dC = e o (dY S_in^T) + (dM o D) B
//    (rs).  dgate, c.dc and <G, S_in> are reduced in fixed orders; dlog_a's
//    reverse sum is a warp scan of the chunk's rows;
//  * every fp32 operand of a product (S_in, G, M, dM o D, w o B, e o C) is
//    split into three bf16 parts and each part multiplied: 24 bits, where
//    two parts (16 bits) leave ~1e-5 of the state (csrc/ssd_scan.cu);
//  * no producer warp: a block of 256 threads gets 255 registers a thread
//    (one of 288 gets 168, and spilled); one thread of a warpgroup issues
//    its loads, predicated, and every warp computes the gates alike;
//  * nothing between wgmma groups branches: loads, stores and waits are
//    predicated (ptxas serialises wgmma around a divergent path, C7518);
//  * every output element is summed in one warpgroup in a fixed order: no
//    atomics, equal bits from call to call.
// Later work: pipeline the chunk kernel's chain across heads (a warpgroup
// waits on its last product (dM o D) B and on the dlog_a scan); the
// workspace's 537 MB, which a kernel that kept each (batch, head)'s states
// on chip across the chunks would not move.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;

constexpr int L = 64;                  // chunk length
constexpr int NS = 64;                 // state size N
constexpr int PD = 64;                 // head dim P
constexpr int TILE = L * 128;          // one 64 x 64 bf16 tile, 8 KB
constexpr int STATE_BYTES = NS * PD * 4;   // a state, fp32: 16 KB
constexpr double LOG2E = 1.4426950408889634;

// state pass: one warpgroup; a ring of (A operand tile, B operand tile)
constexpr int NTHREADS_S = 128;
constexpr int S_ST = 2;
constexpr int S_STAGE = 2 * TILE;
constexpr int S_SMEM = S_ST * S_STAGE + 1024;

// chunk kernel: two warpgroups, each on every other head with a share of
// its own (x and dy; its G and S_in in three bf16 part tiles; its sums of
// dc and db over its heads, fp32 in fragment order); the c and b tiles
constexpr int NTHREADS_C = 256;
constexpr int C_XDY = 0, C_G3 = 2 * TILE, C_S3 = C_G3 + 3 * TILE;
constexpr int C_DC = C_S3 + 3 * TILE, C_DB = C_DC + STATE_BYTES;
constexpr int C_WG = C_DB + STATE_BYTES;       // a warpgroup's share
constexpr int C_CB = 2 * C_WG;                 // the c and b tiles
constexpr int C_SMEM = C_CB + 2 * TILE + 1024;

// a chunk's gates, in the log2 domain: l as an fp32 pair (hi, lo), g,
// e = 2^l, u = 2^(l_L - l), w = u g
struct Gates {
  float lh[L], ll[L], g[L], e[L], u[L], w[L];
};

struct StateParams {
  const float *log_a, *gate, *ds_final;
  ll la_s[3], g_s[3];
  unsigned char *ws_s, *ws_g;          // S_in and G slots, STATE_BYTES each
  int perm_b, perm_c, perm_x, perm_dy;
  int b_head, c_head;                  // 0: the map is over one head
  int H, S, n_chunks;
};

struct ChunkParams {
  const float *log_a, *gate;
  float *dlog_a, *dgate;
  ll la_s[3], g_s[3], dla_s[3], dg_s[3];
  const unsigned char *ws_s, *ws_g;
  int perm_b, perm_c, perm_x, perm_dy, perm_dx, perm_dc;
  int b_head, c_head;
  int H, S, n_chunks;
};

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

__device__ __forceinline__ void st_global_if(bool p, float* dst, float v) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act st.global.f32 [%1], %2;\n}\n" ::"r"((int)p),
      "l"(dst), "f"(v)
      : "memory");
}

// l in the log2 domain, scanned in fp64 by a warp: lane holds rows
// 2·lane and 2·lane + 1 (log_a 0 past S, as the forward masks the ragged
// chunk).  l[0], l[1]: the lane's rows; returns l_L.
__device__ __forceinline__ double scan_l(const float (&la)[2], int lane,
                                         double (&l)[2]) {
  const double v0 = (double)la[0] * LOG2E, v1 = (double)la[1] * LOG2E;
  double incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  l[0] = excl + v0;
  l[1] = excl + v0 + v1;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// A warp's gates of one chunk (gate 0 past S): l kept as an
// fp32 pair, the exps taken of fp64 differences rounded once.  Returns
// 2^(l_L).
__device__ __forceinline__ float chunk_gates(const float (&la)[2],
                                             const float (&gv)[2], int lane,
                                             Gates& gt) {
  double l[2];
  const double ltot = scan_l(la, lane, l);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = 2 * lane + k;
    const float lh = (float)l[k];
    gt.lh[row] = lh;
    gt.ll[row] = (float)(l[k] - (double)lh);
    gt.g[row] = gv[k];
    gt.e[row] = repro::exp2_approx((float)l[k]);
    const float u = repro::exp2_approx((float)(ltot - l[k]));
    gt.u[row] = u;
    gt.w[row] = u * gv[k];
  }
  return repro::exp2_approx((float)ltot);
}

// A warpgroup's 64 x 64 accumulator (rows 16·w4 + g (+ 8), columns 8k + 2t)
// into 128-byte-swizzled tiles by stmatrix: three bf16 parts when `parts`
// is 3, else the value rounded into `hi` (csrc/ssd_scan.cu's store_tile).
template <int PARTS>
__device__ __forceinline__ void store_tile(const float (&a)[32], uint32_t hi,
                                           int w4, int lane) {
  const int mm = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    uint32_t h4[4], m4[4], l4[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int kk = k + (m >> 1), r = m & 1;
      if constexpr (PARTS == 3)
        split3(a[4 * kk + 2 * r], a[4 * kk + 2 * r + 1], h4[m], m4[m], l4[m]);
      else
        h4[m] = repro::pack_bf16(a[4 * kk + 2 * r], a[4 * kk + 2 * r + 1]);
    }
    const uint32_t off = hp::swz(16 * w4 + 8 * (mm & 1) + mr, k + (mm >> 1));
    hp::stmatrix_x4(hi + off, h4[0], h4[1], h4[2], h4[3]);
    if constexpr (PARTS == 3) {
      hp::stmatrix_x4(hi + TILE + off, m4[0], m4[1], m4[2], m4[3]);
      hp::stmatrix_x4(hi + 2 * TILE + off, l4[0], l4[1], l4[2], l4[3]);
    }
  }
}

template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[3][R][4]) {
  hp::fence_regs(f[0]);
  hp::fence_regs(f[1]);
  hp::fence_regs(f[2]);
}

// ---------------------------------------------------------------------------
// the state passes
// ---------------------------------------------------------------------------

// log_a and gate of rows 2·lane and 2·lane + 1 of the chunk at r0, head h;
// 0 past S, and for a head that is not there (`valid` false).
__device__ __forceinline__ void load_gates(const float* log_a,
                                           const float* gate,
                                           const ll (&la_s)[3],
                                           const ll (&g_s)[3], int b, int h,
                                           int r0, int S, bool valid, int lane,
                                           float (&la)[2], float (&gv)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + 2 * lane + e;
    const bool in = valid && row < S;
    la[e] = in ? log_a[b * la_s[0] + h * la_s[1] + row * la_s[2]] : 0.f;
    gv[e] = in ? gate[b * g_s[0] + h * g_s[1] + row * g_s[2]] : 0.f;
  }
}

__global__ void __launch_bounds__(NTHREADS_S, 4)
    ssd_bwd_state_kernel(const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap c_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap dy_map,
                         const StateParams p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S_ST];
  __shared__ __align__(16) float scale[S_ST][L];   // w (forward), e (reverse)
  __shared__ float decay[S_ST];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int wt = threadIdx.x, w4 = wt >> 5, lane = wt & 31, g = lane >> 2,
            t = lane & 3;
  const int row0 = 16 * w4 + g;
  const int mi = lane >> 3, mr = lane & 7;
  const int bh = blockIdx.x >> 1, rev = blockIdx.x & 1;
  const int b = bh / p.H, h = bh % p.H;
  const int nc = p.n_chunks;
  const CUtensorMap* amap = rev ? &c_map : &b_map;
  const CUtensorMap* bmap = rev ? &dy_map : &x_map;
  const int aperm = rev ? p.perm_c : p.perm_b;
  const int bperm = rev ? p.perm_dy : p.perm_x;
  const int ahead = h * (rev ? p.c_head : p.b_head);

  if (wt == 0) {
    for (int i = 0; i < S_ST; ++i) hp::bar_init(&full[i], 1);
    hp::bar_init_fence();
    hp::tma_prefetch_map(amap);
    hp::tma_prefetch_map(bmap);
  }
  __syncthreads();
  // step it's two tiles into its stage, by the first thread (predicated:
  // nothing between wgmma groups branches)
  auto issue = [&](int it) {
    const int k = rev ? nc - 1 - it : it, s = it % S_ST;
    const bool go = wt == 0 && it < nc;
    unsigned char* st = smem + s * S_STAGE;
    hp::bar_arrive_tx_if(go, &full[s], 2 * TILE);
    hp::attn_load_box(go, st, amap, &full[s], aperm, 0, ahead, k * L, b);
    hp::attn_load_box(go, st + TILE, bmap, &full[s], bperm, 0, h, k * L, b);
  };
  issue(0);
  issue(1);
  float la[2], gv[2];
  load_gates(p.log_a, p.gate, p.la_s, p.g_s, b, h, (rev ? nc - 1 : 0) * L,
             p.S, true, lane, la, gv);
  unsigned char* slots = (rev ? p.ws_g : p.ws_s) + (ll)bh * nc * STATE_BYTES;

  float acc[32];
  {
    const float* ds =
        rev && p.ds_final ? p.ds_final + (ll)bh * NS * PD : nullptr;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 v = make_float2(0.f, 0.f);
        if (ds) v = *reinterpret_cast<const float2*>(
                    ds + (row0 + 8 * r) * PD + 8 * k + 2 * t);
        acc[4 * k + 2 * r] = v.x;
        acc[4 * k + 2 * r + 1] = v.y;
      }
  }

  for (int it = 0; it < nc; ++it) {
    const int k = rev ? nc - 1 - it : it, s = it % S_ST;
    // the step's gates, every warp alike (each writes all 64): e_i
    // (reverse) or w_j (forward), and 2^(l_L); then the next step's inputs
    {
      double l[2];
      const double ltot = scan_l(la, lane, l);
      float2 sv;
      if (rev)
        sv = make_float2(repro::exp2_approx((float)l[0]),
                         repro::exp2_approx((float)l[1]));
      else
        sv = make_float2(repro::exp2_approx((float)(ltot - l[0])) * gv[0],
                         repro::exp2_approx((float)(ltot - l[1])) * gv[1]);
      *reinterpret_cast<float2*>(&scale[s][2 * lane]) = sv;
      decay[s] = repro::exp2_approx((float)ltot);
      const int kn = rev ? k - 1 : k + 1;
      load_gates(p.log_a, p.gate, p.la_s, p.g_s, b, h, kn * L, p.S,
                 it + 1 < nc, lane, la, gv);
    }
    hp::named_sync(1, 128);
    // the state entering chunk k (forward) or the gradient reaching its end
    // (reverse) to the workspace, fp32 in fragment order: thread wt's
    // accumulators 4i .. 4i + 3 at (128 i + wt)·16 bytes, so that a warp's
    // store is 512 contiguous bytes (the chunk kernel's thread wt reads them)
    float4* dst = reinterpret_cast<float4*>(slots + (ll)k * STATE_BYTES) + wt;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[128 * i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                                 acc[4 * i + 3]);

    // A = (scale o tile)^T, rows n, k16 step kk over the chunk's rows j:
    // ldmatrix.trans of the tile's 8 x 8 blocks (rows j, 8 columns n)
    const uint32_t a_s = base + s * S_STAGE, b_s = a_s + TILE;
    hp::bar_wait(&full[s], (it / S_ST) & 1);
    uint32_t fa[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t f[4];
      repro::ldmatrix_x4_trans(
          f, a_s + hp::swz(16 * kk + 8 * (mi >> 1) + mr, 2 * w4 + (mi & 1)));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = 16 * kk + 8 * (m >> 1) + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(&scale[s][j]);
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&f[m]));
        split3(v.x * sc.x, v.y * sc.y, fa[0][kk][m], fa[1][kk][m],
               fa[2][kk][m]);
      }
    }
    const float dec = decay[s];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= dec;
    hp::wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<64>::rs<1>(acc, fa[part][kk],
                             hp::desc_mnmajor(b_s, kk, TILE), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    fence_frags(fa);
    // every read of stage s and of its gates is done: step it + 2's tiles
    hp::fence_proxy_async();
    hp::named_sync(1, 128);
    issue(it + 2);
  }
}

// ---------------------------------------------------------------------------
// the chunks
// ---------------------------------------------------------------------------

template <bool SHARED>
__global__ void __launch_bounds__(NTHREADS_C, 1)
    ssd_bwd_chunk_kernel(const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap c_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap dy_map,
                         const __grid_constant__ CUtensorMap dx_map,
                         const __grid_constant__ CUtensorMap dc_map,
                         const __grid_constant__ CUtensorMap db_map,
                         const ChunkParams p) {
  extern __shared__ unsigned char smem_raw[];
  // per warpgroup: its x and dy landed
  __shared__ __align__(8) uint64_t fullx[2], cbfull;
  __shared__ __align__(16) Gates gates[2];
  __shared__ float vbuf[2][L], wqbuf[2][L], red[2][4];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wt = tid & 127, w4 = wt >> 5, lane = tid & 31,
            g = lane >> 2, t = lane & 3;
  const int row0 = 16 * w4 + g;        // accumulator rows row0, row0 + 8
  const int bar_wg = 1 + wg;           // the warpgroup's named barrier
  const int nc = p.n_chunks;
  // SHARED: block (b, chunk) over all heads; else (b, h, chunk), one head
  const int k = blockIdx.x % nc;
  const int bh = blockIdx.x / nc;
  const int b = SHARED ? bh : bh / p.H;
  const int h0 = SHARED ? 0 : bh % p.H;
  const int nh = SHARED ? p.H : 1;
  const int r0 = k * L;
  // this warpgroup's share; the shared c and b tiles
  unsigned char* own = smem + wg * C_WG;
  const uint32_t x_s = base + wg * C_WG + C_XDY, dy_s = x_s + TILE;
  const uint32_t g3 = base + wg * C_WG + C_G3, s3 = base + wg * C_WG + C_S3;
  float4* dcs = reinterpret_cast<float4*>(own + C_DC) + wt;
  float4* dbs = reinterpret_cast<float4*>(own + C_DB) + wt;
  const uint32_t c_s = base + C_CB, b_s = c_s + TILE;
  Gates& gt = gates[wg];

  if (tid == 0) {
    hp::bar_init(&fullx[0], 1);
    hp::bar_init(&fullx[1], 1);
    hp::bar_init(&cbfull, 1);
    hp::bar_init_fence();
    hp::tma_prefetch_map(&b_map);
    hp::tma_prefetch_map(&c_map);
    hp::tma_prefetch_map(&x_map);
    hp::tma_prefetch_map(&dy_map);
  }
  __syncthreads();
  // a head's x and dy into this warpgroup's share, by its first thread
  // (predicated: nothing between wgmma groups branches)
  auto issue_xdy = [&](int hi) {
    const bool go = wt == 0 && hi < nh;
    hp::bar_arrive_tx_if(go, &fullx[wg], 2 * TILE);
    hp::attn_load_box(go, own + C_XDY, &x_map, &fullx[wg], p.perm_x, 0,
                      h0 + hi, r0, b);
    hp::attn_load_box(go, own + C_XDY + TILE, &dy_map, &fullx[wg],
                      p.perm_dy, 0, h0 + hi, r0, b);
  };
  // a head's G and S_in into registers, fp32 in the state pass's fragment
  // order (coalesced: a warp reads 512 contiguous bytes a load); a head
  // that is not there reads the warpgroup's first one again
  float pg[32], ps[32];
  auto load_states = [&](int hi) {
    const int hh = hi < nh ? hi : wg < nh ? wg : 0;
    const ll slot = (((ll)b * p.H + h0 + hh) * nc + k) * STATE_BYTES;
    const float4* gsrc = reinterpret_cast<const float4*>(p.ws_g + slot) + wt;
    const float4* ssrc = reinterpret_cast<const float4*>(p.ws_s + slot) + wt;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = gsrc[128 * i], c = ssrc[128 * i];
      pg[4 * i] = a.x; pg[4 * i + 1] = a.y;
      pg[4 * i + 2] = a.z; pg[4 * i + 3] = a.w;
      ps[4 * i] = c.x; ps[4 * i + 1] = c.y;
      ps[4 * i + 2] = c.z; ps[4 * i + 3] = c.w;
    }
  };
  hp::bar_arrive_tx_if(tid == 0, &cbfull, 2 * TILE);
  hp::attn_load_box(tid == 0, smem + C_CB, &c_map, &cbfull, p.perm_c, 0,
                    h0 * p.c_head, r0, b);
  hp::attn_load_box(tid == 0, smem + C_CB + TILE, &b_map, &cbfull, p.perm_b,
                    0, h0 * p.b_head, r0, b);
  issue_xdy(wg);
  load_states(wg);
  float la[2], gv[2];
  load_gates(p.log_a, p.gate, p.la_s, p.g_s, b, h0 + wg, r0, p.S, wg < nh,
             lane, la, gv);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dcs[128 * i] = dbs[128 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the bf16 pair of row `row`, columns 8k + 2t and + 1 of a swizzled tile:
  // b_n or c_n at a thread's accumulator positions
  auto pair_at = [&](uint32_t tile, int row, int kc) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        smem + (tile - base) + hp::swz(row, kc) + 4 * t));
  };
  // an accumulator added into a sum in shared memory (fragment order)
  auto add_to = [](float4* dst, const float (&a)[32]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4 v = dst[128 * i];
      v.x += a[4 * i];
      v.y += a[4 * i + 1];
      v.z += a[4 * i + 2];
      v.w += a[4 * i + 3];
      dst[128 * i] = v;
    }
  };

  hp::bar_wait(&cbfull, 0);
  float cbt[32];                       // C B^T, rows j, columns i
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::Wgmma<64>::ss<0, 0>(cbt, hp::desc_kmajor(b_s, kk),
                            hp::desc_kmajor(c_s, kk), kk > 0);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_regs(cbt);

  int it = 0;
  for (int hi = wg; hi < nh; hi += 2, ++it) {
    const int h = h0 + hi;
    // the head's gates, every warp alike (each writes all 64 rows); then
    // the inputs of the warpgroup's next head's
    const float dec = chunk_gates(la, gv, lane, gt);
    load_gates(p.log_a, p.gate, p.la_s, p.g_s, b, h + 2, r0, p.S,
               hi + 2 < nh, lane, la, gv);
    // <G, S_in>; G and S_in split into their three part tiles (the last
    // dX store, staged in G's first, has read it)
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dot = fmaf(pg[i], ps[i], dot);
    hp::bulk_wait_read_if(wt == 0);
    hp::named_sync(bar_wg, 128);
    store_tile<3>(pg, g3, w4, lane);
    store_tile<3>(ps, s3, w4, lane);
    hp::fence_proxy_async();
    hp::named_sync(bar_wg, 128);
    float rl[2], rlo[2], rg[2];        // the thread's two rows' gates
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rl[r] = gt.lh[row0 + 8 * r];
      rlo[r] = gt.ll[row0 + 8 * r];
      rg[r] = gt.g[row0 + 8 * r];
    }
    const float w0 = gt.w[row0], w1 = gt.w[row0 + 8];
    hp::bar_wait(&fullx[wg], it & 1);

    // (1) X dY^T (rows j, columns i), X G^T (rows j, columns n)
    float acc_a[32], acc_b[32], acc_c[32], ed[32];
    uint32_t fr[3][4][4];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::Wgmma<64>::ss<0, 0>(acc_b, hp::desc_kmajor(x_s, kk),
                              hp::desc_kmajor(dy_s, kk), kk > 0);
    hp::wgmma_commit();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<64>::ss<0, 0>(acc_a, hp::desc_kmajor(x_s, kk),
                                hp::desc_kmajor(g3 + part * TILE, kk),
                                part > 0 || kk > 0);
    hp::wgmma_commit();
    // exp(l_i - l_j) g_j at (row j, column i) for i >= j, else 0 (a select
    // before the exp: above the diagonal the difference can overflow); kept
    // for M^T
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const float2 li =
          *reinterpret_cast<const float2*>(&gt.lh[8 * kc + 2 * t]);
      const float2 lo =
          *reinterpret_cast<const float2*>(&gt.ll[8 * kc + 2 * t]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 8 * kc + 2 * t, j = row0 + 8 * r;
        const float d0 = (li.x - rl[r]) + (lo.x - rlo[r]);
        const float d1 = (li.y - rl[r]) + (lo.y - rlo[r]);
        ed[4 * kc + 2 * r] = i >= j ? repro::exp2_approx(d0) : 0.f;
        ed[4 * kc + 2 * r + 1] = i + 1 >= j ? repro::exp2_approx(d1) : 0.f;
      }
    }
    hp::wgmma_wait<1>();
    hp::fence_regs(acc_b);
    // (dM o D)^T's A fragments, and dgate's first term
    float dg1[2] = {0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int a0 = 4 * kc + 2 * r, m = (kc & 1) * 2 + r;
        dg1[r] = fmaf(acc_b[a0] * cbt[a0], ed[a0], dg1[r]);
        dg1[r] = fmaf(acc_b[a0 + 1] * cbt[a0 + 1], ed[a0 + 1], dg1[r]);
        split3(acc_b[a0] * ed[a0] * rg[r], acc_b[a0 + 1] * ed[a0 + 1] * rg[r],
               fr[0][kc >> 1][m], fr[1][kc >> 1][m], fr[2][kc >> 1][m]);
      }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc_a);
    // q_j = b_j.(G x_j); this head's db starts as w o (X G^T)
    float q[2] = {0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 bv = pair_at(b_s, row0 + 8 * r, kc);
        q[r] = fmaf(bv.x, acc_a[4 * kc + 2 * r], q[r]);
        q[r] = fmaf(bv.y, acc_a[4 * kc + 2 * r + 1], q[r]);
      }
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      acc_a[4 * kc] *= w0;
      acc_a[4 * kc + 1] *= w0;
      acc_a[4 * kc + 2] *= w1;
      acc_a[4 * kc + 3] *= w1;
    }
    // (2) db += (dM o D)^T C (B = the c tile, rows i); B G (rows j,
    // columns p)
    hp::wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<64>::rs<1>(acc_a, fr[part][kk],
                             hp::desc_mnmajor(c_s, kk, TILE), 1);
    hp::wgmma_commit();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<64>::ss<0, 1>(acc_b, hp::desc_kmajor(b_s, kk),
                                hp::desc_mnmajor(g3 + part * TILE, kk, TILE),
                                part > 0 || kk > 0);
    hp::wgmma_commit();
    // dgate_j = dg1_j + u_j q_j, out (one lane of the quad); w_j q_j kept
    float dgate[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      q[r] += __shfl_xor_sync(0xffffffffu, q[r], 1);
      q[r] += __shfl_xor_sync(0xffffffffu, q[r], 2);
      dg1[r] += __shfl_xor_sync(0xffffffffu, dg1[r], 1);
      dg1[r] += __shfl_xor_sync(0xffffffffu, dg1[r], 2);
      const int row = row0 + 8 * r, pos = r0 + row;
      dgate[r] = dg1[r] + gt.u[row] * q[r];
      wqbuf[wg][row] = (r ? w1 : w0) * q[r];
      const bool ok = t == 0 && pos < p.S;
      st_global_if(ok, p.dgate + b * p.dg_s[0] + h * p.dg_s[1] +
                           (ll)(ok ? pos : 0) * p.dg_s[2],
                   dgate[r]);
    }
    hp::wgmma_wait<1>();               // (dM o D)^T C is in
    hp::fence_regs(acc_a);
    fence_frags(fr);
    add_to(dbs, acc_a);
    // M^T's A fragments: (C B^T)^T exp(l_i - l_j) g_j at (row j, column i)
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int a0 = 4 * kc + 2 * r, m = (kc & 1) * 2 + r;
        split3(cbt[a0] * ed[a0] * rg[r], cbt[a0 + 1] * ed[a0 + 1] * rg[r],
               fr[0][kc >> 1][m], fr[1][kc >> 1][m], fr[2][kc >> 1][m]);
      }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc_b);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      acc_b[4 * kc] *= w0;
      acc_b[4 * kc + 1] *= w0;
      acc_b[4 * kc + 2] *= w1;
      acc_b[4 * kc + 3] *= w1;
    }
    // (3) dY X^T (rows i, columns j); dX = w o (B G) + M^T dY (B = the dy
    // tile, rows i); dY S_in^T (rows i, columns n)
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::Wgmma<64>::ss<0, 0>(acc_a, hp::desc_kmajor(dy_s, kk),
                              hp::desc_kmajor(x_s, kk), kk > 0);
    hp::wgmma_commit();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<64>::rs<1>(acc_b, fr[part][kk],
                             hp::desc_mnmajor(dy_s, kk, TILE), 1);
    hp::wgmma_commit();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<64>::ss<0, 0>(acc_c, hp::desc_kmajor(dy_s, kk),
                                hp::desc_kmajor(s3 + part * TILE, kk),
                                part > 0 || kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<1>();               // dY X^T and dX are in
    hp::fence_regs(acc_a);
    hp::fence_regs(acc_b);
    fence_frags(fr);
    // dX out, bf16, through G's first part tile (G is read) and a TMA
    // store; rows past S are not written
    store_tile<1>(acc_b, g3, w4, lane);
    hp::fence_proxy_async();
    hp::named_sync(bar_wg, 128);
    hp::attn_store_box_if(wt == 0, &dx_map, g3, p.perm_dx, 0, h, r0, b);
    hp::bulk_commit_if(wt == 0);
    // the warpgroup's next head's states, in flight while the rest runs
    load_states(hi + 2);
    // (dM o D)'s A fragments: dY X^T exp(l_i - l_j) g_j at (row i, column
    // j), j <= i
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      const float2 lj =
          *reinterpret_cast<const float2*>(&gt.lh[8 * kc + 2 * t]);
      const float2 lo =
          *reinterpret_cast<const float2*>(&gt.ll[8 * kc + 2 * t]);
      const float2 gj =
          *reinterpret_cast<const float2*>(&gt.g[8 * kc + 2 * t]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r, j = 8 * kc + 2 * t;
        const float d0 = (rl[r] - lj.x) + (rlo[r] - lo.x);
        const float d1 = (rl[r] - lj.y) + (rlo[r] - lo.y);
        const float e0 = j <= i ? repro::exp2_approx(d0) * gj.x : 0.f;
        const float e1 = j + 1 <= i ? repro::exp2_approx(d1) * gj.y : 0.f;
        const int m = (kc & 1) * 2 + r;
        split3(acc_a[4 * kc + 2 * r] * e0, acc_a[4 * kc + 2 * r + 1] * e1,
               fr[0][kc >> 1][m], fr[1][kc >> 1][m], fr[2][kc >> 1][m]);
      }
    }
    // (4) dC = e o (dY S_in^T) + (dM o D) B (B = the b tile, rows j)
    hp::wgmma_wait<0>();
    hp::fence_regs(acc_c);
    {
      const float e0 = gt.e[row0], e1 = gt.e[row0 + 8];
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        acc_c[4 * kc] *= e0;
        acc_c[4 * kc + 1] *= e0;
        acc_c[4 * kc + 2] *= e1;
        acc_c[4 * kc + 3] *= e1;
      }
    }
    hp::wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<64>::rs<1>(acc_c, fr[part][kk],
                             hp::desc_mnmajor(b_s, kk, TILE), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc_c);
    fence_frags(fr);

    // (5) c.dc (this head's); dc summed; dlog_a: the reverse sum over the
    // chunk's rows of c.dc - g dgate, plus the carry exp(l_L) <G, S_in> +
    // sum_j w_j q_j, every warp computing it alike and writing its quarter
    // of the rows
    float rc[2] = {0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < 8; ++kc)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 cv = pair_at(c_s, row0 + 8 * r, kc);
        rc[r] = fmaf(cv.x, acc_c[4 * kc + 2 * r], rc[r]);
        rc[r] = fmaf(cv.y, acc_c[4 * kc + 2 * r + 1], rc[r]);
      }
    add_to(dcs, acc_c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rc[r] += __shfl_xor_sync(0xffffffffu, rc[r], 1);
      rc[r] += __shfl_xor_sync(0xffffffffu, rc[r], 2);
      // the quad's four lanes hold the same value and all store it
      vbuf[wg][row0 + 8 * r] = rc[r] - rg[r] * dgate[r];
    }
    red[wg][w4] = dot;
    hp::named_sync(bar_wg, 128);
    {
      const float va = vbuf[wg][2 * lane], vb = vbuf[wg][2 * lane + 1];
      float incl = va + vb;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      float excl = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) excl = 0.f;
      float wq = wqbuf[wg][2 * lane] + wqbuf[wg][2 * lane + 1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wq += __shfl_xor_sync(0xffffffffu, wq, off);
      const float carry =
          dec * (((red[wg][0] + red[wg][1]) + red[wg][2]) + red[wg][3]) + wq;
      const float sb = excl + vb, sa = sb + va;
      const bool mine = (lane >> 3) == w4;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = r0 + 2 * lane + e;
        const bool ok = mine && pos < p.S;
        st_global_if(ok, p.dlog_a + b * p.dla_s[0] + h * p.dla_s[1] +
                             (ll)(ok ? pos : 0) * p.dla_s[2],
                     (e ? sb : sa) + carry);
      }
    }
    issue_xdy(hi + 2);                 // x and dy are read
  }

  // the two warpgroups' sums, wg 0's + wg 1's, out in bf16 through wg 0's
  // G part tiles 1 and 2 (its last dX store may still read the first)
  hp::named_sync(3, 256);
  if (wg == 0) {
    const float4* dc1 =
        reinterpret_cast<const float4*>(smem + C_WG + C_DC) + wt;
    const float4* db1 =
        reinterpret_cast<const float4*>(smem + C_WG + C_DB) + wt;
    float dcf[32], dbf[32];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 c0 = dcs[128 * i], c1 = dc1[128 * i];
      const float4 d0 = dbs[128 * i], d1 = db1[128 * i];
      dcf[4 * i] = c0.x + c1.x; dcf[4 * i + 1] = c0.y + c1.y;
      dcf[4 * i + 2] = c0.z + c1.z; dcf[4 * i + 3] = c0.w + c1.w;
      dbf[4 * i] = d0.x + d1.x; dbf[4 * i + 1] = d0.y + d1.y;
      dbf[4 * i + 2] = d0.z + d1.z; dbf[4 * i + 3] = d0.w + d1.w;
    }
    store_tile<1>(dcf, g3 + TILE, w4, lane);
    store_tile<1>(dbf, g3 + 2 * TILE, w4, lane);
    hp::fence_proxy_async();
    hp::named_sync(bar_wg, 128);
    const int hc = SHARED ? 0 : h0;
    hp::attn_store_box_if(wt == 0, &dc_map, g3 + TILE, p.perm_dc, 0, hc, r0,
                          b);
    hp::attn_store_box_if(wt == 0, &db_map, g3 + 2 * TILE, p.perm_dc, 0, hc,
                          r0, b);
    hp::bulk_commit_if(wt == 0);
  }
  hp::bulk_wait_if(wt == 0);           // the stores are done before exit
}

template <bool SHARED>
cudaError_t launch_chunks(const CUtensorMap (&maps)[7], const ChunkParams& p,
                          int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel<SHARED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C_SMEM);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<SHARED><<<blocks, NTHREADS_C, C_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the workspace: each (batch, head, chunk)'s S_in and G parts.
extern "C" long long ssd_scan_bwd_workspace(int B, int H, int S) {
  return 2ll * B * H * ((S + L - 1) / L) * STATE_BYTES;
}

// c, b: (B, Hc, S, N) bf16 with Hc = H or 1 (shared by the heads; then dc
// and db are summed over them); x, dy: (B, H, S, P) bf16; log_a, gate:
// (B, H, S) fp32; each read through its (batch, head, seq) strides (TMA:
// unit stride on the last dim, the others multiples of 8 elements, 16-byte
// aligned bases; c and b may have a head stride of 0).  ds_final: (B, H, N,
// P) fp32 contiguous, or null for zero.  dc, db: (B, Hc, S, N) bf16
// contiguous; dx: bf16 through its strides as x; dlog_a, dgate: fp32
// through their strides.  ws: ssd_scan_bwd_workspace(B, H, S) bytes.
// Returns 0 or a CUDA error code; -1 for arguments the kernels do not take.
extern "C" int ssd_scan_bwd(
    const void* c, const void* b, const void* x, const void* dy,
    const void* log_a, const void* gate, const void* ds_final, void* dc,
    void* db, void* dx, void* dlog_a, void* dgate, void* ws, int B, int H,
    int Hc, int S, int N, int P, ll c_sb, ll c_sh, ll c_ss, ll b_sb, ll b_sh,
    ll b_ss, ll x_sb, ll x_sh, ll x_ss, ll dy_sb, ll dy_sh, ll dy_ss,
    ll dx_sb, ll dx_sh, ll dx_ss, ll la_sb, ll la_sh, ll la_ss, ll g_sb,
    ll g_sh, ll g_ss, ll dla_sb, ll dla_sh, ll dla_ss, ll dg_sb, ll dg_sh,
    ll dg_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return -1;
  if (N != NS || P != PD) return -1;  // zamba2's state 64, head dim 64
  if (Hc != 1 && Hc != H) return -1;
  // cuTensorMapEncodeTiled, which encodes the tensor maps, needs a current
  // context: autograd runs the backward on a thread of its own, where this
  // can be the first CUDA call (the encoding then returns
  // CUDA_ERROR_INVALID_CONTEXT).  cudaSetDevice makes the device's primary
  // context current on this thread.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool shared = Hc == 1;
  const int nc = (S + L - 1) / L;
  const ll state_blocks = 2ll * B * H;
  const ll chunk_blocks = (ll)B * (shared ? 1 : H) * nc;
  if (state_blocks > (1ll << 31) - 1 || chunk_blocks > (1ll << 31) - 1)
    return -1;
  // a head dim of 1, or a head stride of 0: a map over one head
  const bool c_one = shared || c_sh == 0, b_one = shared || b_sh == 0;
  CUtensorMap bm, cm, xm, dym, dxm, dcm, dbm;
  int perm_b, perm_c, perm_x, perm_dy, perm_dx, perm_dc;
  const ll o_ss = NS, o_sh = (ll)S * NS, o_sb = (ll)Hc * S * NS;
  if (!hp::attn_map(&cm, &perm_c, c, B, c_one ? 1 : H, S, NS, c_sb,
                    c_one ? c_sb : c_sh, c_ss, L) ||
      !hp::attn_map(&bm, &perm_b, b, B, b_one ? 1 : H, S, NS, b_sb,
                    b_one ? b_sb : b_sh, b_ss, L) ||
      !hp::attn_map(&xm, &perm_x, x, B, H, S, PD, x_sb, x_sh, x_ss, L) ||
      !hp::attn_map(&dym, &perm_dy, dy, B, H, S, PD, dy_sb, dy_sh, dy_ss, L) ||
      !hp::attn_map(&dxm, &perm_dx, dx, B, H, S, PD, dx_sb, dx_sh, dx_ss, L) ||
      !hp::attn_map(&dcm, &perm_dc, dc, B, Hc, S, NS, o_sb, o_sh, o_ss, L) ||
      !hp::attn_map(&dbm, &perm_dc, db, B, Hc, S, NS, o_sb, o_sh, o_ss, L))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* w = static_cast<unsigned char*>(ws);
  unsigned char* ws_g = w + (ll)B * H * nc * STATE_BYTES;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  StateParams sp{};
  sp.log_a = static_cast<const float*>(log_a);
  sp.gate = static_cast<const float*>(gate);
  sp.ds_final = static_cast<const float*>(ds_final);
  sp.la_s[0] = la_sb; sp.la_s[1] = la_sh; sp.la_s[2] = la_ss;
  sp.g_s[0] = g_sb; sp.g_s[1] = g_sh; sp.g_s[2] = g_ss;
  sp.ws_s = w;
  sp.ws_g = ws_g;
  sp.perm_b = perm_b; sp.perm_c = perm_c;
  sp.perm_x = perm_x; sp.perm_dy = perm_dy;
  sp.b_head = b_one ? 0 : 1;
  sp.c_head = c_one ? 0 : 1;
  sp.H = H;
  sp.S = S;
  sp.n_chunks = nc;
  err = cudaFuncSetAttribute(ssd_bwd_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_kernel<<<static_cast<unsigned>(state_blocks), NTHREADS_S,
                         S_SMEM, st>>>(bm, cm, xm, dym, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ChunkParams cp{};
  cp.log_a = sp.log_a;
  cp.gate = sp.gate;
  cp.dlog_a = static_cast<float*>(dlog_a);
  cp.dgate = static_cast<float*>(dgate);
  for (int i = 0; i < 3; ++i) {
    cp.la_s[i] = sp.la_s[i];
    cp.g_s[i] = sp.g_s[i];
  }
  cp.dla_s[0] = dla_sb; cp.dla_s[1] = dla_sh; cp.dla_s[2] = dla_ss;
  cp.dg_s[0] = dg_sb; cp.dg_s[1] = dg_sh; cp.dg_s[2] = dg_ss;
  cp.ws_s = w;
  cp.ws_g = ws_g;
  cp.perm_b = perm_b; cp.perm_c = perm_c;
  cp.perm_x = perm_x; cp.perm_dy = perm_dy;
  cp.perm_dx = perm_dx; cp.perm_dc = perm_dc;
  cp.b_head = sp.b_head;
  cp.c_head = sp.c_head;
  cp.H = H;
  cp.S = S;
  cp.n_chunks = nc;
  const CUtensorMap maps[7] = {bm, cm, xm, dym, dxm, dcm, dbm};
  err = shared ? launch_chunks<true>(maps, cp, (int)chunk_blocks, st)
               : launch_chunks<false>(maps, cp, (int)chunk_blocks, st);
  return static_cast<int>(err);
}
