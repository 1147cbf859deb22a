// Chunked SSD scan (the Mamba2 state-space-duality recurrence) for Hopper,
// at zamba2's state N = 64 and head dim P = 64.
//
// Replaces: src/repro/kernels/ssd/kernel.py:92 ssd_scan_pallas (body
// _ssd_kernel at :42), the TPU kernel of the hybrid model's prefill.
// csrc/ssd_scan_wide.cu covers xlstm's N 512 / P 513.
//
// Per (batch, head), with chunk length L, inclusive cumulative log-decay l_i
// within a chunk and state S (N x P, fp32) carried across chunks:
//   y_i   = sum_{j<=i} (c_i.b_j) exp(l_i - l_j) g_j x_j + exp(l_i) c_i S
//   S_new = exp(l_L) S + sum_j exp(l_L - l_j) g_j b_j x_j^T
// Any chunk length computes the same function; this kernel takes L = 64
// (the TPU kernel 128): the intra-chunk product M.x costs L per row, and a
// 64-row chunk is one wgmma M tile.
//
// What bounds it on the H100: bytes.  At the prefill shape (B 8, H 64,
// S 1024) the traffic is ~149 MB (x and y 67 MB each, b and c read once
// through their head stride of 0, the gates, the final state): 44 us at
// 3.35 TB/s, against ~26 GFLOP of split products (26 us at 989 TFLOP/s).
// The mma.sync design (one block per head, all of a chunk's c, b and x
// copied in before any product) reached 5.2x that bound: nothing was in
// flight while a block computed.
//
// Design:
//  * a persistent grid of one block per SM walks units of (batch, two
//    heads); each unit is 16 chunks of 64 rows.  A block is one producer
//    warp and two consumer warpgroups, one per head;
//  * the producer keeps a ring of 3 stages in flight (2 when b and c are
//    per head): each holds one chunk's c and b (one tile each when their
//    head stride is 0, zamba2's case, else one per head) and both heads'
//    x, all 64 x 64 bf16 TMA tiles with the 128-byte swizzle, read through
//    4-D maps over the tensors' strides (rows past S are zero-filled).  The
//    producer also loads each head's log_a and gate and scans them in the
//    log2 domain into l, exp(l_i), w_j = exp(l_L - l_j) g_j and exp(l_L);
//  * each consumer warpgroup owns its head's state as the accumulators of
//    one m64n64 wgmma (rows n, 32 registers a thread) from the first chunk
//    to the last, and per chunk
//      - issues c.b^T (ss) and y = c.S_prev (ss; B = the state's bf16 high
//        part and remainder, written by stmatrix at the previous chunk's
//        end).  When the head stride of b and c is 0 each warpgroup
//        computes half of c.b^T's columns (m64n32) and hands its half to
//        the other through shared memory and an mbarrier: c.b^T once per
//        (batch, chunk) for the block's heads, each head then applying its
//        own decay and gate.  The other waits only where it reads the half,
//        so the two warpgroups drift and one's products fill the other's
//        elementwise work;
//      - while those run, writes (w x)^T's bf16 parts (ldmatrix of x,
//        scaled by w_j, split, stmatrix.trans);
//      - issues S = exp(l_L) S + b^T (w x) (ss: A = the b tile read
//        MN-major);
//      - builds M = select(j <= i, c.b^T exp(l_i - l_j) g_j, 0) in
//        registers, split into the A fragments of M.x;
//      - once c.S is in: y = exp(l_i) y, then y += M.x (rs; B = x);
//    y goes to a staging tile and out by a TMA store (rows past S, and an
//    odd H's missing head, are not written);
//  * nothing between the wgmma groups branches (stores, bulk-group waits
//    and the final state's stores are predicated): ptxas serialises wgmma
//    around a divergent path (C7518), and the first version, with a branch
//    around the final state's stores, ran so;
//  * the mask is a select taken before the exp: the decay above the
//    diagonal, which overflows where l falls by more than 88 in a chunk,
//    is never used (the TPU kernel's jnp.where picks 0 over the inf);
//  * the fp32 operands (the state S, w_j x_j and M) are each split into a
//    bf16 high part and a bf16 remainder, and both are multiplied: 16 bits
//    of mantissa (relative error <= 2^-17), where the TPU kernel multiplies
//    in fp32.  c, b and x are bf16, so their products are exact;
//  * every output element is summed in one warpgroup in a fixed order: no
//    atomics, equal bits from call to call.
// What still bounds it (the H100's readings in PERF.md): latency.  Each
// warpgroup's chunk is one dependent chain (the products and their waits,
// M, the state written back for the next c.S, two barriers), ~3.5 us a
// chunk at the prefill shape (0.108 ms over 31 chunks a warpgroup) against
// ~0.5 us of products, and two warpgroups an SM hide little of it;
// registers (168 a thread at 288 threads) leave no room for a third.
// Later work: pipeline the chain across chunks (c.b^T, M and M.x of chunk
// k + 1 do not need the state); the causal half of M.x (a 64-row wgmma
// cannot skip the upper triangle's k-steps).
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
constexpr int NCONS = 2;               // consumer warpgroups: heads a unit
constexpr int NTHREADS = 128 * NCONS + 32;
constexpr int TILE = L * 128;          // one 64 x 64 bf16 tile, 8 KB
constexpr int CBP = 72;                // fp32 pitch of the traded c.b^T
constexpr float LOG2E = 1.4426950408889634f;

template <bool SHARED>
struct Cfg {
  static constexpr int NCB = SHARED ? 1 : NCONS;   // c (and b) tiles a stage
  static constexpr int ST = SHARED ? 3 : 2;        // ring stages
  static constexpr int STAGE_BYTES = (2 * NCB + NCONS) * TILE;
  static constexpr int RING = ST * STAGE_BYTES;
  static constexpr int S_IMG = RING;               // state parts, per head
  static constexpr int WX = S_IMG + NCONS * 2 * TILE;   // (w x)^T's parts
  static constexpr int Y_STG = WX + NCONS * 2 * TILE;
  static constexpr int XCH = Y_STG + NCONS * TILE; // c.b^T halves, 2 bufs
  static constexpr int SMEM =
      XCH + (SHARED ? 2 * L * CBP * 4 : 0) + 1024;
};

struct Params {
  int perm_c, perm_b, perm_x, perm_y;
  int c_head, b_head;                  // 0: the tensor's head stride is 0
  const float* log_a;
  const float* gate;
  ll la_s[3], g_s[3];                  // (batch, head, seq) strides
  float* s_final;
  int H, S, n_units;
};

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

template <bool SHARED>
__global__ void __launch_bounds__(NTHREADS, 1)
    ssd_scan_kernel(const __grid_constant__ CUtensorMap c_map,
                    const __grid_constant__ CUtensorMap b_map,
                    const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap y_map,
                    const Params p) {
  using C = Cfg<SHARED>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int ST = C::ST;
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  // a warpgroup's half of c.b^T is written (shared c and b), per buffer
  __shared__ __align__(8) uint64_t xready[NCONS][2];
  // per stage and head: l (log2 domain), gate, exp(l_i), w_j; exp(l_L)
  __shared__ __align__(16) float gates[ST][NCONS][4][L];
  __shared__ float decay[ST][NCONS];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int HP = (p.H + 1) / 2;                       // head pairs
  const int n_chunks = (p.S + L - 1) / L;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      hp::bar_init(&full[i], 1 + 32);    // the TMA arrival + the gate writers
      hp::bar_init(&empty[i], 128 * NCONS);
    }
    for (int i = 0; i < NCONS; ++i) {
      hp::bar_init(&xready[i][0], 128);
      hp::bar_init(&xready[i][1], 128);
    }
    hp::bar_init_fence();
    hp::tma_prefetch_map(&c_map);
    hp::tma_prefetch_map(&b_map);
    hp::tma_prefetch_map(&x_map);
    hp::tma_prefetch_map(&y_map);
  }
  __syncthreads();

  if (tid >= 128 * NCONS) {
    // ---- producer warp: tiles by TMA, gates by the lanes ------------------
    const int lane = tid & 31;
    int it = 0;
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
      const int b = u / HP, h0 = 2 * (u % HP);
      for (int ci = 0; ci < n_chunks; ++ci, ++it) {
        const int s = it % ST, r0 = ci * L;
        float la[NCONS][2], gv[NCONS][2];
#pragma unroll
        for (int hh = 0; hh < NCONS; ++hh)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int h = h0 + hh, row = r0 + 2 * lane + k;
            const bool in = h < p.H && row < p.S;
            la[hh][k] = in ? p.log_a[b * p.la_s[0] + h * p.la_s[1] +
                                     row * p.la_s[2]]
                           : 0.f;
            gv[hh][k] = in ? p.gate[b * p.g_s[0] + h * p.g_s[1] +
                                    row * p.g_s[2]]
                           : 0.f;
          }
        hp::bar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        if (lane == 0) {
          unsigned char* st = smem + s * C::STAGE_BYTES;
          hp::bar_arrive_tx(&full[s], C::STAGE_BYTES);
#pragma unroll
          for (int i = 0; i < C::NCB; ++i) {
            hp::attn_load_box(true, st + i * TILE, &c_map, &full[s],
                              p.perm_c, 0, (h0 + i) * p.c_head, r0, b);
            hp::attn_load_box(true, st + (C::NCB + i) * TILE, &b_map,
                              &full[s], p.perm_b, 0, (h0 + i) * p.b_head, r0,
                              b);
          }
#pragma unroll
          for (int hh = 0; hh < NCONS; ++hh)
            hp::attn_load_box(true, st + (2 * C::NCB + hh) * TILE, &x_map,
                              &full[s], p.perm_x, 0, h0 + hh, r0, b);
        }
#pragma unroll
        for (int hh = 0; hh < NCONS; ++hh) {
          // l = inclusive cumsum of log_a·log2(e): two rows a lane, then a
          // warp scan
          const float v0 = la[hh][0] * LOG2E, v1 = la[hh][1] * LOG2E;
          float incl = v0 + v1;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
          }
          float excl = __shfl_up_sync(0xffffffffu, incl, 1);
          if (lane == 0) excl = 0.f;
          const float ltot = __shfl_sync(0xffffffffu, incl, 31);
          const float l0 = excl + v0, l1 = l0 + v1;
          float(*gt)[L] = gates[s][hh];
          *reinterpret_cast<float2*>(&gt[0][2 * lane]) = make_float2(l0, l1);
          *reinterpret_cast<float2*>(&gt[1][2 * lane]) =
              make_float2(gv[hh][0], gv[hh][1]);
          *reinterpret_cast<float2*>(&gt[2][2 * lane]) =
              make_float2(repro::exp2_approx(l0), repro::exp2_approx(l1));
          *reinterpret_cast<float2*>(&gt[3][2 * lane]) =
              make_float2(repro::exp2_approx(ltot - l0) * gv[hh][0],
                          repro::exp2_approx(ltot - l1) * gv[hh][1]);
          if (lane == 0) decay[s][hh] = repro::exp2_approx(ltot);
        }
        hp::bar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup w: head 2·pair + w ------------------------------
  const int w = tid >> 7, wt = tid & 127;
  const int w4 = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * w4 + g;        // accumulator rows row0, row0 + 8
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix matrix, row
  const uint32_t s_hi = base + C::S_IMG + w * 2 * TILE;
  const uint32_t s_lo = s_hi + TILE;
  const uint32_t y_stg = base + C::Y_STG + w * TILE;
  const uint32_t wx_hi = base + C::WX + w * 2 * TILE, wx_lo = wx_hi + TILE;
  const int bar_wg = 2 + w;            // named barrier of this warpgroup

  // A 64 x 64 accumulator as bf16 into a 128-byte-swizzled tile (rows of
  // the accumulator, 64 columns), by stmatrix: matrix (k, r) holds rows
  // 16·w4 + 8r .. + 7 and columns 8k .. 8k + 7.  split: the high part into
  // `hi` and the remainder into `lo`, else the value rounded into `hi`.
  auto store_tile = [&](const float (&a)[32], uint32_t hi, uint32_t lo,
                        bool split) {
    const int mm = lane >> 3;
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      uint32_t h4[4], l4[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = k + (m >> 1), r = m & 1;
        if (split)
          split_bf16(a[4 * kk + 2 * r], a[4 * kk + 2 * r + 1], h4[m], l4[m]);
        else
          h4[m] = repro::pack_bf16(a[4 * kk + 2 * r], a[4 * kk + 2 * r + 1]);
      }
      const uint32_t off = hp::swz(16 * w4 + 8 * (mm & 1) + mr, k + (mm >> 1));
      hp::stmatrix_x4(hi + off, h4[0], h4[1], h4[2], h4[3]);
      if (split) hp::stmatrix_x4(lo + off, l4[0], l4[1], l4[2], l4[3]);
    }
  };
  int it = 0;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int b = u / HP, h = 2 * (u % HP) + w;
    const bool valid = h < p.H;        // an odd H leaves one head empty
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
    // the state's bf16 parts, the B operand of the next c.S: rows n, 64
    // columns p
    store_tile(sacc, s_hi, s_lo, true);
    hp::fence_proxy_async();
    hp::named_sync(bar_wg, 128);

    for (int ci = 0; ci < n_chunks; ++ci, ++it) {
      const int s = it % ST, r0 = ci * L;
      const uint32_t st = base + s * C::STAGE_BYTES;
      const uint32_t c_s = st + (SHARED ? 0 : w) * TILE;
      const uint32_t b_s = st + (C::NCB + (SHARED ? 0 : w)) * TILE;
      const uint32_t x_s = st + (2 * C::NCB + w) * TILE;
      const float(*gt)[L] = gates[s][w];
      hp::bar_wait(&full[s], (it / ST) & 1);

      // c.b^T: this warpgroup's half of the columns j when c and b are
      // shared by the heads, else all of them; then y = c.S_prev with the
      // state's high part and remainder
      constexpr int NCB_COLS = SHARED ? 32 : 64;
      float cb[NCB_COLS / 2];
      const uint32_t b_cols = b_s + (SHARED ? w * 32 * 128 : 0);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk)
        hp::Wgmma<NCB_COLS>::template ss<0, 0>(
            cb, hp::desc_kmajor(c_s, kk), hp::desc_kmajor(b_cols, kk), kk > 0);
      hp::wgmma_commit();
      float y[32];
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk)
        hp::Wgmma<64>::ss<0, 1>(y, hp::desc_kmajor(c_s, kk),
                                hp::desc_mnmajor(s_hi, kk, TILE), kk > 0);
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk)
        hp::Wgmma<64>::ss<0, 1>(y, hp::desc_kmajor(c_s, kk),
                                hp::desc_mnmajor(s_lo, kk, TILE), 1);
      hp::wgmma_commit();

      // (w x)^T as bf16 parts, rows p, 64 columns j, the B operand of the
      // state update: 8 x 8 blocks of x by ldmatrix, scaled by w_j, split,
      // stored transposed; while c.b^T and c.S run
#pragma unroll
      for (int G = w4; G < 16; G += 4) {
        const int pg = G >> 1, jg0 = 4 * (G & 1);
        uint32_t f[4], hi[4], lo[4];
        repro::ldmatrix_x4(f, x_s + hp::swz(8 * (jg0 + mi) + mr, pg));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float wv = gt[3][8 * (jg0 + m) + g];
          scale_split(f[m], wv, wv, hi[m], lo[m]);
        }
        const uint32_t off = hp::swz(8 * pg + mr, jg0 + mi);
        hp::stmatrix_x4_trans(wx_hi + off, hi[0], hi[1], hi[2], hi[3]);
        hp::stmatrix_x4_trans(wx_lo + off, lo[0], lo[1], lo[2], lo[3]);
      }
      hp::bulk_wait_read_if(wt == 0);    // the last y store has read y_stg

      // c.b^T done: hand this half over (shared c and b); (w x)^T visible
      hp::wgmma_wait<1>();
      hp::fence_regs(cb);
      const float* xch = reinterpret_cast<const float*>(smem + C::XCH) +
                         (it & 1) * L * CBP;
      if constexpr (SHARED) {
        float* mine = reinterpret_cast<float*>(smem + C::XCH) +
                      (it & 1) * L * CBP;
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(
                &mine[(row0 + 8 * r) * CBP + 32 * w + 8 * k + 2 * t]) =
                make_float2(cb[4 * k + 2 * r], cb[4 * k + 2 * r + 1]);
      }
      hp::fence_proxy_async();
      hp::named_sync(bar_wg, 128);
      // the half is out: the other warpgroup waits for it only where it
      // reads it, so the two drift apart and one's products fill the
      // other's elementwise work.  A warpgroup is never a whole iteration
      // ahead (it waits for the other's half each iteration), so a buffer
      // is rewritten only after the other has read it
      if constexpr (SHARED) hp::bar_arrive(&xready[w][it & 1]);

      // S = exp(l_L) S + b^T (w x): A = the b tile read MN-major
      const float dec = decay[s][w];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] *= dec;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        hp::Wgmma<64>::ss<1, 0>(sacc, hp::desc_mnmajor(b_s, kk, TILE),
                                hp::desc_kmajor(wx_hi, kk), 1);
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        hp::Wgmma<64>::ss<1, 0>(sacc, hp::desc_mnmajor(b_s, kk, TILE),
                                hp::desc_kmajor(wx_lo, kk), 1);
      hp::wgmma_commit();

      // M = select(j <= i, c.b^T exp(l_i - l_j) g_j, 0), split into the A
      // fragments of M.x (k16 step kk: column groups 2kk and 2kk + 1)
      uint32_t mh[L / 16][4], ml[L / 16][4];
      if constexpr (SHARED)
        hp::bar_wait(&xready[1 - w][it & 1], (it >> 1) & 1);
      {
        const float li[2] = {gt[0][row0], gt[0][row0 + 8]};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float2 lj =
              *reinterpret_cast<const float2*>(&gt[0][8 * k + 2 * t]);
          const float2 gj =
              *reinterpret_cast<const float2*>(&gt[1][8 * k + 2 * t]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = row0 + 8 * r, j = 8 * k + 2 * t;
            float2 v;
            if constexpr (SHARED)
              v = *reinterpret_cast<const float2*>(&xch[i * CBP + j]);
            else
              v = make_float2(cb[4 * k + 2 * r], cb[4 * k + 2 * r + 1]);
            const float m0 =
                j <= i ? v.x * repro::exp2_approx(li[r] - lj.x) * gj.x : 0.f;
            const float m1 =
                j + 1 <= i ? v.y * repro::exp2_approx(li[r] - lj.y) * gj.y
                           : 0.f;
            split_bf16(m0, m1, mh[k >> 1][(k & 1) * 2 + r],
                       ml[k >> 1][(k & 1) * 2 + r]);
          }
        }
      }

      // y = exp(l_i) y + M.x, once c.S is in (the update may still run)
      hp::wgmma_wait<1>();
      hp::fence_regs(y);
      {
        const float e0 = gt[2][row0], e1 = gt[2][row0 + 8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          y[4 * k] *= e0;
          y[4 * k + 1] *= e0;
          y[4 * k + 2] *= e1;
          y[4 * k + 3] *= e1;
        }
      }
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        hp::Wgmma<64>::rs<1>(y, mh[kk], hp::desc_mnmajor(x_s, kk, TILE), 1);
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk)
        hp::Wgmma<64>::rs<1>(y, ml[kk], hp::desc_mnmajor(x_s, kk, TILE), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(y);
      hp::fence_regs(sacc);
      hp::fence_regs(mh);
      hp::fence_regs(ml);
      hp::bar_arrive(&empty[s]);         // every read of the stage is done

      // y through a staging tile (free since the trade's barrier) and a TMA
      // store (an odd H's empty head: the store's head is past the tensor
      // and writes nothing); the stores and waits are predicated, not
      // branched: a branch between wgmma groups serialises them
      store_tile(sacc, s_hi, s_lo, true);
      store_tile(y, y_stg, 0, false);
      hp::fence_proxy_async();
      hp::named_sync(bar_wg, 128);
      hp::attn_store_box_if(wt == 0, &y_map, y_stg, p.perm_y, 0, h, r0, b);
      hp::bulk_commit_if(wt == 0);
    }

    {
      float* sf = p.s_final + ((ll)b * p.H + (valid ? h : 0)) * NS * PD;
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          hp::st_global_v2_if(valid, sf + (row0 + 8 * r) * PD + 8 * k + 2 * t,
                              sacc[4 * k + 2 * r], sacc[4 * k + 2 * r + 1]);
    }
  }
  hp::bulk_wait_if(wt == 0);             // y stores done before the block ends
}

template <bool SHARED>
cudaError_t launch(const CUtensorMap& cm, const CUtensorMap& bm,
                   const CUtensorMap& xm, const CUtensorMap& ym,
                   const Params& p, int n_units, cudaStream_t stream) {
  using C = Cfg<SHARED>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = n_units < hp::sm_count() ? n_units : hp::sm_count();
  ssd_scan_kernel<SHARED><<<grid, NTHREADS, C::SMEM, stream>>>(cm, bm, xm, ym,
                                                               p);
  return cudaGetLastError();
}

}  // namespace

// c, b: (B, H, S, N) bf16; x, y: (B, H, S, P) bf16; log_a, gate: (B, H, S)
// fp32; each read through its (batch, head, seq) strides with a unit stride
// on the last dim of c, b, x, y, strides a multiple of 8 elements and 16-byte
// aligned bases (TMA); c and b may have a head stride of 0.  s_final:
// (B, H, N, P) fp32, contiguous.  Returns 0 or a CUDA error code; -1 for
// arguments the kernel does not take.
extern "C" int ssd_scan_fwd(const void* c, const void* b, const void* x,
                            const void* log_a, const void* gate, void* y,
                            void* s_final, int B, int H, int S, int N, int P,
                            ll c_sb, ll c_sh, ll c_ss, ll b_sb, ll b_sh,
                            ll b_ss, ll x_sb, ll x_sh, ll x_ss, ll y_sb,
                            ll y_sh, ll y_ss, ll la_sb, ll la_sh, ll la_ss,
                            ll g_sb, ll g_sh, ll g_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return -1;
  if (N != NS || P != PD) return -1;  // zamba2's state 64, head dim 64
  const bool c_shared = c_sh == 0, b_shared = b_sh == 0;
  CUtensorMap cm, bm, xm, ym;
  Params p{};
  // a head stride of 0: a map over one head (its stride is never used)
  if (!hp::attn_map(&cm, &p.perm_c, c, B, c_shared ? 1 : H, S, NS, c_sb,
                    c_shared ? c_sb : c_sh, c_ss, L) ||
      !hp::attn_map(&bm, &p.perm_b, b, B, b_shared ? 1 : H, S, NS, b_sb,
                    b_shared ? b_sb : b_sh, b_ss, L) ||
      !hp::attn_map(&xm, &p.perm_x, x, B, H, S, PD, x_sb, x_sh, x_ss, L) ||
      !hp::attn_map(&ym, &p.perm_y, y, B, H, S, PD, y_sb, y_sh, y_ss, L))
    return static_cast<int>(cudaErrorInvalidValue);
  p.c_head = c_shared ? 0 : 1;
  p.b_head = b_shared ? 0 : 1;
  p.log_a = static_cast<const float*>(log_a);
  p.gate = static_cast<const float*>(gate);
  p.la_s[0] = la_sb; p.la_s[1] = la_sh; p.la_s[2] = la_ss;
  p.g_s[0] = g_sb; p.g_s[1] = g_sh; p.g_s[2] = g_ss;
  p.s_final = static_cast<float*>(s_final);
  p.H = H;
  p.S = S;
  const ll units = (ll)B * ((H + 1) / 2);
  if (units > (1 << 30)) return -1;
  p.n_units = static_cast<int>(units);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = c_shared && b_shared
                        ? launch<true>(cm, bm, xm, ym, p, p.n_units, st)
                        : launch<false>(cm, bm, xm, ym, p, p.n_units, st);
  return static_cast<int>(err);
}
