// Chunked SSD scan for a wide state (xlstm's mLSTM: N = 512, P = 513) on
// Hopper, in two kernels.
//
// Replaces: src/repro/kernels/ssd/kernel.py:92 ssd_scan_pallas (body
// _ssd_kernel at :42) at the shape the xlstm model gives it: c = q, b = k
// with N = d_head = 512, and x = v plus a column of ones (the normalizer),
// P = 513.  csrc/ssd_scan.cu covers zamba2's N = P = 64.
//
// Per (batch, head), with chunk length L, inclusive cumulative log-decay l_i
// within a chunk and state S (N x P, fp32) carried across chunks:
//   y_i   = sum_{j<=i} (c_i.b_j) exp(l_i - l_j) g_j x_j + exp(l_i) c_i S
//   S_new = exp(l_L) S + sum_j exp(l_L - l_j) g_j b_j x_j^T
// with L = 64 here (the TPU kernel 128; any chunk length computes the same
// function).
//
// What bounds it on the H100: at the prefill shape (B 8, H 4, S 1024) the
// traffic is 168 MB (50 us at 3.35 TB/s), and the products with the fp32
// operands split in two bf16 parts are ~90 GFLOP (91 us at 989 TFLOP/s):
// operations, and shared-memory bandwidth, since wgmma reads both
// operands of c.S and of the state update from shared memory.  The mma.sync
// design took 17x the byte bound: 288 blocks in three waves, c.b^T
// recomputed in each of 9 P tiles (19.3 GFLOP where 2.1 do), and nothing
// loading while a block multiplied.
//
// Design:
//  * c.b^T once per (batch, head, chunk): a first pass,
//    ssd_wide_prep_kernel, one block per (chunk, head, batch), computes it
//    (wgmma over K = 512, c and b streamed through a 3-slot TMA ring: 49 KB,
//    so that 4 blocks share an SM and the 512 blocks of the prefill shape
//    run in one wave) and writes a 17 KB record: the masked, decayed
//    M = select(j <= i, c.b^T exp(l_i - l_j) g_j, 0) as bf16 high part and
//    remainder, each laid out as the 128-byte-swizzled tile wgmma reads,
//    and the gates exp(l_i), w_j = exp(l_L - l_j) g_j and exp(l_L), staged
//    in shared memory and stored by one bulk copy (8.9 MB at the prefill
//    shape, which L2 holds for the 8 blocks of a head).  The other way,
//    tried on the H100 and dropped: the 8 blocks of a head as a thread
//    block cluster, their 16 warpgroups writing the records at the scan's
//    start, then a cluster barrier.  Clusters of blocks this size fill
//    fewer SMs at once (three waves, not two), and the records sit on every
//    block's critical path: slower than the separate first pass at every
//    cluster size tried (8, 4, 2);
//  * the scan, ssd_scan_wide_kernel: one block per (P tile, head, batch),
//    8 tiles a head, 256 blocks in two waves of 132.  Tiles 0-6 take 64
//    columns of P; the last takes 72 (columns 448-512, the ones column and
//    seven zero columns), wgmma's N of 72;
//  * the block is two warpgroups; warpgroup w holds rows n of 256w ..
//    256w + 255 of its P tile's state (4 blocks of 64 rows) as wgmma
//    accumulators (4 x 32 or 36 registers a thread) for the whole scan;
//  * per chunk, for each of its 4 row blocks, a warpgroup
//      - writes the block's state as bf16 high and low parts, transposed
//        (stmatrix.trans: rows p, 64 n, K-major for wgmma), to shared memory;
//      - issues y += c[:, block] . S[block] (ss, N = 64 or 72);
//      - issues S[block] = exp(l_L) S[block] + b[:, block]^T (w x) (ss: A =
//        the b slice read MN-major, B = (w x)^T's parts, built once a chunk
//        by both warpgroups from the x tile);
//      - waits, before the next block's image, only for this c.S: the state
//        update runs on under that image's write;
//    c and b reach each warpgroup in 64 x 64 slices through a 3-slot TMA ring
//    of its own, refilled by one of its threads as the slots free; x and the
//    record come by TMA and a bulk copy into 2 chunk stages;
//  * at the chunk's end each warpgroup scales its share of c.S by exp(l_i),
//    adds M.x over its half of j (ss: A = M's parts from the record, B = x),
//    and the two trade halves of the 64 x P tile through shared memory; each
//    stores its columns of y (rows past S and columns past P are not
//    written).  The c.S partial sums are split by n and M.x by j, so both
//    warpgroups run the same code (no wgmma sits in a branch);
//  * the final state leaves through shared memory in whole rows of 513
//    floats (from the accumulators each warp's store wrote 16 bytes in
//    each of 8 rows);
//  * the fp32 operands (S, w_j x_j and M) are split into a bf16 high part
//    and a bf16 remainder on the tensor cores: 16 bits of mantissa
//    (relative error <= 2^-17), where the TPU kernel multiplies in fp32;
//  * rows at or past S are zero-filled by TMA and have log_a = gate = 0, so
//    they add nothing (the JAX wrapper's zero padding); columns past P are
//    zero-filled and never stored;
//  * c, b, x and y are read and written through (batch, head, seq) strides:
//    q and k are (B, H, S, 512) views of (B, S, H, 512) tensors, x and y
//    (B, H, S, 513) views of (B, S, H, 520) buffers; c and b may have a
//    head stride of 0 (one head's c and b read by every head);
//  * every output element is summed in a fixed order: no atomics, equal
//    bits from call to call.
// What still bounds it (the H100's readings in PERF.md): latency.  Each
// warpgroup's blocks are a chain (image, barrier, products), ~1.8 us a
// block at the prefill shape (the scan's 0.234 ms over 2 waves x 16 chunks
// x 4 blocks) against ~0.6 us of products for both warpgroups; registers
// (248 of 255) and shared memory (217 of 227 KB) leave no room for a second
// image in flight.
// Later work: overlap a chunk's end (the trade, M.x, the (w x) build) with
// the next chunk's products; c as wgmma's register operand (the ss
// products re-read it for both parts of the state).
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;

constexpr int L = 64;                  // chunk length
constexpr int NS = 512;                // state size N
constexpr int PD = 513;                // head dim P
constexpr int NTILES = 8;              // P tiles a head
constexpr int RS = 3;                  // slice ring slots a warpgroup
constexpr int BOX = L * 128;           // a 64 x 64 bf16 tile, 8 KB
constexpr int PREP_SLOTS = 3;          // the first pass's ring
constexpr float LOG2E = 1.4426950408889634f;

// The first pass's record of one (batch, head, chunk): M's high part and
// remainder as 64 x 64 swizzled tiles, then exp(l_i), w_j and exp(l_L).
constexpr int REC_M_LO = BOX;
constexpr int REC_E = 2 * BOX;
constexpr int REC_W = REC_E + 4 * L;
constexpr int REC_DECAY = REC_W + 4 * L;
constexpr int REC = 2 * BOX + 1024;

template <int PW>
struct WCfg {
  static constexpr int NBX = (PW + 63) / 64;       // x boxes of a tile
  static constexpr int SLOT = 2 * BOX;             // a c slice, a b slice
  static constexpr int IMG_BYTES = 2 * PW * 128;   // the transposed parts
  static constexpr int IMG = 2 * RS * SLOT;        // per warpgroup
  static constexpr int CST = IMG + 2 * IMG_BYTES;  // 2 chunk stages
  static constexpr int CST_BYTES = NBX * BOX + REC;
  static constexpr int WX = CST + 2 * CST_BYTES;   // (w x)^T's parts
  static constexpr int SMEM = WX + IMG_BYTES + 1024;
};

struct Params {
  int perm_c, perm_b, perm_x;
  int c_head, b_head;                  // 0: the tensor's head stride is 0
  const float* log_a;
  const float* gate;
  ll la_s[3], g_s[3];                  // (batch, head, seq) strides
  unsigned char* ws;                   // records (B, H, chunks)
  bf16* y;
  ll y_s[3];
  float* s_final;
  int H, S;
};

__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = repro::pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ void scale_split(uint32_t v, float w_lo, float w_hi,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * w_lo, f.y * w_hi, hi, lo);
}

// ---------------------------------------------------------------------------
// first pass: M and the gates of one chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(128)
    ssd_wide_prep_kernel(const __grid_constant__ CUtensorMap c_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[PREP_SLOTS];
  __shared__ __align__(16) float lsh[L], gsh[L];
  __shared__ __align__(16) float esh[3][L];   // exp(l_i), w_j, exp(l_L)
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r0 = ci * L;
  const int tid = threadIdx.x, w4 = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, row0 = 16 * w4 + g;
  const int n_chunks = gridDim.x;
  unsigned char* rec =
      p.ws + (((ll)b * p.H + h) * n_chunks + ci) * (ll)REC;

  if (tid == 0) {
    for (int i = 0; i < PREP_SLOTS; ++i) hp::bar_init(&full[i], 1);
    hp::bar_init_fence();
  }
  __syncthreads();
  // slice q of K (columns 64q .. of c and b) into slot q % 4
  auto load = [&](bool pred, int q) {
    const int s = q % PREP_SLOTS;
    hp::bar_arrive_tx_if(pred, &full[s], 2 * BOX);
    hp::attn_load_box(pred, smem + s * 2 * BOX, &c_map, &full[s], p.perm_c,
                      64 * q, h * p.c_head, r0, b);
    hp::attn_load_box(pred, smem + s * 2 * BOX + BOX, &b_map, &full[s],
                      p.perm_b, 64 * q, h * p.b_head, r0, b);
  };
#pragma unroll
  for (int q = 0; q < PREP_SLOTS; ++q) load(tid == 0, q);

  if (w4 == 0) {       // gates: l in the log2 domain, two rows a lane
    float la[2], gv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = r0 + 2 * lane + k;
      const bool in = row < p.S;
      la[k] = in ? p.log_a[b * p.la_s[0] + h * p.la_s[1] + row * p.la_s[2]]
                 : 0.f;
      gv[k] = in ? p.gate[b * p.g_s[0] + h * p.g_s[1] + row * p.g_s[2]]
                 : 0.f;
    }
    const float v0 = la[0] * LOG2E, v1 = la[1] * LOG2E;
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
    *reinterpret_cast<float2*>(&lsh[2 * lane]) = make_float2(l0, l1);
    *reinterpret_cast<float2*>(&gsh[2 * lane]) = make_float2(gv[0], gv[1]);
    *reinterpret_cast<float2*>(&esh[0][2 * lane]) =
        make_float2(repro::exp2_approx(l0), repro::exp2_approx(l1));
    *reinterpret_cast<float2*>(&esh[1][2 * lane]) =
        make_float2(repro::exp2_approx(ltot - l0) * gv[0],
                    repro::exp2_approx(ltot - l1) * gv[1]);
    if (lane == 0) esh[2][0] = repro::exp2_approx(ltot);
  }
  __syncthreads();

  // c.b^T over K = 512: slice q's products, then the slot of slice q - 1
  // refilled with slice q + 2 once its products are done
  float cb[32];
#pragma unroll
  for (int q = 0; q < NS / 64; ++q) {
    const int s = q % PREP_SLOTS;
    const uint32_t c_s = base + s * 2 * BOX, b_s = c_s + BOX;
    hp::bar_wait(&full[s], (q / PREP_SLOTS) & 1);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::Wgmma<64>::ss<0, 0>(cb, hp::desc_kmajor(c_s, kk),
                              hp::desc_kmajor(b_s, kk), q > 0 || kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<1>();
    if (q >= 1 && q + PREP_SLOTS - 1 < NS / 64)
      load(tid == 0, q + PREP_SLOTS - 1);
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(cb);

  // M = select(j <= i, c.b^T 2^(l_i - l_j) g_j, 0): the exp above the
  // diagonal is never used.  Rows i, 64 columns j, 128-byte swizzle, staged
  // in shared memory (the ring is free) with the gates, then the record
  // goes out in one bulk copy.
  unsigned char* stg = smem;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r, j = 8 * k + 2 * t;
      const float li = lsh[i];
      const float m0 =
          j <= i ? cb[4 * k + 2 * r] * repro::exp2_approx(li - lsh[j]) * gsh[j]
                 : 0.f;
      const float m1 = j + 1 <= i ? cb[4 * k + 2 * r + 1] *
                                        repro::exp2_approx(li - lsh[j + 1]) *
                                        gsh[j + 1]
                                  : 0.f;
      uint32_t hi, lo;
      split_bf16(m0, m1, hi, lo);
      const uint32_t off = hp::swz(i, k) + 4 * t;
      *reinterpret_cast<uint32_t*>(stg + off) = hi;
      *reinterpret_cast<uint32_t*>(stg + REC_M_LO + off) = lo;
    }
  if (tid < 2 * L) {                   // e and w
    const int q = tid >> 6, i = tid & 63;
    *reinterpret_cast<float*>(stg + (q ? REC_W : REC_E) + 4 * i) =
        q ? esh[1][i] : esh[0][i];
  }
  if (tid == 0) *reinterpret_cast<float*>(stg + REC_DECAY) = esh[2][0];
  hp::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    hp::bulk_store(rec, base, REC);
    hp::bulk_commit();
    hp::bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// the scan over one P tile of one head
// ---------------------------------------------------------------------------

template <int PW>
__device__ __forceinline__ void scan_tile(const CUtensorMap* c_map,
                                          const CUtensorMap* b_map,
                                          const CUtensorMap* x_map,
                                          const Params& p,
                                          unsigned char* smem, uint32_t base,
                                          uint64_t* sfull, uint64_t* sempty,
                                          uint64_t* cfull, uint64_t* cempty) {
  using C = WCfg<PW>;
  constexpr int NPG = PW / 8;          // 8-column groups of the tile
  constexpr int NR = PW / 2;           // accumulator registers of a block
  const int p0 = 64 * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 7, wt = tid & 127;
  const int w4 = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * w4 + g;        // accumulator rows row0, row0 + 8
  const int n_chunks = (p.S + L - 1) / L;
  const int n_slices = 4 * n_chunks;   // of this warpgroup
  uint64_t* my_full = sfull + w * RS;
  uint64_t* my_empty = sempty + w * RS;
  const uint32_t ring = base + w * RS * C::SLOT;
  const uint32_t img_hi = base + C::IMG + w * C::IMG_BYTES;
  const uint32_t img_lo = img_hi + PW * 128;
  const uint32_t wx_hi = base + C::WX, wx_lo = wx_hi + PW * 128;
  const unsigned char* recs =
      p.ws + ((ll)b * p.H + h) * (ll)n_chunks * REC;

  // slice sidx of this warpgroup (chunk sidx / 4, row block 4w + sidx % 4)
  // into its slot, once every thread of the warpgroup has freed the slot
  auto load_slice = [&](bool pred, int sidx) {
    const int s = sidx % RS, blk = 4 * w + (sidx & 3), r0 = (sidx >> 2) * L;
    hp::bar_wait_if(pred && sidx >= RS, &my_empty[s],
                    ((sidx / RS) & 1) ^ 1);
    hp::bar_arrive_tx_if(pred, &my_full[s], C::SLOT);
    unsigned char* dst = smem + (ring - base) + s * C::SLOT;
    hp::attn_load_box(pred, dst, c_map, &my_full[s], p.perm_c, 64 * blk,
                      h * p.c_head, r0, b);
    hp::attn_load_box(pred, dst + BOX, b_map, &my_full[s], p.perm_b,
                      64 * blk, h * p.b_head, r0, b);
  };
  // chunk ci's x tile and record into chunk stage ci % 2 (thread 0)
  auto load_chunk = [&](int ci) {
    const int s = ci & 1;
    unsigned char* dst = smem + C::CST + s * C::CST_BYTES;
    hp::bar_arrive_tx(&cfull[s], C::NBX * BOX + REC);
#pragma unroll
    for (int i = 0; i < C::NBX; ++i)
      hp::attn_load_box(true, dst + i * BOX, x_map, &cfull[s], p.perm_x,
                        p0 + 64 * i, h, ci * L, b);
    hp::bulk_load_if(true, dst + C::NBX * BOX, recs + (ll)ci * REC, REC,
                     &cfull[s]);
  };
  // (w x)^T of chunk ci as bf16 parts, rows p, 64 columns j: 8 x 8 blocks
  // of x by ldmatrix, scaled by w_j, split, stored transposed; the blocks
  // shared by the block's 8 warps
  auto build_wx = [&](int ci) {
    const int s = ci & 1;
    const uint32_t xs = base + C::CST + s * C::CST_BYTES;
    const float* wj = reinterpret_cast<const float*>(
        smem + C::CST + s * C::CST_BYTES + C::NBX * BOX + REC_W);
    for (int G = tid >> 5; G < 2 * NPG; G += 8) {
      const int pg = G >> 1, jg0 = 4 * (G & 1);
      uint32_t f[4], hi[4], lo[4];
      repro::ldmatrix_x4(f, xs + (pg >> 3) * BOX +
                                hp::swz(8 * (jg0 + (lane >> 3)) + (lane & 7),
                                        pg & 7));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float wv = wj[8 * (jg0 + m) + (lane >> 2)];
        scale_split(f[m], wv, wv, hi[m], lo[m]);
      }
      const uint32_t off = hp::swz(8 * pg + (lane & 7), jg0 + (lane >> 3));
      hp::stmatrix_x4_trans(wx_hi + off, hi[0], hi[1], hi[2], hi[3]);
      hp::stmatrix_x4_trans(wx_lo + off, lo[0], lo[1], lo[2], lo[3]);
    }
  };
  // block sidx's products are done: free its slot, refill it
  auto advance = [&](int sidx) {
    hp::bar_arrive(&my_empty[sidx % RS]);
    const int nxt = sidx + RS;
    load_slice(wt == 0 && nxt < n_slices, nxt);
  };

  if (tid == 0) {
    load_chunk(0);
    if (n_chunks > 1) load_chunk(1);
  }
#pragma unroll
  for (int i = 0; i < RS; ++i) load_slice(wt == 0 && i < n_slices, i);
  hp::bar_wait(&cfull[0], 0);
  build_wx(0);
  hp::fence_proxy_async();
  hp::named_sync(1, 256);

  float sacc[4][NR];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < NR; ++i) sacc[q][i] = 0.f;
  float yp[NR];

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int cs = ci & 1;
    const unsigned char* cst = smem + C::CST + cs * C::CST_BYTES;
    const uint32_t x_s = base + C::CST + cs * C::CST_BYTES;
    const uint32_t rec_s = x_s + C::NBX * BOX;
    const float* gts = reinterpret_cast<const float*>(cst + C::NBX * BOX);
    const float dec = gts[REC_DECAY / 4];

#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int sidx = 4 * ci + q;
      const int s = sidx % RS;
      const uint32_t c_s = ring + s * C::SLOT, b_s = c_s + BOX;
      // the previous block's c.S is done (its state update may still run,
      // over this block's image write): the image is free; the block
      // before it is done, so its slot is refilled
      if (q > 0) {
        hp::wgmma_wait<1>();
        hp::fence_regs(yp);
      }
      if (q > 1) {
        hp::fence_regs(sacc[q - 2]);
        advance(sidx - 2);
      }
      hp::bar_wait(&my_full[s], (sidx / RS) & 1);
      // S[block]^T's parts: rows p, 64 columns n; matrices (k, r) of the
      // accumulator stored transposed (row p = 8k + c, chunk 2·w4 + r)
#pragma unroll
      for (int k = 0; k < NPG; k += 2) {
        const int k1 = k + 1 < NPG ? k + 1 : k;   // an odd NPG: k twice
        uint32_t hi[4], lo[4];
        split_bf16(sacc[q][4 * k], sacc[q][4 * k + 1], hi[0], lo[0]);
        split_bf16(sacc[q][4 * k + 2], sacc[q][4 * k + 3], hi[1], lo[1]);
        split_bf16(sacc[q][4 * k1], sacc[q][4 * k1 + 1], hi[2], lo[2]);
        split_bf16(sacc[q][4 * k1 + 2], sacc[q][4 * k1 + 3], hi[3], lo[3]);
        const int mm = lane >> 3;
        const uint32_t off =
            hp::swz(8 * ((mm >> 1) ? k1 : k) + (lane & 7), 2 * w4 + (mm & 1));
        hp::stmatrix_x4_trans(img_hi + off, hi[0], hi[1], hi[2], hi[3]);
        hp::stmatrix_x4_trans(img_lo + off, lo[0], lo[1], lo[2], lo[3]);
      }
      hp::fence_proxy_async();
      hp::named_sync(3 + w, 128);
      // y += c[:, block] . S[block]
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<PW>::template ss<0, 0>(yp, hp::desc_kmajor(c_s, kk),
                                         hp::desc_kmajor(img_hi, kk),
                                         q > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<PW>::template ss<0, 0>(yp, hp::desc_kmajor(c_s, kk),
                                         hp::desc_kmajor(img_lo, kk), 1);
      hp::wgmma_commit();
      // S[block] = exp(l_L) S[block] + b[:, block]^T (w x)
#pragma unroll
      for (int i = 0; i < NR; ++i) sacc[q][i] *= dec;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<PW>::template ss<1, 0>(sacc[q],
                                         hp::desc_mnmajor(b_s, kk, BOX),
                                         hp::desc_kmajor(wx_hi, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::Wgmma<PW>::template ss<1, 0>(sacc[q],
                                         hp::desc_mnmajor(b_s, kk, BOX),
                                         hp::desc_kmajor(wx_lo, kk), 1);
      hp::wgmma_commit();
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(yp);
    hp::fence_regs(sacc[2]);
    hp::fence_regs(sacc[3]);
    advance(4 * ci + 2);
    advance(4 * ci + 3);

    // y = exp(l_i) (c.S over this warpgroup's n) + M.x over its half of j
    {
      const float e0 = gts[REC_E / 4 + row0], e1 = gts[REC_E / 4 + row0 + 8];
#pragma unroll
      for (int k = 0; k < NPG; ++k) {
        yp[4 * k] *= e0;
        yp[4 * k + 1] *= e0;
        yp[4 * k + 2] *= e1;
        yp[4 * k + 3] *= e1;
      }
    }
    hp::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hp::Wgmma<PW>::template ss<0, 1>(
          yp, hp::desc_kmajor(rec_s, 2 * w + i),
          hp::desc_mnmajor(x_s, 2 * w + i, BOX), 1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hp::Wgmma<PW>::template ss<0, 1>(
          yp, hp::desc_kmajor(rec_s + REC_M_LO, 2 * w + i),
          hp::desc_mnmajor(x_s, 2 * w + i, BOX), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(yp);
    hp::bar_arrive(&cempty[cs]);       // this warpgroup is done with x, record

    // trade: warpgroup w finishes the column groups k with k % 2 == w and
    // hands the others over, fp32, in its (now free) state-image buffer
    {
      float* mine = reinterpret_cast<float*>(smem + (img_hi - base));
      const float* theirs = reinterpret_cast<const float*>(
          smem + C::IMG + (1 - w) * C::IMG_BYTES);
      auto at = [&](int i, int k) {
        return i * PW + (k < 8 ? 8 * (k ^ (i & 7)) : 8 * k) + 2 * t;
      };
#pragma unroll
      for (int k = 0; k < NPG; ++k)
        if ((k & 1) != w)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(&mine[at(row0 + 8 * r, k)]) =
                make_float2(yp[4 * k + 2 * r], yp[4 * k + 2 * r + 1]);
      hp::named_sync(1, 256);
      bf16* yg = p.y + b * p.y_s[0] + h * p.y_s[1];
#pragma unroll
      for (int k = 0; k < NPG; ++k) {
        if ((k & 1) != w) continue;
        const int col = p0 + 8 * k + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = ci * L + row0 + 8 * r;
          const float2 o =
              *reinterpret_cast<const float2*>(&theirs[at(row0 + 8 * r, k)]);
          const float v0 = yp[4 * k + 2 * r] + o.x;
          const float v1 = yp[4 * k + 2 * r + 1] + o.y;
          if (row >= p.S) continue;
          bf16* yr = yg + row * p.y_s[2];
          if (col + 1 < PD)
            *reinterpret_cast<uint32_t*>(yr + col) = repro::pack_bf16(v0, v1);
          else if (col < PD)
            yr[col] = __float2bfloat16_rn(v0);
        }
      }
    }
    // (w x)^T of the next chunk, in place: every product of this chunk
    // that read it is done
    if (ci + 1 < n_chunks) {
      hp::bar_wait(&cfull[cs ^ 1], ((ci + 1) >> 1) & 1);
      build_wx(ci + 1);
      hp::fence_proxy_async();
    }
    hp::named_sync(2, 256);            // trade read, (w x)^T written
    if (tid == 0 && ci + 2 < n_chunks) {
      hp::bar_wait(&cempty[cs], (ci >> 1) & 1);
      load_chunk(ci + 2);
    }
  }

  // the final state through shared memory (free: every load was used), so
  // that its rows of 513 floats go out whole, not 16 bytes at a time
  constexpr int SP = PW + 4;           // fp32 pitch
  float* st = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < NPG; ++k)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(
            &st[(64 * (4 * w + q) + row0 + 8 * r) * SP + 8 * k + 2 * t]) =
            make_float2(sacc[q][4 * k + 2 * r], sacc[q][4 * k + 2 * r + 1]);
  hp::named_sync(1, 256);
  const int vc = PD - p0 < PW ? PD - p0 : PW;   // columns below P
  float* sf = p.s_final + ((ll)b * p.H + h) * NS * PD + p0;
  for (int i = tid; i < NS * vc; i += 256) {
    const int n = i / vc, col = i - n * vc;
    sf[(ll)n * PD + col] = st[n * SP + col];
  }
}

__global__ void __launch_bounds__(256, 1)
    ssd_scan_wide_kernel(const __grid_constant__ CUtensorMap c_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t sfull[2 * RS], sempty[2 * RS];
  __shared__ __align__(8) uint64_t cfull[2], cempty[2];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * RS; ++i) {
      hp::bar_init(&sfull[i], 1);
      hp::bar_init(&sempty[i], 128);
    }
    for (int i = 0; i < 2; ++i) {
      hp::bar_init(&cfull[i], 1);
      hp::bar_init(&cempty[i], 256);
    }
    hp::bar_init_fence();
    hp::tma_prefetch_map(&c_map);
    hp::tma_prefetch_map(&b_map);
    hp::tma_prefetch_map(&x_map);
  }
  __syncthreads();
  if (blockIdx.x == NTILES - 1)        // columns 448-512 and 7 zero columns
    scan_tile<72>(&c_map, &b_map, &x_map, p, smem, base, sfull, sempty,
                  cfull, cempty);
  else
    scan_tile<64>(&c_map, &b_map, &x_map, p, smem, base, sfull, sempty,
                  cfull, cempty);
}

// The maps of c and b, (B, H, S, 512) at the given strides; a head stride
// of 0 gives a map over one head (its stride is never used).
bool cb_maps(CUtensorMap* cm, CUtensorMap* bm, Params* p, const void* c,
             const void* b, int B, int H, int S, ll c_sb, ll c_sh, ll c_ss,
             ll b_sb, ll b_sh, ll b_ss) {
  p->c_head = c_sh != 0;
  p->b_head = b_sh != 0;
  return hp::attn_map(cm, &p->perm_c, c, B, c_sh ? H : 1, S, NS, c_sb,
                      c_sh ? c_sh : c_sb, c_ss, L) &&
         hp::attn_map(bm, &p->perm_b, b, B, b_sh ? H : 1, S, NS, b_sb,
                      b_sh ? b_sh : b_sb, b_ss, L);
}

}  // namespace

// Bytes of the first pass's records for (B, H, S): the wrapper allocates
// them.
extern "C" long long ssd_scan_wide_workspace(int B, int H, int S) {
  return (ll)B * H * ((S + L - 1) / L) * REC;
}

// c, b: (B, H, S, 512) bf16; x, y: (B, H, S, 513) bf16; log_a, gate:
// (B, H, S) fp32; each read through its (batch, head, seq) strides with a
// unit stride on the last dim of c, b, x, y, strides a multiple of 8
// elements (c's and b's head strides may be 0) and 16-byte aligned bases.
// s_final: (B, H, 512, 513) fp32, contiguous; ws: ssd_scan_wide_workspace
// bytes, 16-byte aligned, holding the records of ssd_scan_wide_prep on the
// same inputs (launched before, on the same stream).  Returns 0 or a CUDA
// error code; -1 for arguments the kernel does not take.
extern "C" int ssd_scan_wide_fwd(const void* c, const void* b, const void* x,
                                 const void* log_a, const void* gate, void* y,
                                 void* s_final, const void* ws, int B, int H,
                                 int S, int N, int P, ll c_sb, ll c_sh,
                                 ll c_ss, ll b_sb, ll b_sh, ll b_ss, ll x_sb,
                                 ll x_sh, ll x_ss, ll y_sb, ll y_sh, ll y_ss,
                                 ll la_sb, ll la_sh, ll la_ss, ll g_sb,
                                 ll g_sh, ll g_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return -1;
  if (N != NS || P != PD) return -1;   // xlstm's d_head 512 and the ones
  CUtensorMap cm, bm, xm;
  Params p{};
  if (!cb_maps(&cm, &bm, &p, c, b, B, H, S, c_sb, c_sh, c_ss, b_sb, b_sh,
               b_ss) ||
      !hp::attn_map(&xm, &p.perm_x, x, B, H, S, PD, x_sb, x_sh, x_ss, L))
    return static_cast<int>(cudaErrorInvalidValue);
  p.log_a = static_cast<const float*>(log_a);
  p.gate = static_cast<const float*>(gate);
  p.la_s[0] = la_sb; p.la_s[1] = la_sh; p.la_s[2] = la_ss;
  p.g_s[0] = g_sb; p.g_s[1] = g_sh; p.g_s[2] = g_ss;
  p.ws = static_cast<unsigned char*>(const_cast<void*>(ws));
  p.y = static_cast<bf16*>(y);
  p.y_s[0] = y_sb; p.y_s[1] = y_sh; p.y_s[2] = y_ss;
  p.s_final = static_cast<float*>(s_final);
  p.H = H;
  p.S = S;
  constexpr int smem = WCfg<72>::SMEM;     // the larger tile's layout
  static_assert(WCfg<64>::SMEM <= smem, "one layout for both tiles");
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_wide_kernel<<<dim3(NTILES, H, B), 256, smem,
                         static_cast<cudaStream_t>(stream)>>>(cm, bm, xm, p);
  return static_cast<int>(cudaGetLastError());
}

// The first pass: the records of c, b, log_a and gate (strides as above)
// into ws.  Returns 0 or a CUDA error code; -1 for arguments it does not
// take.
extern "C" int ssd_scan_wide_prep(const void* c, const void* b,
                                  const void* log_a, const void* gate,
                                  void* ws, int B, int H, int S, ll c_sb,
                                  ll c_sh, ll c_ss, ll b_sb, ll b_sh,
                                  ll b_ss, ll la_sb, ll la_sh, ll la_ss,
                                  ll g_sb, ll g_sh, ll g_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return -1;
  CUtensorMap cm, bm;
  Params p{};
  if (!cb_maps(&cm, &bm, &p, c, b, B, H, S, c_sb, c_sh, c_ss, b_sb, b_sh,
               b_ss))
    return static_cast<int>(cudaErrorInvalidValue);
  p.log_a = static_cast<const float*>(log_a);
  p.gate = static_cast<const float*>(gate);
  p.la_s[0] = la_sb; p.la_s[1] = la_sh; p.la_s[2] = la_ss;
  p.g_s[0] = g_sb; p.g_s[1] = g_sh; p.g_s[2] = g_ss;
  p.ws = static_cast<unsigned char*>(ws);
  p.H = H;
  p.S = S;
  const int n_chunks = (S + L - 1) / L;
  if (n_chunks > 65535) return -1;
  constexpr int prep_smem = PREP_SLOTS * 2 * BOX + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wide_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      prep_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_wide_prep_kernel<<<dim3(n_chunks, H, B), 128, prep_smem,
                         static_cast<cudaStream_t>(stream)>>>(cm, bm, p);
  return static_cast<int>(cudaGetLastError());
}
