// Flash attention backward (causal / windowed GQA self-attention) for Hopper:
// dq, dk, dv from q, k, v, the forward's output o and row log-sum-exp lse,
// and the upstream gradient do.
//
// Replaces: nothing on the TPU (no Pallas counterpart).  The JAX package
// cannot differentiate through src/repro/kernels/flash_attention/kernel.py:
// 103 flash_attention_pallas (pallas_call has no reverse-mode rule and the
// kernel no custom_vjp); this computes the gradient of
// repro.kernels.flash_attention.ref.attention_ref, the function the forward
// kernel computes.
//
// What bounds it on the H100: operations.  At the training path's shape
// (B 4, Hq 28 over Hkv 4, S 2048, D 128, causal) the five products (S =
// QK^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) need 5 · 2·S²·D
// per (b, q head), halved by the mask: 3.0e11 FLOP, 0.30 ms at 989
// TFLOP/s, against 268 MB of q, k, v, o, do, dq, dk, dv: 0.08 ms at 3.35
// TB/s.  The earlier design (mma.sync on 4-warp blocks of 16-row warp
// tiles, cp.async with a __syncthreads every 32 query rows, padded rows)
// ran at 3.1x SDPA's backward: mma.sync reaches at most half the tensor
// cores' rate, every product re-read its operands by ldmatrix, and the
// dK/dV blocks stepped through 32 rows at a time.
//
// Design (FlashAttention-3's backward, kept deterministic: three kernels,
// no atomics, every output element written by one block in a fixed order
// of sums):
//  * delta_kernel: the rows (lse·log2e, Delta = rowsum(dO ∘ O)) in fp32,
//    (B, Hq, S_pad, 2) with S padded to 128; rows past S read (+inf, 0), so
//    that P = 0 there without a mask.  The two kernels below load these
//    rows beside their tiles;
//  * dkdv_kernel: one block of two warpgroups per (128 keys, kv head,
//    batch), each warpgroup owning 64 keys.  K and V come once by TMA; the
//    block walks the GQA group's q heads (7 for qwen2-7b, 3 for
//    granite-moe-3b-a800m) and the visible query tiles of 64 rows,
//    heaviest causal blocks first (the grid is 1-D
//    with the key tile slowest), whose Q and dO come through a 4-stage TMA
//    ring with their 64 rows of (lse·log2e, Delta) beside them (a bulk
//    copy on the same barrier).  S^T = K·Q^T and dP^T = V·dO^T are wgmma
//    m64n64k16 with both operands in shared memory (K and V K-major A, Q
//    and dO K-major B); P^T and dS^T = P^T ∘ (dP^T − Delta) go from the
//    accumulators straight into the bf16 A fragments of dV += P^T·dO and
//    dK += dS^T·Q (wgmma m64n128k16, dO and Q MN-major B).  dK and dV stay
//    in fp32 registers for the whole walk and are stored once, in bf16;
//  * dq_kernel: one block of two warpgroups per (128 query rows, q head,
//    batch), heaviest causal tiles first, each warpgroup owning 64 rows.
//    Q and dO come once; K and V tiles of 128 keys through a 2-stage ring.
//    S = Q·K^T and dP = dO·V^T (m64n128k16, shared-memory operands), then
//    dS into registers for dQ += dS·K (m64n128k16, K MN-major B).  This
//    recomputes S and dP (seven products where the bound counts five): the
//    price of a dQ with no atomics.  Tiles of 64 keys in a 4-stage ring
//    ran slower on the H100 (twice the steps, N 64 products);
//  * within a warpgroup the products run in turn: dV and dK of step t - 1,
//    then S^T and dP^T of step t, then the softmax (in dq: dQ, then S and
//    dP).  The two warpgroups' turns interleave on the tensor cores.
//    Issuing step t's S^T with step t - 1's dV and dK (one wait for both)
//    keeps S^T, dP^T and the P^T, dS^T fragments live together: dK, dV
//    (64 + 64), S^T, dP^T (32 + 32) and the fragments (16 + 16) leave too
//    few of the 255 registers for addresses, and the spills made it
//    slower.  Handing the tensor cores from one warpgroup to the other by
//    named barriers (as the forward does) was slower too;
//  * two warpgroups run at the 255 registers the launch bound allows
//    (setmaxnreg gives no consumer more, see hopper.cuh), so there is no
//    producer warp: the first thread issues the loads, predicated, after
//    its warpgroup has released the stage it refills.  The addresses of
//    the operands that stay put (K and V in dkdv, Q and dO in dq) are made
//    opaque to the compiler, which otherwise holds their sixteen 64-bit
//    descriptors in registers across the walk;
//  * no wgmma sits inside a branch (ptxas serialises wgmma around a
//    divergent path): masks are selects from two bounds a row, applied to
//    every tile; tiles wholly above the causal diagonal or outside the
//    window are skipped by the loops' bounds;
//  * P = exp2(S·scale·log2e − lse·log2e) is rebuilt from the forward's lse,
//    so no (S, S) matrix reaches memory; P and dS are rounded to bf16 as
//    the operands of their products (kernels/common.py states the
//    tolerance);
//  * q, k, v, o, do, dq, dk, dv are read and written through (batch, head,
//    seq) strides (4-D tensor maps ordered by stride), so the model's
//    (B, S, H, D) tensors need no transpose; rows past S read zeros and are
//    never stored.
// D is a template parameter, built at 128 (two 64-column TMA boxes a row)
// and 64 (one box: granite-moe-3b-a800m's B 4, 24 q heads over 8 kv heads,
// S 2048, causal: 1.29e11 FLOP, 0.130 ms at 989 TFLOP/s, against 135 MB,
// 0.040 ms: operations).  At 64 the same code runs with NB = 1: each wgmma
// of dK, dV and dQ is m64n64k16 (Wgmma<64>::rs), the rings hold half the
// bytes, and the Delta pass loads 4 bytes a lane.
#include "common.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <math.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;

constexpr int NTHREADS = 256;                // 2 warpgroups
constexpr int ROWS_PAD = 128;                // S_pad: a multiple of this
constexpr float LOG2E = 1.4426950408889634f;

// `a` as a value the compiler cannot see through: the descriptors built
// from it are formed where they are used, not hoisted out of the loop as
// invariants (sixteen 64-bit descriptors of K and V would hold 32 registers
// across the whole walk).
__device__ __forceinline__ uint32_t opaque(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

// ---------------------------------------------------------------------------
// rows = (lse·log2e, Delta = rowsum(dO ∘ O)): one warp a row
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128)
    delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ rows,
                 int S, int S_pad, ll o_sb, ll o_sh, ll o_ss, ll d_sb,
                 ll d_sh, ll d_ss) {
  // one load a lane: 8 bytes at D 128, 4 at D 64
  constexpr int PER_LANE = D / 32;
  using Vec = std::conditional_t<PER_LANE == 4, uint2, uint32_t>;
  static_assert(PER_LANE == 2 || PER_LANE == 4, "D is 64 or 128");
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (int)blockIdx.x * 64;
  const ll bh = (ll)b * gridDim.y + h;
  for (int row = row0 + warp; row < row0 + 64; row += 4) {
    float acc = 0.f;
    if (row < S) {
      const Vec ov = *reinterpret_cast<const Vec*>(
          o + b * o_sb + h * o_sh + row * o_ss + lane * PER_LANE);
      const Vec dv = *reinterpret_cast<const Vec*>(
          dout + b * d_sb + h * d_sh + row * d_ss + lane * PER_LANE);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < PER_LANE / 2; ++i) {
        const float2 a = __bfloat1622float2(op[i]);
        const float2 c = __bfloat1622float2(dp[i]);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float2* dst = reinterpret_cast<float2*>(rows) + bh * S_pad + row;
      *dst = row < S ? make_float2(lse[bh * S + row] * LOG2E, acc)
                     : make_float2(INFINITY, 0.f);
    }
  }
}

// The P and dS of one accumulator tile of raw scores sc and dP values dp
// (8n + 2·t4 + (e & 1) the tile's column, row e >> 1 of the thread's two),
// packed as bf16 A fragments (column groups 2kk, 2kk + 1 form k16 step kk).
// Element (r, c) is kept while lo[r] <= c < hi[r]; l2 and dl give the
// column's or row's (lse·log2e, Delta).
template <int N, typename RowsOf>
__device__ __forceinline__ void p_and_ds(const float (&sc)[N / 2],
                                         const float (&dp)[N / 2],
                                         uint32_t (&pf)[N / 16][4],
                                         uint32_t (&dsf)[N / 16][4],
                                         const int (&lo)[2],
                                         const int (&hi)[2],
                                         float scale_log2, RowsOf rows_of) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = 8 * n + (e & 1);
      float l2, dl;
      rows_of(n, e, l2, dl);
      float pe = repro::exp2_approx(fmaf(sc[4 * n + e], scale_log2, -l2));
      pe = c >= lo[r] && c < hi[r] ? pe : 0.f;
      p[e] = pe;
      ds[e] = pe * (dp[4 * n + e] - dl);
    }
    pf[n / 2][(n & 1) * 2] = repro::pack_bf16(p[0], p[1]);
    pf[n / 2][(n & 1) * 2 + 1] = repro::pack_bf16(p[2], p[3]);
    dsf[n / 2][(n & 1) * 2] = repro::pack_bf16(ds[0], ds[1]);
    dsf[n / 2][(n & 1) * 2 + 1] = repro::pack_bf16(ds[2], ds[3]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (128 keys, kv head, batch)
// ---------------------------------------------------------------------------
template <int D>
struct DkdvCfg {
  static constexpr int KB = 128;             // keys a block, 64 a warpgroup
  static constexpr int QB = 64;              // query rows a step
  static constexpr int ST = 4;               // steps in the ring
  static constexpr int NB = D / 64;          // 64-wide boxes across D
  static constexpr int K_BOX = KB * 128;
  static constexpr int Q_BOX = QB * 128;
  static constexpr int KV_BYTES = NB * K_BOX;          // K or V
  static constexpr int Q_BYTES = NB * Q_BOX;           // a Q or dO tile
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int ROWS = QB * 8;                  // (lse·log2e, Delta)
  static constexpr int SMEM = 2 * KV_BYTES + ST * (STAGE + ROWS) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map, int q_perm,
                int k_perm, int v_perm, int do_perm,
                const float* __restrict__ rows, bf16* __restrict__ dk,
                ll dk_sb, ll dk_sh, ll dk_ss, bf16* __restrict__ dv, ll dv_sb,
                ll dv_sh, ll dv_ss, int Hq, int Hkv, int S, int S_pad,
                float scale, int causal, int window) {
  using C = DkdvCfg<D>;
  constexpr int QB = C::QB, ST = C::ST;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  // K, V, then stage s's Q and dO at 2·KV_BYTES + s·STAGE, and the rows
  // of every stage after the last
  auto q_off = [](int s) { return 2 * C::KV_BYTES + s * C::STAGE; };
  auto rows_off = [](int s) {
    return 2 * C::KV_BYTES + ST * C::STAGE + s * C::ROWS;
  };

  // a 1-D grid, key tile slowest: under the causal mask tile 0 is the
  // heaviest, and every (kv head, batch)'s tile 0 starts first
  const int n_bh = gridDim.x / ((S + C::KB - 1) / C::KB);
  const int kt = blockIdx.x / n_bh;
  const int hk = blockIdx.x % n_bh % Hkv, b = blockIdx.x % n_bh / Hkv;
  const int k0 = kt * C::KB;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, w4 = warp % 4, gq = lane / 4, t4 = lane % 4;
  const int key0 = k0 + 64 * wg + 16 * w4 + gq;     // keys key0, key0 + 8
  const int group = Hq / Hkv;
  const float scale_log2 = scale * LOG2E;

  // the queries that can see a key of this block: q >= key (causal) and
  // q < key + window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + C::KB - 1 + window) : S;
  const int n_qt = (q_hi - q_lo + QB - 1) / QB;
  const int n_steps = group * n_qt;          // step t: head t / n_qt

  auto load_step = [&](bool p, int t) {
    const int s = t % ST;
    const int h = hk * group + t / n_qt;
    const int q0 = q_lo + (t % n_qt) * QB;
    hp::bar_wait_if(p && t >= ST, &empty[s], ((t / ST) & 1) ^ 1);
    hp::bar_arrive_tx_if(p, &full[s], C::STAGE + C::ROWS);
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      hp::attn_load_box(p, smem + q_off(s) + i * C::Q_BOX, &q_map, &full[s],
                        q_perm, 64 * i, h, q0, b);
      hp::attn_load_box(p, smem + q_off(s) + C::Q_BYTES + i * C::Q_BOX,
                        &do_map, &full[s], do_perm, 64 * i, h, q0, b);
    }
    hp::bulk_load_if(p, smem + rows_off(s),
                     rows + ((ll)(b * Hq + h) * S_pad + q0) * 2, C::ROWS,
                     &full[s]);
  };
  const bool loader = tid == 0;

  if (tid == 0) {
    hp::bar_init(&bar_kv, 1);
    for (int i = 0; i < ST; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], NTHREADS);             // every thread
    }
    hp::bar_init_fence();
  }
  __syncthreads();
  if (loader) {
    hp::bar_arrive_tx(&bar_kv, 2 * C::KV_BYTES);
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      hp::attn_load_box(true, smem + i * C::K_BOX, &k_map, &bar_kv, k_perm,
                        64 * i, hk, k0, b);
      hp::attn_load_box(true, smem + C::KV_BYTES + i * C::K_BOX, &v_map,
                        &bar_kv, v_perm, 64 * i, hk, k0, b);
    }
    for (int t = 0; t < min(ST, n_steps); ++t) load_step(true, t);
  }

  float dk_acc[D / 2] = {}, dv_acc[D / 2] = {};
  float st[QB / 2], dpt[QB / 2];
  uint32_t pf[QB / 16][4], dsf[QB / 16][4];
  // this warpgroup's 64 keys: rows 64·wg.. of each K and V box
  const uint32_t k_base = base + wg * 64 * 128;

  // S^T = K·Q^T and dP^T = V·dO^T of step t, one wgmma group
  auto issue_s = [&](int t) {
    const uint32_t q_s = base + q_off(t % ST), do_s = q_s + C::Q_BYTES;
    const uint32_t k_s = opaque(k_base), v_s = k_s + C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::Wgmma<QB>::template ss<0, 0>(
          st, hp::desc_kmajor(k_s + (kk / 4) * C::K_BOX, kk % 4),
          hp::desc_kmajor(q_s + (kk / 4) * C::Q_BOX, kk % 4), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::Wgmma<QB>::template ss<0, 0>(
          dpt, hp::desc_kmajor(v_s + (kk / 4) * C::K_BOX, kk % 4),
          hp::desc_kmajor(do_s + (kk / 4) * C::Q_BOX, kk % 4), kk > 0);
    hp::wgmma_commit();
  };
  // dV += P^T·dO and dK += dS^T·Q of step t, one wgmma group
  auto issue_g = [&](int t) {
    const uint32_t q_s = base + q_off(t % ST), do_s = q_s + C::Q_BYTES;
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
      hp::Wgmma<D>::template rs<1>(dv_acc, pf[kk],
                                   hp::desc_mnmajor(do_s, kk, C::Q_BOX), 1);
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk)
      hp::Wgmma<D>::template rs<1>(dk_acc, dsf[kk],
                                   hp::desc_mnmajor(q_s, kk, C::Q_BOX), 1);
    hp::wgmma_commit();
  };
  // P^T and dS^T of step t: S^T's rows are this thread's keys, its columns
  // the step's queries q0 + 8n + 2·t4 + (e & 1), whose rows sit in the
  // stage as float4 (l2, delta, l2', delta') a column pair
  auto softmax = [&](int t) {
    const int q0 = q_lo + (t % n_qt) * QB;
    const float4* rw =
        reinterpret_cast<const float4*>(smem + rows_off(t % ST)) + t4;
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c_key = key0 + 8 * r - q0 - 2 * t4;  // column of q == key
      lo[r] = causal ? c_key : INT_MIN;
      hi[r] = window > 0 ? c_key + window : INT_MAX;
    }
    p_and_ds<QB>(st, dpt, pf, dsf, lo, hi, scale_log2,
                 [&](int n, int e, float& l2, float& dl) {
                   const float4 v = rw[4 * n];
                   l2 = e & 1 ? v.z : v.x;
                   dl = e & 1 ? v.w : v.y;
                 });
  };

  hp::bar_wait(&bar_kv, 0);
  hp::bar_wait(&full[0], 0);
  hp::wgmma_fence();
  issue_s(0);
  hp::wgmma_wait<0>();
  hp::fence_regs(st);
  hp::fence_regs(dpt);
  softmax(0);
  for (int t = 1; t < n_steps; ++t) {
    hp::wgmma_fence();
    issue_g(t - 1);
    hp::wgmma_wait<0>();
    hp::fence_regs(pf);
    hp::fence_regs(dsf);
    hp::bar_arrive(&empty[(t - 1) % ST]);
    // refill the stage of step t - 1 once both warpgroups have released it
    const int nt = t - 1 + ST;
    load_step(loader && nt < n_steps, nt);
    hp::bar_wait(&full[t % ST], (t / ST) & 1);
    hp::wgmma_fence();
    issue_s(t);
    hp::wgmma_wait<0>();
    hp::fence_regs(st);
    hp::fence_regs(dpt);
    softmax(t);
  }
  hp::wgmma_fence();
  issue_g(n_steps - 1);
  hp::wgmma_wait<0>();
  hp::fence_regs(dk_acc);
  hp::fence_regs(dv_acc);

  bf16* dkg = dk + b * dk_sb + hk * dk_sh;
  bf16* dvg = dv + b * dv_sb + hk * dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkg + key * dk_ss + col) =
          repro::pack_bf16(dk_acc[4 * n + 2 * r] * scale,
                    dk_acc[4 * n + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvg + key * dv_ss + col) =
          repro::pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (128 query rows, q head, batch)
// ---------------------------------------------------------------------------
template <int D>
struct DqCfg {
  static constexpr int QB = 128;             // rows a block, 64 a warpgroup
  static constexpr int KB = 128;             // keys a step
  static constexpr int ST = 2;               // 64 KB a stage
  static constexpr int NB = D / 64;
  static constexpr int Q_BOX = QB * 128;
  static constexpr int K_BOX = KB * 128;
  static constexpr int Q_BYTES = NB * Q_BOX;           // Q or dO
  static constexpr int KV_BYTES = NB * K_BOX;          // a K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int SMEM = 2 * Q_BYTES + ST * STAGE + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap do_map, int q_perm,
              int k_perm, int v_perm, int do_perm,
              const float* __restrict__ rows, bf16* __restrict__ dq,
              ll dq_sb, ll dq_sh, ll dq_ss, int Hq, int group, int S,
              int S_pad, float scale, int causal, int window) {
  using C = DqCfg<D>;
  constexpr int KB = C::KB, ST = C::ST;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // Q, dO, then stage s's K at 2·Q_BYTES + s·STAGE and its V after it
  auto k_off = [](int s) { return 2 * C::Q_BYTES + s * C::STAGE; };

  // a 1-D grid, q tile slowest and the last (heaviest causal) tile first
  const int n_qt = (S + C::QB - 1) / C::QB;
  const int n_bh = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)blockIdx.x / n_bh;
  const int h = blockIdx.x % n_bh % Hq, b = blockIdx.x % n_bh / Hq;
  const int hk = h / group;
  const int q0 = qt * C::QB;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, w4 = warp % 4, gq = lane / 4, t4 = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * w4 + gq;     // rows row0, row0 + 8
  const float scale_log2 = scale * LOG2E;

  // keys any row of this tile can see
  const int k_end = causal ? min(S, q0 + C::QB) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / KB) * KB;
  const int n_kt = (k_end - k_begin + KB - 1) / KB;

  auto load_kv = [&](bool p, int t) {
    const int s = t % ST;
    hp::bar_wait_if(p && t >= ST, &empty[s], ((t / ST) & 1) ^ 1);
    hp::bar_arrive_tx_if(p, &full[s], C::STAGE);
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      hp::attn_load_box(p, smem + k_off(s) + i * C::K_BOX, &k_map, &full[s],
                        k_perm, 64 * i, hk, k_begin + t * KB, b);
      hp::attn_load_box(p, smem + k_off(s) + C::KV_BYTES + i * C::K_BOX,
                        &v_map, &full[s], v_perm, 64 * i, hk,
                        k_begin + t * KB, b);
    }
  };
  const bool loader = tid == 0;

  if (tid == 0) {
    hp::bar_init(&bar_q, 1);
    for (int i = 0; i < ST; ++i) {
      hp::bar_init(&full[i], 1);
      hp::bar_init(&empty[i], NTHREADS);
    }
    hp::bar_init_fence();
  }
  __syncthreads();
  if (loader) {
    hp::bar_arrive_tx(&bar_q, 2 * C::Q_BYTES);
#pragma unroll
    for (int i = 0; i < C::NB; ++i) {
      hp::attn_load_box(true, smem + i * C::Q_BOX, &q_map, &bar_q, q_perm,
                        64 * i, h, q0, b);
      hp::attn_load_box(true, smem + C::Q_BYTES + i * C::Q_BOX, &do_map,
                        &bar_q, do_perm, 64 * i, h, q0, b);
    }
    for (int t = 0; t < min(ST, n_kt); ++t) load_kv(true, t);
  }

  // this thread's rows: (lse·log2e, Delta); rows past S read (+inf, 0)
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 v = reinterpret_cast<const float2*>(
        rows)[((ll)b * Hq + h) * S_pad + row0 + 8 * r];
    l2[r] = v.x;
    dl[r] = v.y;
  }

  float dq_acc[D / 2] = {};
  float sc[KB / 2], dp[KB / 2];
  uint32_t pf[KB / 16][4], dsf[KB / 16][4];
  // this warpgroup's 64 rows of each Q and dO box
  const uint32_t q_base = base + wg * 64 * 128;

  // S = Q·K^T and dP = dO·V^T of key tile t, one wgmma group
  auto issue_s = [&](int t) {
    const uint32_t k_s = base + k_off(t % ST), v_s = k_s + C::KV_BYTES;
    const uint32_t q_s = opaque(q_base), do_s = q_s + C::Q_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::Wgmma<KB>::template ss<0, 0>(
          sc, hp::desc_kmajor(q_s + (kk / 4) * C::Q_BOX, kk % 4),
          hp::desc_kmajor(k_s + (kk / 4) * C::K_BOX, kk % 4), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hp::Wgmma<KB>::template ss<0, 0>(
          dp, hp::desc_kmajor(do_s + (kk / 4) * C::Q_BOX, kk % 4),
          hp::desc_kmajor(v_s + (kk / 4) * C::K_BOX, kk % 4), kk > 0);
    hp::wgmma_commit();
  };
  // dQ += dS·K of key tile t, one wgmma group
  auto issue_g = [&](int t) {
    const uint32_t k_s = base + k_off(t % ST);
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      hp::Wgmma<D>::template rs<1>(dq_acc, dsf[kk],
                                   hp::desc_mnmajor(k_s, kk, C::K_BOX), 1);
    hp::wgmma_commit();
  };
  // dS of key tile t: row r of the thread sees the keys k0 + 2·t4 + c with
  // lo[r] <= c < hi[r]
  auto softmax = [&](int t) {
    const int kb0 = k_begin + t * KB;
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      hi[r] = (causal ? min(row + 1, S) : S) - kb0 - 2 * t4;
      lo[r] = window > 0 ? row - window + 1 - kb0 - 2 * t4 : INT_MIN;
    }
    p_and_ds<KB>(sc, dp, pf, dsf, lo, hi, scale_log2,
                 [&](int, int e, float& l2_, float& dl_) {
                   l2_ = l2[e >> 1];
                   dl_ = dl[e >> 1];
                 });
  };

  hp::bar_wait(&bar_q, 0);
  hp::bar_wait(&full[0], 0);
  hp::wgmma_fence();
  issue_s(0);
  hp::wgmma_wait<0>();
  hp::fence_regs(sc);
  hp::fence_regs(dp);
  softmax(0);
  for (int t = 1; t < n_kt; ++t) {
    hp::wgmma_fence();
    issue_g(t - 1);
    hp::wgmma_wait<0>();
    hp::fence_regs(dsf);
    hp::bar_arrive(&empty[(t - 1) % ST]);
    const int nt = t - 1 + ST;
    load_kv(loader && nt < n_kt, nt);
    hp::bar_wait(&full[t % ST], (t / ST) & 1);
    hp::wgmma_fence();
    issue_s(t);
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::fence_regs(dp);
    softmax(t);
  }
  hp::wgmma_fence();
  issue_g(n_kt - 1);
  hp::wgmma_wait<0>();
  hp::fence_regs(dq_acc);

  bf16* dqg = dq + b * dq_sb + h * dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<uint32_t*>(dqg + row * dq_ss + col) =
          repro::pack_bf16(dq_acc[4 * n + 2 * r] * scale,
                    dq_acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk,
                   void* dv, float* rows, int B, int Hq, int Hkv, int S,
                   const ll* st, float scale, int causal, int window,
                   cudaStream_t stream) {
  using KV = DkdvCfg<D>;
  using QC = DqCfg<D>;
  const int group = Hq / Hkv;
  const int S_pad = (S + ROWS_PAD - 1) / ROWS_PAD * ROWS_PAD;
  // st: (b, h, s) strides of q, k, v, o, do, dq, dk, dv
  const ll* sq = st;
  const ll* sk = st + 3;
  const ll* sv = st + 6;
  const ll* so = st + 9;
  const ll* sdo = st + 12;
  const ll* sdq = st + 15;
  const ll* sdk = st + 18;
  const ll* sdv = st + 21;

  // maps with the dkdv kernel's boxes (64 query rows, 128 keys) and the dq
  // kernel's (128 query rows, 64 keys)
  CUtensorMap qm1, dom1, km1, vm1, qm2, dom2, km2, vm2;
  int qp1, dop1, kp1, vp1, qp2, dop2, kp2, vp2;
  if (!hp::attn_map(&qm1, &qp1, q, B, Hq, S, D, sq[0], sq[1], sq[2], KV::QB) ||
      !hp::attn_map(&dom1, &dop1, dout, B, Hq, S, D, sdo[0], sdo[1], sdo[2],
                    KV::QB) ||
      !hp::attn_map(&km1, &kp1, k, B, Hkv, S, D, sk[0], sk[1], sk[2],
                    KV::KB) ||
      !hp::attn_map(&vm1, &vp1, v, B, Hkv, S, D, sv[0], sv[1], sv[2],
                    KV::KB) ||
      !hp::attn_map(&qm2, &qp2, q, B, Hq, S, D, sq[0], sq[1], sq[2], QC::QB) ||
      !hp::attn_map(&dom2, &dop2, dout, B, Hq, S, D, sdo[0], sdo[1], sdo[2],
                    QC::QB) ||
      !hp::attn_map(&km2, &kp2, k, B, Hkv, S, D, sk[0], sk[1], sk[2],
                    QC::KB) ||
      !hp::attn_map(&vm2, &vp2, v, B, Hkv, S, D, sv[0], sv[1], sv[2], QC::KB))
    return cudaErrorInvalidValue;

  delta_kernel<D><<<dim3(S_pad / 64, Hq, B), 128, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, rows,
      S, S_pad, so[0], so[1], so[2], sdo[0], sdo[1], sdo[2]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KV::SMEM);
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<(S + KV::KB - 1) / KV::KB * Hkv * B, NTHREADS, KV::SMEM,
                   stream>>>(
      qm1, km1, vm1, dom1, qp1, kp1, vp1, dop1, rows, static_cast<bf16*>(dk),
      sdk[0], sdk[1], sdk[2], static_cast<bf16*>(dv), sdv[0], sdv[1], sdv[2],
      Hq, Hkv, S, S_pad, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QC::SMEM);
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<(S + QC::QB - 1) / QC::QB * Hq * B, NTHREADS, QC::SMEM,
                 stream>>>(qm2, km2, vm2, dom2, qp2, kp2, vp2, dop2, rows,
                           static_cast<bf16*>(dq), sdq[0], sdq[1], sdq[2], Hq,
                           group, S, S_pad, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// The rows of the (B, Hq, S_pad, 2) fp32 scratch: S_pad is S rounded up to
// a multiple of this.
extern "C" int flash_attention_bwd_rows() { return ROWS_PAD; }

// q, o, do, dq: (B, Hq, S, D); k, v, dk, dv: (B, Hkv, S, D); all bf16 with unit
// stride on D and the given (batch, head, seq) strides, 24 in the order q, k,
// v, o, do, dq, dk, dv, each a multiple of 8 elements, and 16-byte aligned.
// lse: (B, Hq, S) fp32 from the forward; delta: (B, Hq, S_pad, 2) fp32
// scratch (flash_attention_bwd_rows).  Returns 0 or a CUDA error code; -1
// for arguments the kernels do not take.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int S, int D, ll s0, ll s1, ll s2,
    ll s3, ll s4, ll s5, ll s6, ll s7, ll s8, ll s9, ll s10, ll s11, ll s12,
    ll s13, ll s14, ll s15, ll s16, ll s17, ll s18, ll s19, ll s20, ll s21,
    ll s22, ll s23, float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (D != 64 && D != 128) return -1;  // the head dims of the trained models
  if ((ll)(S + 127) / 128 * Hq * B > INT_MAX) return -1;   // 1-D grids
  const ll st[24] = {s0,  s1,  s2,  s3,  s4,  s5,  s6,  s7,
                     s8,  s9,  s10, s11, s12, s13, s14, s15,
                     s16, s17, s18, s19, s20, s21, s22, s23};
  const auto run = D == 64 ? launch<64> : launch<128>;
  const cudaError_t err = run(
      q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
      static_cast<float*>(delta), B, Hq, Hkv, S, st, scale, causal, window,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
