// Flash attention forward (causal / windowed GQA self-attention) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:103
// flash_attention_pallas (body _fa_kernel), the TPU kernel of the dense
// model's prefill.
//
// What bounds it on the H100: operations.  At qwen2-7b's prefill shape
// (B 8, Hq 28 over Hkv 4, S 1024, D 128, causal) the two products are ~60
// GFLOP of bf16 tensor-core work against ~134 MB of q/k/v/o traffic: 61 us
// at 989 TFLOP/s against 40 us at 3.35 TB/s.  The mma.sync design (4 warps,
// 64 x 64 tiles, cp.async) reached 1.9-2.5x SDPA: that instruction is at
// most half the card's tensor-core rate.
//
// The function:
//  * causal or full, with an optional window (key > row - window); Sq == Sk;
//  * GQA: the kv head of q head h is h / (Hq / Hkv); K/V are not repeated;
//  * q, k, v and o are read through their (batch, head, seq) strides, so
//    the (B, S, H, D) activations of the model are used without a copy;
//  * the online softmax in fp32, log2 domain (exp2), with the scale applied
//    to the fp32 scores; P is rounded to bf16 for the P·V product (the TPU
//    kernel kept it in fp32; the card tolerance in kernels/common.py states
//    what that costs);
//  * for training, the row log-sum-exp of the scaled scores goes to lse
//    (B, Hq, S) fp32 when the caller passes a buffer (the backward in
//    flash_attention_bwd.cu rebuilds P from it); serving passes none;
//  * head dims 64 (zamba2-1.2b's shared block, granite-moe-3b-a800m), 128
//    (qwen2-7b, starcoder2-15b, llama3-405b) and 192 (nemotron-4-340b).
//
// Design:
//  * one block of two warpgroups per (q tile of 128 rows, q head, batch),
//    heaviest causal tiles first; the TPU's sequential K grid axis becomes
//    the loop inside the block.  Warpgroup w owns q rows 64w .. 64w + 63;
//  * Q comes once and K and V tiles of 128 keys (64 at D 192) by TMA into
//    a ring of 3 stages (4 at D 64), through 4-D tensor maps over
//    (D, H, S, B) with the tensors' strides (the outer three ordered by
//    stride for the map); K and V complete and are released on barriers of
//    their own.  Rows past S are zero-filled by TMA;
//  * no producer warp: beside two warpgroups it would leave every thread
//    168 registers (ptxas gives all paths the launch bound's budget, and
//    setmaxnreg does not change that), and the loop below needs up to ~214
//    at D 128.  One consumer thread issues the loads instead, at a point
//    of the loop where the stages it fills are already free (see the
//    kernel); its code is predicated, not branched on;
//  * S = Q·K^T runs as wgmma with Q as the register A operand (read once
//    from the swizzled tile by ldmatrix) and K from shared memory, K-major;
//    P goes to bf16 in registers and feeds O += P·V as the register A
//    operand (the fp32 accumulator layout of m64nNk16 regroups into the
//    bf16 A fragment without shared memory); V is the MN-major B operand;
//  * within a warpgroup, tile j's Q·K^T is issued together with tile j-1's
//    P·V, and tile j's softmax runs while that P·V is on the tensor cores;
//    O is rescaled while Q·K^T runs;
//  * the two warpgroups take turns to issue (named barriers), so that one's
//    softmax runs while the other's products hold the tensor cores;
//  * the softmax takes its row maxima and sums in four independent chains
//    a row, both rows at once: with one warp a scheduler doing it, latency
//    and not issue bounds it; masks are built only on tiles that straddle
//    an edge, from two bounds a row;
//  * no wgmma sits inside a branch: ptxas serialises wgmma around a
//    divergent path (warning C7520), so the first and last tiles are peeled
//    out of the loop;
//  * shared memory: Q and the ring: 144, 224 and 192 KB at D 64, 128, 192.
// Tried and dropped: a persistent grid with the loads walking several
// items (the cursors' arithmetic spilled, and it ran slower), and the
// boxes' issue spread over four warps (no faster than one thread).
// Later work: sharing each K/V tile across the q heads of a group, and
// Q·K^T tiles wider than 64 keys at D 192.
#include "common.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using ll = long long;
namespace hp = repro::hopper;

constexpr int BQ = 128;                      // query rows a block
constexpr int NTHREADS = 256;                // 2 warpgroups

template <int D>
struct Cfg {
  static constexpr int BK = D == 192 ? 64 : 128;   // keys a tile
  static constexpr int NB = D / 64;                // 64-wide boxes across D
  static constexpr int STAGES = D == 64 ? 4 : 3;   // K/V tiles in the ring
  // where the loads of the next tiles are issued (see the kernel)
  static constexpr bool EARLY_LOADS = D != 64;
  static constexpr int Q_BOX = BQ * 128;           // bytes of one Q box
  static constexpr int KV_BOX = BK * 128;          // bytes of one K or V box
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

// The online softmax of one tile of raw scores sc (keys k0 ..), for this
// thread's rows qrow0 and qrow0 + 8 of its warpgroup's 64 (from qw0):
// masks where the tile straddles an edge, the new row maxima m_r (scaled,
// log2 domain), alpha for the accumulators, l_r, and p = exp2(score·scale -
// max) in place of the scores.  The maxima and sums run in four
// independent chains a row: with one warp a scheduler at a time, the
// softmax is bound by latency, not by issue.
// sc[4n + e]: row qrow0 + 8·(e >> 1), key k0 + 8n + 2·(lane % 4) + (e & 1).
template <int BK>
__device__ __forceinline__ void online_softmax(
    float (&sc)[BK / 2], float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
    int k0, int qw0, int qrow0, int t4, int S, int causal, int window,
    float scale_log2) {
  const bool need_mask = (k0 + BK > S) || (causal && k0 + BK - 1 > qw0) ||
                         (window > 0 && k0 <= qw0 + 63 - window);
  if (need_mask) {
    // row r sees the keys k0 + 2·t4 + c with lo[r] <= c <= hi[r]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = qrow0 + 8 * r;
      hi[r] = (causal ? min(qr, S - 1) : S - 1) - k0 - 2 * t4;
      lo[r] = window > 0 ? qr - window + 1 - k0 - 2 * t4 : INT_MIN;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + (e & 1), r = e >> 1;
        sc[4 * n + e] = c >= lo[r] && c <= hi[r] ? sc[4 * n + e] : -INFINITY;
      }
  }
  // both rows at once, four chains each
  float pm[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pm[0][i] = pm[1][i] = -INFINITY;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      pm[r][n % 4] = fmaxf(pm[r][n % 4],
                           fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(pm[r][0], pm[r][1]), fmaxf(pm[r][2], pm[r][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m_r[r], mx * scale_log2);
    // a row with no visible key yet keeps m = -inf; exp2 of -inf is 0
    m_use[r] = mx == -INFINITY ? 0.f : mx;
    alpha[r] = repro::exp2_approx(m_r[r] - m_use[r]);
    m_r[r] = mx;
  }
  float ps[2][4] = {};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = repro::exp2_approx(fmaf(sc[4 * n + e], scale_log2, -m_use[r]));
      sc[4 * n + e] = p;
      ps[r][n % 4] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_r[r] = l_r[r] * alpha[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
}

// P in bf16 as the A operand of P·V: key groups 2kk and 2kk + 1 form k16
// step kk (registers: row g keys 0-1, row g+8 keys 0-1, row g keys 8-9,
// row g+8 keys 8-9, each + 2·(lane % 4)).
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      __nv_bfloat162 v =
          __floats2bfloat162_rn(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]);
      pf[n / 2][(n & 1) * 2 + r] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, int q_perm,
                     int k_perm, int v_perm, bf16* __restrict__ o, ll o_sb,
                     ll o_sh, ll o_ss, int group, int S, float scale_log2,
                     int causal, int window, float* __restrict__ lse) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t full_k[ST], full_v[ST];
  __shared__ __align__(8) uint64_t empty_k[ST], empty_v[ST];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;       // swizzle atoms: 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  // Q, then stage s's K at Q_BYTES + 2s·KV_BYTES and its V one KV_BYTES on
  auto k_off = [](int s) { return C::Q_BYTES + 2 * s * C::KV_BYTES; };
  auto v_off = [](int s) { return C::Q_BYTES + (2 * s + 1) * C::KV_BYTES; };

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;                    // q rows 64·wg .. 64·wg + 63
  const int w4 = warp % 4, gq = lane / 4, t4 = lane % 4;
  const int qw0 = q0 + 64 * wg;
  const int qrow0 = qw0 + 16 * w4 + gq;       // rows qrow0 and qrow0 + 8
  const uint32_t q_s = base + wg * 64 * 128;

  // keys any row of this tile can see
  const int k_end = causal ? min(S, q0 + BQ) : S;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_kv = (k_end - k_begin + BK - 1) / BK;

  // The TMA loads of tile t's K (V) into stage t % ST; the loader waits
  // until both warpgroups have released the K (V) that stage held before:
  // K once S of that tile is done, V once its P·V is.
  auto load_k = [&](bool p, int t) {
    const int s = t % ST;
    hp::bar_wait_if(p && t >= ST, &empty_k[s], ((t / ST) & 1) ^ 1);
    hp::bar_arrive_tx_if(p, &full_k[s], C::KV_BYTES);
#pragma unroll
    for (int i = 0; i < C::NB; ++i)
      hp::attn_load_box(p, smem + k_off(s) + i * C::KV_BOX, &k_map,
                        &full_k[s], k_perm, 64 * i, hk, k_begin + t * BK, b);
  };
  auto load_v = [&](bool p, int t) {
    const int s = t % ST;
    hp::bar_wait_if(p && t >= ST, &empty_v[s], ((t / ST) & 1) ^ 1);
    hp::bar_arrive_tx_if(p, &full_v[s], C::KV_BYTES);
#pragma unroll
    for (int i = 0; i < C::NB; ++i)
      hp::attn_load_box(p, smem + v_off(s) + i * C::KV_BOX, &v_map,
                        &full_v[s], v_perm, 64 * i, hk, k_begin + t * BK, b);
  };
  // Where the loads go.  At D 128 and 192 (EARLY_LOADS) the loader is the
  // first thread of warpgroup 0.  At its turn for tile j, warpgroup 1 has
  // issued its products of tile j - 1, so both warpgroups have released
  // the K of tile j - 2 and the V of tile j - 3: right after issuing its
  // own products, while it waits for them, the loader asks for the K of
  // tile j - 2 + ST and the V of tile j - 3 + ST, about one tile ahead of
  // their use, and never waits for a release.  Every thread runs the
  // loads' code, predicated on being the loader: no branch between a wgmma
  // and its wait.  At D 64, whose products are short and whose ring holds
  // four tiles, the first thread of warpgroup 1 loads tile j - 1 + ST once
  // it has released tile j - 1, with no product in flight: on the H100
  // that is faster at D 64 than the early loads, and slower at D 128.
  const bool loader = tid == (C::EARLY_LOADS ? 0 : 128);

  if (tid == 0) {
    hp::bar_init(&bar_q, 1);
    for (int i = 0; i < ST; ++i) {
      hp::bar_init(&full_k[i], 1);
      hp::bar_init(&full_v[i], 1);
      hp::bar_init(&empty_k[i], 256);                // every thread
      hp::bar_init(&empty_v[i], 256);
    }
    hp::bar_init_fence();
  }
  __syncthreads();
  if (loader) {
    hp::bar_arrive_tx(&bar_q, C::Q_BYTES);
#pragma unroll
    for (int i = 0; i < C::NB; ++i)
      hp::attn_load_box(true, smem + i * C::Q_BOX, &q_map, &bar_q, q_perm,
                        64 * i, h, q0, b);
    for (int t = 0; t < min(ST, n_kv); ++t) {
      load_k(true, t);
      load_v(true, t);
    }
  }

  {
    float acc[D / 2] = {};
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};
    float sc[BK / 2], alpha[2];
    uint32_t pf[BK / 16][4];

    // Q as wgmma's register A operand, read once from the swizzled tile
    // (16-byte chunk c of row r sits at chunk c ^ (r % 8)): S then reads
    // only K from shared memory, whose bandwidth the products share with
    // the TMA writes
    uint32_t qf[D / 16][4];
    // S = Q·K^T of tile j into sc, one wgmma group
    auto issue_s = [&](int j) {
      const uint32_t k_s = base + k_off(j % ST);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::Wgmma<BK>::template rs<0>(
            sc, qf[kk], hp::desc_kmajor(k_s + (kk / 4) * C::KV_BOX, kk % 4),
            kk > 0);
      hp::wgmma_commit();
    };
    // O += P·V of tile j, P from pf, one wgmma group
    auto issue_pv = [&](int j) {
      const uint32_t v_s = base + v_off(j % ST);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hp::Wgmma<D>::template rs<1>(acc, pf[kk],
                                     hp::desc_mnmajor(v_s, kk, C::KV_BOX), 1);
      hp::wgmma_commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
    };
    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2): while one's run on the tensor cores, the other
    // runs its softmax.  Warpgroup 1 lets warpgroup 0 go first; warpgroup
    // 0 takes warpgroup 1's last turn at the end, so that no arrival is
    // left over.  No wgmma sits in a branch: ptxas serialises wgmma around
    // a divergent path.
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) turn_pass();
    hp::bar_wait(&bar_q, 0);
    {
      const int row = 16 * w4 + lane % 16;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int chunk = (kk % 4) * 2 + lane / 16;
        repro::ldmatrix_x4(qf[kk], q_s + (kk / 4) * C::Q_BOX + row * 128 +
                                       ((chunk ^ (row % 8)) * 16));
      }
    }

    // Tile j's scores are computed while tile j - 1's P·V runs, and its
    // softmax runs while that product is still on the tensor cores.
    hp::bar_wait(&full_k[0], 0);
    turn_wait();
    hp::wgmma_fence();
    issue_s(0);
    turn_pass();
    hp::wgmma_wait<0>();
    hp::fence_regs(sc);
    hp::bar_arrive(&empty_k[0]);
    online_softmax<BK>(sc, m_r, l_r, alpha, k_begin, qw0, qrow0, t4, S,
                       causal, window, scale_log2);
    pack_p<BK>(sc, pf);
    for (int j = 1; j < n_kv; ++j) {
      const int s = j % ST, sp = (j - 1) % ST;       // tiles j, j - 1
      hp::bar_wait(&full_k[s], (j / ST) & 1);
      hp::bar_wait(&full_v[sp], ((j - 1) / ST) & 1);
      turn_wait();
      hp::wgmma_fence();
      issue_s(j);
      // O to tile j - 1's maxima while S of tile j runs
      rescale();
      hp::wgmma_fence();
      issue_pv(j - 1);
      turn_pass();
      if constexpr (C::EARLY_LOADS) {
        const int kt = j - 2 + ST, vt = j - 3 + ST;
        load_k(loader && kt >= ST && kt < n_kv, kt);
        load_v(loader && vt >= ST && vt < n_kv, vt);
      }
      hp::wgmma_wait<1>();                           // S of tile j is done
      hp::fence_regs(sc);
      hp::bar_arrive(&empty_k[s]);
      online_softmax<BK>(sc, m_r, l_r, alpha, k_begin + j * BK, qw0, qrow0,
                         t4, S, causal, window, scale_log2);
      hp::wgmma_wait<0>();                           // P·V of tile j - 1
      hp::fence_regs(acc);
      hp::fence_regs(pf);
      hp::bar_arrive(&empty_v[sp]);
      if constexpr (!C::EARLY_LOADS) {
        const int t = j - 1 + ST;
        if (loader && t < n_kv) {
          load_k(true, t);
          load_v(true, t);
        }
      }
      pack_p<BK>(sc, pf);
    }
    const int sl = (n_kv - 1) % ST;
    hp::bar_wait(&full_v[sl], ((n_kv - 1) / ST) & 1);
    turn_wait();
    rescale();
    hp::wgmma_fence();
    issue_pv(n_kv - 1);
    turn_pass();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (wg == 0) turn_wait();

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
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(og + row * o_ss + col) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv[r],
                                  acc[4 * n + 2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int S, const ll* st,
                   float scale_log2, int causal, int window, float* lse,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  int qp, kp, vp;
  if (!hp::attn_map(&qm, &qp, q, B, Hq, S, D, st[0], st[1], st[2], BQ) ||
      !hp::attn_map(&km, &kp, k, B, Hkv, S, D, st[3], st[4], st[5], C::BK) ||
      !hp::attn_map(&vm, &vp, v, B, Hkv, S, D, st[6], st[7], st[8], C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, C::SMEM, stream>>>(
      qm, km, vm, qp, kp, vp, static_cast<bf16*>(o), st[9], st[10], st[11],
      Hq / Hkv, S, scale_log2, causal, window, lse);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Hq, S, D), k/v: (B, Hkv, S, D), o: (B, Hq, S, D), all bf16 with unit
// stride on D and the given (batch, head, seq) strides, each a multiple of 8
// elements, and 16-byte aligned; lse: (B, Hq, S) fp32, contiguous, or null.
// Returns 0 or a CUDA error code; -1 for arguments the kernel does not take.
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
    err = launch<128>(q, k, v, o, B, Hq, Hkv, S, st, scale_log2, causal,
                      window, lse_f, s);
  else if (D == 64)    // zamba2-1.2b's shared block, granite-moe-3b-a800m
    err = launch<64>(q, k, v, o, B, Hq, Hkv, S, st, scale_log2, causal,
                     window, lse_f, s);
  else if (D == 192)   // nemotron-4-340b
    err = launch<192>(q, k, v, o, B, Hq, Hkv, S, st, scale_log2, causal,
                      window, lse_f, s);
  else
    return -1;         // the head dims of the repo's models only
  return static_cast<int>(err);
}
