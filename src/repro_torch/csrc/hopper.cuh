// Hopper building blocks of the grouped matmul (moe_gmm.cu), the flash
// attention forward and backward (flash_attention.cu,
// flash_attention_bwd.cu), the fused cross entropy (cross_entropy.cu) and
// the SSD scans (ssd_scan.cu, ssd_scan_wide.cu), as inline PTX for sm_90a:
//  * mbarrier: init, arrive, arrive with an expected transaction count, and
//    a wait on a phase's parity, which traps after 2^20 tries (seconds), so
//    that a lost arrival fails the launch instead of hanging the card;
//  * TMA tile loads (cp.async.bulk.tensor: 2-D, 3-D, and 4-D predicated)
//    that complete on an mbarrier, and the host-side encoding of their
//    tensor maps through the driver entry point (no -lcuda on the link
//    line);
//  * bulk copies of a run of bytes: loads into shared memory that complete
//    on an mbarrier (predicated), and stores from shared memory;
//  * the 4-D tensor map of an attention operand (B, H, S, D) read through
//    its strides, and its box loads;
//  * wgmma shared-memory matrix descriptors for tiles that TMA wrote with
//    the 128-byte swizzle, K-major and MN-major;
//  * TMA tile stores from shared memory (4-D, the attention-operand map),
//    predicated bulk-group commits and waits, a predicated global store;
//  * named barriers, stmatrix (plain and transposed) and the byte offset of
//    a chunk in a 128-byte-swizzled tile;
//  * wgmma.mma_async m64nNk16, bf16 in and fp32 accumulators, with both
//    operands in shared memory (ss: N 16, 32, 64, 72, 128, 256) or A in
//    registers (rs: N 64, 128, 192); fence, commit and wait.
//
// No setmaxnreg: ptxas (CUDA 12.9) allocates one register budget to every
// path of a kernel, the one its launch bounds allow (168 a thread at 384
// threads), whatever setmaxnreg.inc later claims; the consumers of a
// producer warpgroup never get more.  A kernel that needs more registers
// runs two warpgroups and lets one of their threads issue the loads.
//
// Layout of a TMA tile with the 128-byte swizzle: the box's inner dimension
// is 64 bf16 (128 bytes), so a tile of R rows and 64·c columns is c boxes,
// each R rows of 128 bytes; every 8 rows (1024 bytes) form one swizzle atom,
// and a box must start on a 1024-byte boundary.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace repro {
namespace hopper {

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; one thread calls it after its inits, before a
// __syncthreads.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0: waiting on parity 1 passes at once (the producer's first
// wait on an empty slot), on parity 0 blocks until the first completion.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  uint32_t tries = 0;
  while (!done) {
    if (++tries == (1u << 20)) __trap();      // a lost arrival: fail, not hang
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA loads: box at the given coordinates (innermost first) into shared
// memory; out-of-range elements are filled with zeros and counted in the
// transaction bytes like the others.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// the same, predicated: every thread of a warpgroup runs the call, only
// those with p set act.  A kernel whose wgmma must not sit in a branch
// (ptxas serialises wgmma around a divergent path) issues its loads so.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_wait_if(bool p, uint64_t* bar,
                                            uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred act, done;\n"
      "setp.ne.b32 act, %0, 0;\n"
      "@!act bra SKIP;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%1], %2;\n"
      "@!done bra WAIT;\n"
      "SKIP:\n"
      "}\n" ::"r"((int)p),
      "r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bar_arrive_tx_if(bool p, uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %2;\n}\n" ::"r"(
          (int)p),
      "r"(smem_addr(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d_if(bool p, void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               int c2, int c3) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%1], [%2, {%4, %5, %6, %7}], [%3];\n}\n" ::"r"(
          (int)p),
      "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// bulk copies (no tensor map): a run of bytes, 16-byte aligned at both ends
// and a multiple of 16 long.  Loads complete on an mbarrier, as TMA tile
// loads do; stores are tracked per thread in bulk groups.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bulk_load_if(bool p, void* dst,
                                             const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%1], [%2], %3, [%4];\n}\n" ::"r"((int)p),
      "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (TMA and bulk copies) before it reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A 4-D TMA tile store from shared memory (the box at the given
// coordinates, innermost first), tracked in this thread's bulk groups;
// elements outside the tensor are not written.  Predicated on p (see
// tma_load_4d_if).
__device__ __forceinline__ void tma_store_4d_if(bool p, const CUtensorMap* map,
                                                uint32_t src, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"((int)p),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The store of an attn_map box at (d, h, s, b), predicated on p; `perm` as
// in attn_load_box.
__device__ __forceinline__ void attn_store_box_if(bool p,
                                                  const CUtensorMap* map,
                                                  uint32_t src, int perm,
                                                  int d, int h, int s, int b) {
  const int ph = perm & 3, ps = (perm >> 2) & 3;
  const int c1 = ph == 1 ? h : ps == 1 ? s : b;
  const int c2 = ph == 2 ? h : ps == 2 ? s : b;
  const int c3 = ph == 3 ? h : ps == 3 ? s : b;
  tma_store_4d_if(p, map, src, d, c1, c2, c3);
}

// bulk_commit, bulk_wait_read and bulk_wait predicated on p.
__device__ __forceinline__ void bulk_commit_if(bool p) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act cp.async.bulk.commit_group;\n}\n" ::"r"((int)p)
      : "memory");
}

__device__ __forceinline__ void bulk_wait_read_if(bool p) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act cp.async.bulk.wait_group.read 0;\n}\n" ::"r"((int)p)
      : "memory");
}

__device__ __forceinline__ void bulk_wait_if(bool p) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act cp.async.bulk.wait_group 0;\n}\n" ::"r"((int)p)
      : "memory");
}

// Two floats to global memory, predicated on p: a store a kernel makes
// between wgmma groups without a branch.
__device__ __forceinline__ void st_global_v2_if(bool p, float* dst, float a,
                                                float b) {
  asm volatile(
      "{\n.reg .pred act;\nsetp.ne.b32 act, %0, 0;\n"
      "@act st.global.v2.f32 [%1], {%2, %3};\n}\n" ::"r"((int)p),
      "l"(dst), "f"(a), "f"(b)
      : "memory");
}

// ---------------------------------------------------------------------------
// named barriers (ids 1..15; 0 is __syncthreads) and stmatrix
// ---------------------------------------------------------------------------

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Four 8x8 bf16 matrices from the m16n8 fragment layout (register i: row
// lane/4, columns 2·(lane%4) and + 1 of matrix i) into shared memory; lanes
// 8i .. 8i + 7 give the addresses of matrix i's rows.  .trans stores each
// matrix transposed: row r in memory holds column r of the fragment.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// Byte offset of the 16-byte chunk `chunk` of row `row` in a tile written
// with the 128-byte swizzle (rows of 128 bytes, 8-row atoms).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// Wait until this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma descriptors for 128-byte-swizzled tiles
// ---------------------------------------------------------------------------

// addr: the shared-memory byte address of the operand's first element;
// lbo, sbo: leading and stride byte offsets (multiples of 16).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;                     // 128-byte swizzle
  return d;
}

// K-major operand (K contiguous): rows of 128 bytes, 64 K values each, 8
// rows an atom.  The k16 step kk of a 64-deep box starts 32·kk bytes into
// the row; the hardware applies the swizzle to the address it forms.  The
// next 8 rows are 1024 bytes on (SBO); LBO is not used with this swizzle.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t box, int kk) {
  return make_desc(box + 32 * kk, 16, 1024);
}

// MN-major operand (M or N contiguous): each box holds `rows` K values of
// 64 MN values.  The k16 step kk starts 16 rows (2048 bytes) on; the next
// 8 K rows are 1024 bytes on (SBO), and the next 64 MN values are the next
// box, `box_bytes` on (LBO).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t box, int kk,
                                                 uint32_t box_bytes) {
  return make_desc(box + 2048 * kk, box_bytes, 1024);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma reads its register operands and writes its accumulators
// asynchronously; the compiler sees both happen where the instruction is
// issued.  This empty asm, placed after wgmma_wait, pins every later access
// to those registers (and any reuse of a register A operand's registers)
// after the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// D (64 x N, fp32) (+)= A (64 x 16, bf16) · B (16 x N, bf16).  ss: A and B
// from shared-memory descriptors, TA / TB = 1 for an MN-major operand; rs:
// A from four registers a thread (the m16n8k16 A fragment of the thread's
// warp, rows 16·warp .. + 15), B from a descriptor.  acc = 0 overwrites D.
// Only the shapes the kernels use: ss at N 16 and 256 (moe_gmm, cross
// entropy), 32 (ssd_scan: half of c·b^T), 64 (flash backward: S^T = K·Q^T
// and dP^T = V·dO^T over 64 queries; the SSD scans), 72 (ssd_scan_wide's
// last P tile) and 128 (flash backward: S = Q·K^T and dP = dO·V^T over 128
// keys); rs at N 64, 128 and 192 (flash forward: Q·K^T at 64 and 128 keys,
// P·V at D 64 / 128 / 192; flash backward: P^T·dO, dS^T·Q and dS·K at D
// 128; ssd_scan: M·x and the state update).
// D's layout: warp w of the warpgroup holds rows 16w + lane/4 (registers
// 4j, 4j+1) and 16w + lane/4 + 8 (4j+2, 4j+3), columns 8j + 2·(lane%4) + {0,1}.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }

  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
};

template <>
struct Wgmma<72> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[36], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, %39, %40;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }

  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
};

template <>
struct Wgmma<192> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[96],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
          "n"(TB));
  }
};

template <>
struct Wgmma<256> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, fetched
// once; null if the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// The card's SM count, read once (a persistent grid's size).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// A bf16 tensor map of `rank` dimensions, innermost first: dims[i]
// elements, byte strides of dims 1.. (dim 0 is contiguous), a box of
// box[i] elements (box[0] = 64, 128 bytes), the 128-byte swizzle and zeros
// outside the tensor.  Returns false if the driver refuses it.
//
// cuTensorMapEncodeTiled needs a current context.  A launch can be the
// first CUDA call of its thread (autograd runs a backward on a thread of
// its own), where none is current and the encoding fails with
// CUDA_ERROR_INVALID_CONTEXT: cudaSetDevice makes the device's primary
// context current on this thread first.
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// attention operands: a (B, H, S, D) bf16 tensor read through its strides
// ---------------------------------------------------------------------------

// A 4-D map of a (B, H, S, D) bf16 tensor with unit stride on D and element
// strides sb, sh, ss: dimension 0 is D, dimensions 1..3 are h, s and b in
// the order of their strides; the box is 64 x (1 head, `rows` positions, 1
// batch).  Returns the map dimension of h, s and b in `perm`.
inline bool attn_map(CUtensorMap* map, int* perm, const void* ptr, int B,
                     int H, int S, int D, long long sb, long long sh,
                     long long ss, int rows) {
  struct Dim {
    long long stride;
    int size, box, role;                      // role: 0 h, 1 s, 2 b
  } dims[3] = {{sh, H, 1, 0}, {ss, S, rows, 1}, {sb, B, 1, 2}};
  std::stable_sort(dims, dims + 3, [](const Dim& a, const Dim& c) {
    return a.stride < c.stride;
  });
  cuuint64_t gd[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t gs[3];
  cuuint32_t box[4] = {64, 0, 0, 0};
  *perm = 0;
  for (int i = 0; i < 3; ++i) {
    gd[i + 1] = (cuuint64_t)dims[i].size;
    gs[i] = (cuuint64_t)dims[i].stride * 2;
    box[i + 1] = (cuuint32_t)dims[i].box;
    *perm |= (i + 1) << (2 * dims[i].role);
  }
  return encode_bf16(map, ptr, 4, gd, gs, box);
}

// The box of an attn_map at (d, h, s, b), predicated on p: `perm` holds the
// map dimension (1..3) of h, s and b in bits 0-1, 2-3 and 4-5.
__device__ __forceinline__ void attn_load_box(bool p, void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int perm, int d,
                                              int h, int s, int b) {
  const int ph = perm & 3, ps = (perm >> 2) & 3;
  const int c1 = ph == 1 ? h : ps == 1 ? s : b;
  const int c2 = ph == 2 ? h : ps == 2 ? s : b;
  const int c3 = ph == 3 ? h : ps == 3 ? s : b;
  tma_load_4d_if(p, dst, map, bar, d, c1, c2, c3);
}

}  // namespace hopper
}  // namespace repro
