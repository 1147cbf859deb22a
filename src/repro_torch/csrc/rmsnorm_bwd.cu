// RMSNorm backward for Hopper: the gradient of y = x·rsqrt(mean(x²) + eps)·w
// with respect to x and w.  With r = rsqrt(mean(x²) + eps), x̂ = x·r and
// g = dy·w:
//   dx = r·(g − x̂·mean(g·x̂)), in x's dtype;
//   dw = Σ_rows dy·x̂, fp32.
//
// Replaces: no Pallas counterpart.  The JAX package cannot differentiate
// through src/repro/kernels/rmsnorm/kernel.py:35 rmsnorm_pallas (pallas_call
// has no reverse-mode rule and the kernel no custom_vjp); this computes the
// gradient of repro.kernels.rmsnorm.ref.rmsnorm_ref, as the plain version
// kernels/rmsnorm/ref.py:rmsnorm_bwd_ref does.
//
// What bounds it on the H100: bytes.  It reads x and dy and writes dx; w and
// the dw partials are a few MB beside them.  At the training path's shape
// (8192, 3584) bf16 that is 176 MB: 52.6 us at 3.35 TB/s.  A Triton design
// (one row at a time a program, two programs an SM) ran at 0.48 of that
// bound: a row's loads were issued only after the previous row's arithmetic
// and store, so an SM had at most two rows' bytes in flight, and the
// power-of-two block masked 512 of 4096 lanes at D 3584.
//
// Design (the bulk path, rows whose bytes and starts are 16-byte aligned):
//  * a persistent grid: two blocks an SM where a thread takes one vector of
//    the row (the launch bounds fit two), else one.  Block b takes rows b,
//    b + grid, b + 2·grid, ..., so the blocks sweep x, dy and dx together
//    (it ran faster than contiguous runs of rows a block on the H100).  The
//    host picks the grid, the threads and the ring depth
//    (kernels/rmsnorm/kernel.py rmsnorm_bwd_launch_args);
//  * x and dy rows arrive by bulk copies (cp.async.bulk, one for each whole
//    row) into a ring of `stages` slots in shared memory, completing on one
//    mbarrier a slot.  The depth is set per row width and blocks an SM: 2
//    slots at two blocks an SM (4 rows an SM in flight or in hand), up to 4
//    at one block, as many as fit beside w's fp32 copy (chip_smoke.py's
//    kernel phase times the other launches at D 3584);
//  * each thread owns VPT 16-byte column vectors of the row (D 3584 bf16 is
//    exactly 448 threads x 8 bf16, VPT 1).  One pass over them forms both
//    row sums, x·x and g·x (mean(g·x̂) = r·mean(g·x)), and one block-wide
//    reduction combines the pair: a shuffle tree in each warp, then the
//    warps in order, so every thread holds the same sums.  The reduction's
//    buffer alternates between two halves by row, so one barrier a row
//    suffices;
//  * that barrier also frees a slot, which thread 0 refills with the row
//    `stages` ahead.  At VPT 1 or 2 a thread keeps its vectors of the row
//    and of w in registers, so the row's own slot is free; at VPT 4 or 8
//    (rows of more than 1024 vectors) the second pass reads the slot and
//    w's copy in shared memory again, and the previous row's slot is free;
//  * the second pass forms dx, stored as 16-byte vectors, and adds dy·x̂ to
//    the thread's dw partial in fp32 registers;
//  * each block writes its dw partial once; rms_dw_sum_kernel sums the
//    partials in a fixed order (8 warps, each a fixed residue of the
//    blocks, then the 8 in order), so dw is bit-for-bit deterministic with
//    no atomics.  It is launched as a programmatic dependent launch, so its
//    launch overlaps the end of the partials' grid.
// Rows the bulk path cannot take (a byte length or start that is not 16-byte
// aligned, or x and dy that do not fit a 2-slot ring in 227 KB beside w) go
// through rms_bwd_rows_kernel: the same partition, sums and order, with the
// row taken in column chunks by plain element loads, and each thread's dw
// partial kept in the block's row of the partials (the same thread reads and
// writes the same columns, so it needs no atomics either).
#include "hopper.cuh"

#include <cuda_fp16.h>
#include <math.h>

namespace {

using ll = long long;
namespace hp = repro::hopper;

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_STAGES = 16;
// shared memory ahead of w: the slots' mbarriers (128 bytes), then the two
// halves of the row-sum buffer (a pair of floats a warp in each)
constexpr int HEAD_BYTES = 128 + 2 * MAX_WARPS * 2 * 4;
constexpr int SMEM_LIMIT = 232448;            // 227 KB, a block's opt-in
constexpr int SUM_WARPS = 8;                  // warps of rms_dw_sum_kernel


// element types by the host's code: 0 fp32, 1 bf16, 2 fp16
template <int KIND>
struct Elem;
template <>
struct Elem<0> {
  using T = float;
};
template <>
struct Elem<1> {
  using T = __nv_bfloat16;
};
template <>
struct Elem<2> {
  using T = __half;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);                 // round to nearest even
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

template <typename T>
__device__ __forceinline__ void store_vec(unsigned char* p,
                                          const float (&v)[16 / sizeof(T)]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The pair (a, b) summed over the block in a fixed order: a shuffle tree in
// each warp, lane 0's results written to `buf`, then the warps in order,
// read by every thread (so all hold the same sums).  One barrier: the caller
// alternates between two buffers by row, and a warp can write this buffer
// again only after every warp has passed the next row's barrier, which
// follows its reads here.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    reinterpret_cast<float2*>(buf)[warp] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  const int n_warps = blockDim.x >> 5;
  for (int i = 0; i < n_warps; ++i) {
    const float2 t = reinterpret_cast<const float2*>(buf)[i];
    s.x += t.x;
    s.y += t.y;
  }
  return s;
}

// Four floats of w from shared memory (16-byte aligned).
template <int PV>
__device__ __forceinline__ void load_w(const float* p, float (&v)[PV]) {
#pragma unroll
  for (int e = 0; e < PV; e += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + e);
    v[e] = t.x;
    v[e + 1] = t.y;
    v[e + 2] = t.z;
    v[e + 3] = t.w;
  }
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&v)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = to_f(e[i]);
}

// The bulk path: see the header.  Strides are in bytes.  With VPT <= 2 a
// thread keeps its vectors of the row (as loaded, 4 registers each) and of
// w (fp32) in registers, so a row's slot is free once the row's sums are
// formed: the barrier of row i frees row i's own slot.  With VPT 4 or 8 the
// second pass reads the slot and w's copy in shared memory again, and the
// barrier of row i frees row i - 1's slot.
template <int KIND, int VPT>
__global__ void __launch_bounds__(MAX_THREADS, VPT == 1 ? 2 : 1)
    rms_bwd_ring_kernel(const unsigned char* __restrict__ x,
                        const float* __restrict__ w,
                        const unsigned char* __restrict__ dy,
                        unsigned char* __restrict__ dx,
                        float* __restrict__ partial, int rows, int D, ll sx,
                        ll sdy, ll sdx, float eps, int stages) {
  using T = typename Elem<KIND>::T;
  constexpr int PV = 16 / sizeof(T);           // elements a vector
  constexpr bool HOLD = VPT <= 2;
  constexpr int HV = HOLD ? VPT : 1;           // vectors held in registers
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sums = reinterpret_cast<float*>(smem + 128);
  float* ws = reinterpret_cast<float*>(smem + HEAD_BYTES);
  unsigned char* ring = smem + HEAD_BYTES + (size_t)D * 4;
  const uint32_t row_bytes = (uint32_t)D * sizeof(T);
  const int n_vec = D / PV;
  const float inv_d = 1.f / (float)D;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x, rstep = gridDim.x;   // rows r0 + i·rstep
  const int n = (rows - r0 + rstep - 1) / rstep;
  if (n <= 0) return;                          // the whole block alike

  // row i of the block's run into its slot (thread 0 only)
  auto issue = [&](int i) {
    const int s = i % stages;
    const ll row = r0 + (ll)i * rstep;
    unsigned char* slot = ring + (size_t)s * 2 * row_bytes;
    hp::bar_arrive_tx(&bars[s], 2 * row_bytes);
    hp::bulk_load_if(true, slot, x + row * sx, row_bytes, &bars[s]);
    hp::bulk_load_if(true, slot + row_bytes, dy + row * sdy, row_bytes,
                     &bars[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hp::bar_init(&bars[s], 1);
    hp::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(stages, n); ++i) issue(i);
  for (int c = tid * 4; c < D; c += blockDim.x * 4)
    *reinterpret_cast<float4*>(ws + c) =
        *reinterpret_cast<const float4*>(w + c);
  float acc[VPT][PV];
  float wr[HV][PV];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int e = 0; e < PV; ++e) acc[k][e] = 0.f;
  __syncthreads();                             // w's copy is complete
  if (HOLD) {
#pragma unroll
    for (int k = 0; k < HV; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < n_vec) load_w<PV>(ws + v * PV, wr[k]);
    }
  }

  for (int i = 0; i < n; ++i) {
    const int s = i % stages;
    hp::bar_wait(&bars[s], (uint32_t)(i / stages) & 1u);
    const unsigned char* xs = ring + (size_t)s * 2 * row_bytes;
    const unsigned char* ds = xs + row_bytes;
    uint4 xraw[HV], draw[HV];
    float s1 = 0.f, s2 = 0.f;                  // Σ x·x, Σ g·x
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < n_vec) {
        const uint4 xr = *reinterpret_cast<const uint4*>(xs + v * 16);
        const uint4 dr = *reinterpret_cast<const uint4*>(ds + v * 16);
        float xv[PV], dv[PV], wv[PV];
        unpack<T>(xr, xv);
        unpack<T>(dr, dv);
        if (HOLD) {
          xraw[HOLD ? k : 0] = xr;
          draw[HOLD ? k : 0] = dr;
#pragma unroll
          for (int e = 0; e < PV; ++e) wv[e] = wr[HOLD ? k : 0][e];
        } else {
          load_w<PV>(ws + v * PV, wv);
        }
#pragma unroll
        for (int e = 0; e < PV; ++e) {
          s1 = fmaf(xv[e], xv[e], s1);
          s2 = fmaf(dv[e] * wv[e], xv[e], s2);
        }
      }
    }
    const float2 tot = block_sum2(s1, s2, sums + (i & 1) * 2 * MAX_WARPS);
    // every thread is past its reads of row `done`: its slot takes the row
    // `stages` after it
    const int done = HOLD ? i : i - 1;
    if (tid == 0 && done >= 0 && done + stages < n) issue(done + stages);
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float c = r * (tot.y * inv_d);       // mean(g·x̂)
    unsigned char* out = dx + (r0 + (ll)i * rstep) * sdx;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = tid + k * blockDim.x;
      if (v < n_vec) {
        float xv[PV], dv[PV], wv[PV], o[PV];
        if (HOLD) {
          unpack<T>(xraw[HOLD ? k : 0], xv);
          unpack<T>(draw[HOLD ? k : 0], dv);
#pragma unroll
          for (int e = 0; e < PV; ++e) wv[e] = wr[HOLD ? k : 0][e];
        } else {
          unpack<T>(*reinterpret_cast<const uint4*>(xs + v * 16), xv);
          unpack<T>(*reinterpret_cast<const uint4*>(ds + v * 16), dv);
          load_w<PV>(ws + v * PV, wv);
        }
#pragma unroll
        for (int e = 0; e < PV; ++e) {
          const float xh = xv[e] * r;
          o[e] = (dv[e] * wv[e] - xh * c) * r;
          acc[k][e] = fmaf(dv[e], xh, acc[k][e]);
        }
        store_vec<T>(out + v * 16, o);
      }
    }
  }
  float* part = partial + (ll)blockIdx.x * D;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int v = tid + k * blockDim.x;
    if (v < n_vec)
#pragma unroll
      for (int e = 0; e < PV; e += 4)
        *reinterpret_cast<float4*>(part + v * PV + e) = make_float4(
            acc[k][e], acc[k][e + 1], acc[k][e + 2], acc[k][e + 3]);
  }
  // the dw sum may launch now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The second path: any row length and alignment, D up to 65,536.  The same
// row partition, sums and orders as the bulk path; the row is read by plain
// element loads in column chunks of blockDim.x, twice (the second read
// mostly from L2), and each thread's dw partial lives in the block's row of
// `partial`.  Strides are in bytes.
template <int KIND>
__global__ void __launch_bounds__(MAX_THREADS)
    rms_bwd_rows_kernel(const unsigned char* __restrict__ x,
                        const float* __restrict__ w,
                        const unsigned char* __restrict__ dy,
                        unsigned char* __restrict__ dx,
                        float* __restrict__ partial, int rows, int D, ll sx,
                        ll sdy, ll sdx, float eps) {
  using T = typename Elem<KIND>::T;
  __shared__ __align__(16) float sums[2 * 2 * MAX_WARPS];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x, rstep = gridDim.x;   // rows r0 + i·rstep
  const int n = (rows - r0 + rstep - 1) / rstep;
  if (n <= 0) return;
  float* part = partial + (ll)blockIdx.x * D;
  const float inv_d = 1.f / (float)D;
  for (int i = 0; i < n; ++i) {
    const ll row = r0 + (ll)i * rstep;
    const T* xr = reinterpret_cast<const T*>(x + row * sx);
    const T* dyr = reinterpret_cast<const T*>(dy + row * sdy);
    T* dxr = reinterpret_cast<T*>(dx + row * sdx);
    float s1 = 0.f, s2 = 0.f;                  // Σ x·x, Σ g·x
    for (int c = tid; c < D; c += blockDim.x) {
      const float xv = to_f(xr[c]);
      s1 = fmaf(xv, xv, s1);
      s2 = fmaf(to_f(dyr[c]) * w[c], xv, s2);
    }
    const float2 tot = block_sum2(s1, s2, sums + (i & 1) * 2 * MAX_WARPS);
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float cm = r * (tot.y * inv_d);
    for (int c = tid; c < D; c += blockDim.x) {
      const float xh = to_f(xr[c]) * r;
      const float dv = to_f(dyr[c]);
      dxr[c] = from_f<T>((dv * w[c] - xh * cm) * r);
      part[c] = i == 0 ? dv * xh : fmaf(dv, xh, part[c]);
    }
  }
}

// dw[c] = Σ_b partial[b][c] over the n_part blocks' partials in a fixed
// order: warp k sums the blocks b ≡ k (mod 8) in increasing b, then the 8
// warps' sums are added in order.  A block takes 32 columns.
__global__ void __launch_bounds__(SUM_WARPS * 32)
    rms_dw_sum_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int n_part, int D) {
  __shared__ float warp_sums[SUM_WARPS][32];
  // launched before the partials' grid ends (programmatic dependent
  // launch): wait for it to complete and its stores to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < D)
    for (int b = warp; b < n_part; b += SUM_WARPS)
      s += partial[(ll)b * D + c];
  warp_sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < SUM_WARPS; ++k) t += warp_sums[k][lane];
    dw[c] = t;
  }
}

template <int KIND, int VPT>
cudaError_t launch_ring(const void* x, const void* w, const void* dy,
                        void* dx, float* partial, int rows, int D, ll sx,
                        ll sdy, ll sdx, float eps, int grid, int threads,
                        int stages, int smem, cudaStream_t s) {
  auto kernel = rms_bwd_ring_kernel<KIND, VPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const unsigned char*>(x), static_cast<const float*>(w),
      static_cast<const unsigned char*>(dy),
      static_cast<unsigned char*>(dx), partial, rows, D, sx, sdy, sdx, eps,
      stages);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx,
                   float* partial, int rows, int D, ll sx, ll sdy, ll sdx,
                   float eps, int path, int grid, int threads, int vpt,
                   int stages, int smem, cudaStream_t s) {
  if (path == 0) {
    rms_bwd_rows_kernel<KIND><<<grid, threads, 0, s>>>(
        static_cast<const unsigned char*>(x), static_cast<const float*>(w),
        static_cast<const unsigned char*>(dy),
        static_cast<unsigned char*>(dx), partial, rows, D, sx, sdy, sdx,
        eps);
    return cudaGetLastError();
  }
  switch (vpt) {
    case 1:
      return launch_ring<KIND, 1>(x, w, dy, dx, partial, rows, D, sx, sdy,
                                  sdx, eps, grid, threads, stages, smem, s);
    case 2:
      return launch_ring<KIND, 2>(x, w, dy, dx, partial, rows, D, sx, sdy,
                                  sdx, eps, grid, threads, stages, smem, s);
    case 4:
      return launch_ring<KIND, 4>(x, w, dy, dx, partial, rows, D, sx, sdy,
                                  sdx, eps, grid, threads, stages, smem, s);
    default:
      return launch_ring<KIND, 8>(x, w, dy, dx, partial, rows, D, sx, sdy,
                                  sdx, eps, grid, threads, stages, smem, s);
  }
}

}  // namespace

// x, dy: (rows, D) with unit column stride and row strides sx, sdy (in
// elements); dx: (rows, D) with row stride sdx; w: (D,) fp32 contiguous;
// dw: (D,) fp32; partial: (grid, D) fp32 scratch.  kind: 0 fp32, 1 bf16,
// 2 fp16.  path 1 is the bulk path (threads x vpt 16-byte vectors cover a
// row, `stages` slots, `smem` dynamic shared bytes), path 0 the second
// path.  Block b takes rows b, b + grid, b + 2·grid, ...  The host picks
// these (kernels/rmsnorm/kernel.py rmsnorm_bwd_launch_args); this checks
// them.  Returns 0 or a CUDA error code; -1 for arguments the
// kernel does not take.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* partial, int rows, int D,
                           ll sx, ll sdy, ll sdx, float eps, int kind,
                           int path, int grid, int threads, int vpt,
                           int stages, int smem, void* stream) {
  if (rows <= 0 || D <= 0 || D > 65536 || kind < 0 || kind > 2) return -1;
  if (grid <= 0 || grid > rows) return -1;     // every block takes a row
  if (threads < 32 || threads > MAX_THREADS || threads % 32) return -1;
  const ll es = kind == 0 ? 4 : 2;
  if (path == 1) {
    const ll row_bytes = D * es;
    const ll pv = 16 / es;
    if (row_bytes % 16 || (ll)threads * vpt * pv < D) return -1;
    if (vpt != 1 && vpt != 2 && vpt != 4 && vpt != 8) return -1;
    if ((sx * es) % 16 || (sdy * es) % 16 || (sdx * es) % 16) return -1;
    if (reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(dy) % 16 ||
        reinterpret_cast<uintptr_t>(dx) % 16 ||
        reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(partial) % 16)
      return -1;
    if (stages < 2 || stages > MAX_STAGES) return -1;
    if (smem != HEAD_BYTES + 4 * D + stages * 2 * row_bytes ||
        smem > SMEM_LIMIT)
      return -1;
  } else if (path != 0) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  sx *= es;
  sdy *= es;
  sdx *= es;
  cudaError_t err;
  if (kind == 0)
    err = launch<0>(x, w, dy, dx, part, rows, D, sx, sdy, sdx, eps, path,
                    grid, threads, vpt, stages, smem, s);
  else if (kind == 1)
    err = launch<1>(x, w, dy, dx, part, rows, D, sx, sdy, sdx, eps, path,
                    grid, threads, vpt, stages, smem, s);
  else
    err = launch<2>(x, w, dy, dx, part, rows, D, sx, sdy, sdx, eps, path,
                    grid, threads, vpt, stages, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // programmatic dependent launch: the sum's launch overlaps the end of the
  // partials' grid
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + 31) / 32);
  cfg.blockDim = dim3(SUM_WARPS * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rms_dw_sum_kernel, (const float*)part,
                           static_cast<float*>(dw), grid, D);
  return static_cast<int>(err);
}
