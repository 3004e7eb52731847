// Int8 post-training-quantized convolutions of the serving path, for Hopper
// (sm_90a): the activation quantizer and an implicit-GEMM s8 x s8 -> s32
// convolution with the dequantization in its epilogue.
//
// The JAX package runs these as XLA ops (mcgm_tpu/ops/layers.py:104
// _quantize_sym, :113 _int8_conv, :135 _int8_apply: no Pallas source); the
// math here is theirs to the bit:
//
//   scale   = max(amax, 1e-8) / 127                      (a true division)
//   q       = clip(rint(x / scale), -127, 127)           (round half to even)
//   acc     = sum q_x q_w                                (exact, int32)
//   out     = bf16_or_f32(float(acc) * (wscale[n] * xscale[b])) + bias[n]
//
// the product of the scales first, the rounding to the output dtype, then
// the bias added in that dtype (__fmul_rn / __fadd_rn, never contracted).
//
// int8_quantize: x [B, E] (f32 or bf16, E = H W C of one NHWC example) ->
// q [B, E] int8 and scale [B] f32, one launch a call. Dynamic mode (amax
// each example's max |x|) picks one of three kernels by the example's size
// (kernels/int8.py::quantize_plan): `cluster`, a thread-block cluster of up
// to 8 blocks per example, each block holding its slice of x in shared
// memory (16-byte loads, x read from device memory once), its amax combined
// with the cluster's over distributed shared memory, then its slice rounded
// and written with 16-byte stores; `stream`, the same cluster reading its
// slice twice from device memory, for examples too large for the cluster's
// shared memory or not 16-byte aligned; `rows`, one warp per example
// (E <= 1024, a Dense input), its values in registers. Static mode (amax
// one scalar read from the device, a calibrated act_amax) is the rounding
// alone, 16 elements a thread.
//
// int8_conv: x [B, H, W, C] int8 (NHWC), w [N, K] int8 packed at export,
// row n holding the taps of output channel n in the order the layout reads
// them, channel fastest; out [B, Ho, Wo, N] (NHWC) f32 or bf16.
// - direct: kh x kw taps, stride 1, zero padding `pad` on every side; K =
//   kh kw C, tap t = dy kw + dx. 3x3 pad 1, 1x1, and a Dense as a 1x1 conv
//   on a 1x1 image.
// - up2: the four output parities (a, b) of a 2H x 2W result of a 4x4
//   kernel W4 applied to x dilated by 2 with padding 2 (lax's lhs_dilation
//   form: UpsampledConv's composite kernel and ConvTranspose k4 s2 p1). Output
//   (2i + a, 2j + b) meets x only at taps u = a + 2 du, v = b + 2 dv, du, dv
//   in {0, 1}, reading x[i + du + a - 1, j + dv + b - 1]: the other 12 taps
//   meet the inserted zeros, so these integer sums are the dilated conv's.
//   K = 16 C, phase-major: row n is [a][b][du][dv][c], and phase (a, b)
//   reads its 4 C-long slice. The kernels write the interleaved output.
//
// Bound on an H100 SXM: at the GAN's 3x3 256 -> 256 at 32 px and B = 1,000
// the 1.16 T int8 operations that read the input take 0.585 ms at 1,979
// TOP/s, the 0.79 GB of x, w and the bf16 output 0.24 ms at 3.35 TB/s: the
// operations bound it; the 1x1s, the Dense layers and the 3-channel head are
// bound by their bytes. The quantizer is bound by its bytes (x read once, q
// written once: 0.235 ms at Conv_1's input).
//
// The conv's three kernels (the entry point takes the variant that
// kernels/int8.py::conv_plan names, and checks it):
// - wide (C % 16 == 0, N > 8): TMA + s8 wgmma, warp-specialised and
//   persistent. A tile is 128 output pixels x BN channels (BN 256, 128 or
//   64 by N): the pixels are a box of (bw x bh x bb) positions x columns x
//   examples of one phase, so that every tap of the implicit GEMM is one
//   4-D TMA box of x [B, H, W, C] at coordinates shifted by the tap (zeros
//   where it leaves the tensor: the padding costs nothing) and one 3-D box
//   of w viewed as [N, taps, C], both in the swizzle of the chunk's width
//   (kc = 128, 64 or 32 channel bytes, K-major, as 8-bit wgmma requires).
//   One producer warp (its warpgroup at 40 registers, setmaxnreg) keeps a
//   ring of 4-8 stages full; two consumer warpgroups (232 registers) each
//   run m64nBNk32 on their 64 rows, the previous stage released once its
//   product is done. Up2 tiles run their four phases in turn, so a block
//   writes all of its input tile's interleaved outputs. The epilogue
//   dequantizes the accumulators in place, then stages the tile's rows 64
//   bf16 (32 f32) channels at a time in the 128-byte swizzle, and one
//   thread stores each slice by TMA (out viewed as [B, Ho, Wo, N], or, up2,
//   [B, H, 2, W, 2 N] so a phase's pixels are one box; clipped at the
//   edges), two buffers in turn: the stores run during the next slice and
//   the next tile's products. The tile spans N = 256 so x is read once: (A
//   128 x 128 tile for each consumer warpgroup, alternating on the tensor
//   cores so one's epilogue ran during the other's products, read a third
//   more from L2 and was slower.)
// - narrow (C % 16 == 0, N <= 8: the VAE's 3-channel head): a tile of 256
//   pixels (two m64 blocks per consumer warpgroup), all of w resident in
//   shared memory as one B tile per shift of x and chunk, 8 rows per phase
//   (phase p's tap of that shift, zeros where p does not read it), so each
//   of the 9 shifted boxes of x (up2; kh kw for direct) is loaded once per
//   tile and one m64n32k32 (n8 direct) multiplies it into every phase; two
//   chunks' products in flight. The tile's output (dense for up2: the four
//   phases interleaved) is staged whole in the output dtype and leaves as
//   contiguous rows, 16 bytes a thread where they span the output's width.
// - bytes (C % 16 != 0, where TMA cannot take x's or w's rows; an output
//   row that is not a multiple of 16 bytes, or, up2, N not a multiple of a
//   store box's channels, where the wide kernel's TMA stores cannot take
//   it; or an operand not 16-byte aligned: the embedding of a one-hot): an
//   mma.sync.m16n8k32 kernel, 128 x 128 tiles, operands staged byte by byte.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

// The phase probe (python -m mcgm_tpu_torch.bench.int8_conv_phases) builds
// this file with -DINT8_CONV_PHASES: at each PHASE(k) the first thread of a
// warpgroup of the TMA kernels adds the SM cycles since its last mark to
// phase k's total of its warpgroup, g_phase[k + 8 warpgroup], which
// mcgm_int8_conv_phases reads and clears. Without the macro the marks are
// empty.
#ifdef INT8_CONV_PHASES
__device__ unsigned long long g_phase[24];
#define PHASE_START long long phase_mark = clock64()
#define PHASE(k)                                                       \
  if ((threadIdx.x & 127) == 0) {                                      \
    const long long now = clock64();                                   \
    atomicAdd(&g_phase[(k) + 8 * (threadIdx.x >> 7)],                  \
              (unsigned long long)(now - phase_mark));                 \
    phase_mark = now;                                                  \
  }
#else
#define PHASE_START
#define PHASE(k)
#endif

namespace cg = cooperative_groups;

namespace {

enum { kDirect = 0, kUp2 = 1 };
enum { kF32 = 0, kBF16 = 1 };
enum { kBytes = 0, kWide = 1, kNarrow = 2 };            // int8_conv variants
enum { kStatic = 0, kRows = 1, kCluster = 2, kStream = 3 };  // int8_quantize variants

constexpr int kSmemMax = 232448;
constexpr int kMaxStages = 8;

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// max / min that give NaN where either value is NaN, as torch's amax and
// clamp do (fmaxf / fminf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (a NaN reaches the conversion to int8 as in the plain version)
__device__ __forceinline__ int8_t quant1(float v, float s) {
  return (int8_t)min_nan(max_nan(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(max_nan(amax, 1e-8f), 127.f);
}

// ---------------------------------------------------------------- quantize
constexpr int kQThreads = 512;   // cluster and stream kernels
constexpr int kRowsWarps = 8;    // rows kernel: examples (warps) per block
constexpr int kRowsMaxE = 1024;  // rows kernel: 32 values a lane

// the 16 values of 16 consecutive elements (16-byte aligned)
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ uint4 quant16(const float (&v)[16], float s) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t r = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) r |= (uint32_t)(uint8_t)quant1(v[4 * i + j], s) << (8 * j);
    w[i] = r;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// max |v| of the elements of a 16-byte vector
__device__ __forceinline__ float absmax(const uint4& u, const float*) {
  const float* f = reinterpret_cast<const float*>(&u);
  return max_nan(max_nan(fabsf(f[0]), fabsf(f[1])), max_nan(fabsf(f[2]), fabsf(f[3])));
}
__device__ __forceinline__ float absmax(const uint4& u, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    m = max_nan(m, max_nan(fabsf(f.x), fabsf(f.y)));
  }
  return m;
}

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The block's max of m (every thread's), returned to every thread.
__device__ __forceinline__ float block_max(float m, float* red) {
  for (int o = 16; o; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = max_nan(m, red[w]);
  return m;
}

// The cluster's max of each block's `mine` (in its shared memory).
__device__ __forceinline__ float cluster_max(cg::cluster_group& cl, float* mine) {
  cl.sync();  // every block's max is written
  float m = 0.f;
  for (unsigned r = 0; r < cl.num_blocks(); ++r) m = max_nan(m, *cl.map_shared_rank(mine, r));
  cl.sync();  // every block has read them: a block may now exit
  return m;
}

// cluster: block rank r of example blockIdx.y holds x[b, r slice ..) in
// shared memory. E and slice are multiples of 16, x 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
int8_quantize_kernel_cluster(const T* __restrict__ x, long long E, long long slice,
                             int8_t* __restrict__ q, float* __restrict__ scale) {
  extern __shared__ __align__(16) unsigned char qsmem[];
  __shared__ float red[kQThreads / 32];
  __shared__ float mine;
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank(), b = blockIdx.y, tid = threadIdx.x;
  const long long lo = (long long)r * slice;
  const long long n = max(0LL, min(E, lo + slice) - lo);
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte vector
  const uint4* src = reinterpret_cast<const uint4*>(x + (long long)b * E + lo);
  uint4* held = reinterpret_cast<uint4*>(qsmem);
  float m = 0.f;
#pragma unroll 4
  for (long long i = tid; i < n / kV; i += kQThreads) {
    const uint4 v = ld_stream(src + i);
    held[i] = v;
    m = max_nan(m, absmax(v, (const T*)nullptr));
  }
  m = block_max(m, red);
  if (tid == 0) mine = m;
  const float s = scale_of(cluster_max(cl, &mine));  // its syncs order `held` too
  if (r == 0 && tid == 0) scale[b] = s;
  const T* xs = reinterpret_cast<const T*>(qsmem);
  uint4* dst = reinterpret_cast<uint4*>(q + (long long)b * E + lo);
  for (long long i = tid; i < n / 16; i += kQThreads) {
    float v[16];
    load16(xs + 16 * i, v);
    dst[i] = quant16(v, s);
  }
}

// stream: as cluster, x read from device memory in both passes (any E,
// any alignment).
template <typename T>
__global__ void __launch_bounds__(kQThreads)
int8_quantize_kernel_stream(const T* __restrict__ x, long long E, long long slice,
                            int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float red[kQThreads / 32];
  __shared__ float mine;
  cg::cluster_group cl = cg::this_cluster();
  const int r = (int)cl.block_rank(), b = blockIdx.y, tid = threadIdx.x;
  const long long lo = (long long)r * slice, hi = min(E, lo + slice);
  const T* xb = x + (long long)b * E;
  float m = 0.f;
  for (long long i = lo + tid; i < hi; i += kQThreads) m = max_nan(m, fabsf(load_f(xb, i)));
  m = block_max(m, red);
  if (tid == 0) mine = m;
  const float s = scale_of(cluster_max(cl, &mine));
  if (r == 0 && tid == 0) scale[b] = s;
  int8_t* qb = q + (long long)b * E;
  for (long long i = lo + tid; i < hi; i += kQThreads) qb[i] = quant1(load_f(xb, i), s);
}

// rows: warp w of block i takes example kRowsWarps i + w (E <= kRowsMaxE)
template <typename T>
__global__ void __launch_bounds__(32 * kRowsWarps)
int8_quantize_kernel_rows(const T* __restrict__ x, int B, int E, int8_t* __restrict__ q,
                          float* __restrict__ scale) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const T* xb = x + (long long)b * E;
  float v[kRowsMaxE / 32];
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kRowsMaxE / 32; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < E ? load_f(xb, i) : 0.f;
    m = max_nan(m, fabsf(v[k]));
  }
  for (int o = 16; o; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = scale_of(m);
  if (lane == 0) scale[b] = s;
  int8_t* qb = q + (long long)b * E;
#pragma unroll
  for (int k = 0; k < kRowsMaxE / 32; ++k) {
    const int i = lane + 32 * k;
    if (i < E) qb[i] = quant1(v[k], s);
  }
}

// static: one scale, total = B E elements; vec: x and q 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(256)
int8_quantize_kernel_static(const T* __restrict__ x, long long total, long long B,
                            const float* __restrict__ amax, int8_t* __restrict__ q,
                            float* __restrict__ scale, int vec) {
  const float s = scale_of(*amax);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long b = gt; b < B; b += stride) scale[b] = s;
  const long long nv = vec ? total / 16 : 0;
  for (long long i = gt; i < nv; i += stride) {
    float v[16];
    load16(x + 16 * i, v);
    reinterpret_cast<uint4*>(q)[i] = quant16(v, s);
  }
  for (long long i = 16 * nv + gt; i < total; i += stride) q[i] = quant1(load_f(x, i), s);
}

// ------------------------------------------------- conv, shared helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Shared-memory writes of this thread become visible to the async proxy
// (a TMA store that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps registers that an in-flight wgmma writes live and in place until
// this point (after the wait that retires it).
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma operand: a K-major s8 tile of rows of kc bytes (kc 128, 64 or 32)
// in the swizzle of that width, as TMA writes it: 8-row groups 8 kc bytes
// apart (SBO); the start advances 32 bytes per k32 step.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int kc) {
  const uint64_t layout = kc == 128 ? 1 : kc == 64 ? 2 : 3;  // 128-, 64-, 32-byte swizzle
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)((8 * kc) >> 4) << 32 | layout << 62;
}

// d (64 x 256 s32, across the warpgroup) (+)= a (64 x 32 s8) * b (256 x 32 s8),
// both K-major in shared memory; d = a * b where scale_d is 0
__device__ __forceinline__ void wgmma_s8_n256(uint32_t (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 s32) (+)= a (64 x 32 s8) * b (128 x 32 s8), as wgmma_s8_n256
__device__ __forceinline__ void wgmma_s8_n128(uint32_t (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64 s32) (+)= a (64 x 32 s8) * b (64 x 32 s8), as wgmma_s8_n256
__device__ __forceinline__ void wgmma_s8_n64(uint32_t (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32 s32) (+)= a (64 x 32 s8) * b (32 x 32 s8), as wgmma_s8_n256
__device__ __forceinline__ void wgmma_s8_n32(uint32_t (&d)[16], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 8 s32) (+)= a (64 x 32 s8) * b (8 x 32 s8), as wgmma_s8_n256
__device__ __forceinline__ void wgmma_s8_n8(uint32_t (&d)[4], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[BN / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (BN == 256)
    wgmma_s8_n256(d, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_s8_n128(d, a, b, scale_d);
  else
    wgmma_s8_n64(d, a, b, scale_d);
}

// ------------------------------------------------------ conv, TMA kernels
constexpr int kTmaThreads = 384;  // a producer warpgroup, two consumer warpgroups
constexpr int kWideRows = 128;    // pixels per wide tile: 64 per consumer warpgroup
constexpr int kNarrowRows = 256;  // pixels per narrow tile: two m64 blocks per warpgroup
constexpr int kNarrowBN = 8;
// TMA stores: two buffers of the tile's 128 rows x 128 bytes (64 bf16 or 32
// f32 channels), in the 128-byte swizzle
constexpr int kStoreCols = 128;  // bytes of a row of a store box
constexpr int kStoreBytes = 2 * kWideRows * kStoreCols;
// the wide kernel's column tables: wscale and the bias (f32) of a tile's 256
constexpr int kColBytes = 2 * 256 * 4;

// Everything the TMA kernels read besides the two tensor maps (set by the
// host: conv_prepare).
struct TmaArgs {
  const float* wscale;
  const float* xscale;
  const void* bias;
  void* out;
  int B, H, W, N, layout, kh, kw, pad;
  int Hp, Wp;        // one phase's output (direct: Ho x Wo; up2: H x W of 2H x 2W)
  int kc, chunks;    // channel bytes per k chunk, chunks per tap
  int bw, bh, bb;    // the x box: columns, rows, examples (a tile's pixels)
  int tx, ty, tn;    // tiles along the columns, the rows and N (examples: the rest)
  int tiles;
  int stages;        // the ring's stages
  int off_b, off_misc, off_bar;  // shared-memory offsets: w ring or w, staging, barriers
};

struct Origin {
  int x0, y0, b0, n0;
};

__device__ __forceinline__ Origin origin_of(const TmaArgs& p, int tile, int bn) {
  const int nt = tile % p.tn, mt = tile / p.tn;
  Origin o;
  o.x0 = (mt % p.tx) * p.bw;
  o.y0 = ((mt / p.tx) % p.ty) * p.bh;
  o.b0 = (mt / (p.tx * p.ty)) * p.bb;
  o.n0 = nt * bn;
  return o;
}

// Whether pixel row r of a tile lies inside the box and the output.
__device__ __forceinline__ bool pixel_in(const TmaArgs& p, const Origin& o, int r) {
  const int xi = r % p.bw, yi = (r / p.bw) % p.bh, bi = r / (p.bw * p.bh);
  return bi < p.bb && o.x0 + xi < p.Wp && o.y0 + yi < p.Hp && o.b0 + bi < p.B;
}

// bias[n] in f32 (exact for bf16)
template <int OUT>
__device__ __forceinline__ float bias_at(const void* bias, int n) {
  return OUT == kF32 ? static_cast<const float*>(bias)[n]
                     : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
}

// dequantized value: the product of the scales first, the rounding to the
// output dtype, then the bias in that dtype (returned in f32: exact for bf16)
template <int OUT>
__device__ __forceinline__ float dequant(uint32_t acc, float ws, float xs, bool has_bias,
                                         float bias) {
  float v = __fmul_rn((float)(int)acc, __fmul_rn(ws, xs));
  if (OUT == kBF16) v = __bfloat162float(__float2bfloat16_rn(v));
  return has_bias ? __fadd_rn(v, bias) : v;
}

__device__ __forceinline__ void consumers_sync() {  // the two consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The producer's x box of a tap's shift (sy, sx) and channel chunk cc.
__device__ __forceinline__ void load_x(const CUtensorMap* tm, uint32_t dst, const TmaArgs& p,
                                       const Origin& o, int sy, int sx, int cc, uint32_t bar) {
  tma_load_4d(dst, tm, cc * p.kc, o.x0 + sx, o.y0 + sy, o.b0, bar);
}

// tap t of phase ph: its shift in x and its row of taps in w
__device__ __forceinline__ void tap_of(const TmaArgs& p, int ph, int t, int& sy, int& sx,
                                       int& wtap) {
  if (p.layout == kDirect) {
    sy = t / p.kw - p.pad;
    sx = t % p.kw - p.pad;
    wtap = t;
  } else {
    sy = (t >> 1) + (ph >> 1) - 1;
    sx = (t & 1) + (ph & 1) - 1;
    wtap = 4 * ph + t;
  }
}

template <int BN, int OUT>
__global__ void __launch_bounds__(kTmaThreads, 1)
int8_conv_kernel_wide(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_o, TmaArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int kc = p.kc, stages = p.stages;
  const uint32_t s_a = smem_addr(smem), s_b = s_a + p.off_b;
  const uint32_t full = s_a + p.off_bar, empty = full + 8 * kMaxStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int phases = p.layout == kUp2 ? 4 : 1;
  const int taps = p.layout == kUp2 ? 4 : p.kh * p.kw;
  const int kiters = taps * p.chunks;
  PHASE_START;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      const uint32_t bytes = (uint32_t)(p.bw * p.bh * p.bb + BN) * kc;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Origin o = origin_of(p, tile, BN);
        for (int ph = 0; ph < phases; ++ph)
          for (int t = 0; t < taps; ++t) {
            int sy, sx, wtap;
            tap_of(p, ph, t, sy, sx, wtap);
            for (int cc = 0; cc < p.chunks; ++cc) {
              mbar_wait(empty + 8 * stage, phase ^ 1);
              PHASE(0);  // waiting for a free stage
              mbar_expect_tx(full + 8 * stage, bytes);
              load_x(&tm_x, s_a + stage * kWideRows * kc, p, o, sy, sx, cc, full + 8 * stage);
              tma_load_3d(s_b + stage * BN * kc, &tm_w, cc * kc, wtap, o.n0, full + 8 * stage);
              PHASE(1);  // issuing
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, wq = warp & 3, g = lane >> 2, t = lane & 3, ct = tid - 128;
  float* col_ws = reinterpret_cast<float*>(smem + p.off_misc + kStoreBytes);
  float* col_b = col_ws + 256;
  int slices = 0;  // TMA stores issued by this block: the next one's buffer is slices & 1
  const bool has_bias = p.bias != nullptr;
  int tab_n0 = -1;  // the tiles' channels the column tables hold
  uint32_t acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Origin o = origin_of(p, tile, BN);
    if (o.n0 != tab_n0) {  // once per block where one tile spans N
      consumers_sync();    // the previous table is read
      for (int i = ct; i < BN; i += 256) {
        const int n = o.n0 + i;
        col_ws[i] = n < p.N ? p.wscale[n] : 0.f;
        col_b[i] = has_bias && n < p.N ? bias_at<OUT>(p.bias, n) : 0.f;
      }
      consumers_sync();
      tab_n0 = o.n0;
    }
    for (int ph = 0; ph < phases; ++ph) {
      // the epilogue's rows: acc[4j + 2h + e] is row 16 wq + g + 8h of this
      // warpgroup's 64, column 8j + 2t + e of the tile's BN (their scales'
      // loads run during the products)
      float xs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * 64 + wq * 16 + g + 8 * h;
        xs[h] = pixel_in(p, o, r) ? p.xscale[o.b0 + r / (p.bw * p.bh)] : 0.f;
      }
      int last = 0;
      for (int i = 0; i < kiters; ++i) {
        mbar_wait(full + 8 * stage, phase);
        PHASE(0);  // waiting for x and w
        const uint32_t a = s_a + stage * kWideRows * kc + cw * 64 * kc;
        const uint32_t b = s_b + stage * BN * kc;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (32 * s < kc) wgmma_s8<BN>(acc, kmajor_desc(a + 32 * s, kc),
                                         kmajor_desc(b + 32 * s, kc), i | s);
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<1>();  // the previous chunk's product is done: free its stage
          if ((tid & 127) == 0) mbar_arrive(empty + 8 * last);
        }
        last = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
        PHASE(1);  // the products
      }
      wgmma_wait<0>();
      hold(acc);
      if ((tid & 127) == 0) mbar_arrive(empty + 8 * last);
      PHASE(1);

      // epilogue: the accumulators dequantized in place (f32 bits; the
      // tables hold 0 past N), then stored by TMA
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 ws = *reinterpret_cast<const float2*>(col_ws + 8 * j + 2 * t);
        const float2 bs = *reinterpret_cast<const float2*>(col_b + 8 * j + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * j + 2 * h] =
              __float_as_uint(dequant<OUT>(acc[4 * j + 2 * h], ws.x, xs[h], has_bias, bs.x));
          acc[4 * j + 2 * h + 1] =
              __float_as_uint(dequant<OUT>(acc[4 * j + 2 * h + 1], ws.y, xs[h], has_bias, bs.y));
        }
      }
      // per 64 bf16 or 32 f32 columns: the tile's rows staged in the box's
      // layout, then one TMA store of the box (clipped at the tensor's
      // edges) while the next slice and the next tile go on
      constexpr int kSC = kStoreCols / (OUT == kF32 ? 4 : 2);
#pragma unroll
      for (int s = 0; s < BN / kSC; ++s) {
        const int nb = o.n0 + kSC * s;
        if (nb >= p.N) break;
        unsigned char* buf = smem + p.off_misc + (slices & 1) * (kWideRows * kStoreCols);
#pragma unroll
        for (int jj = 0; jj < kSC / 8; ++jj) {
          const int j = kSC / 8 * s + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // row r = 64 cw + 16 wq + g + 8h: r & 7 is g
            unsigned char* row = buf + (cw * 64 + wq * 16 + g + 8 * h) * kStoreCols;
            if (OUT == kF32) {
              *reinterpret_cast<uint2*>(row + (((2 * jj + (t >> 1)) ^ g) << 4) + 8 * (t & 1)) =
                  make_uint2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            } else {
              const __nv_bfloat162 pk = __floats2bfloat162_rn(
                  __uint_as_float(acc[4 * j + 2 * h]), __uint_as_float(acc[4 * j + 2 * h + 1]));
              *reinterpret_cast<__nv_bfloat162*>(row + ((jj ^ g) << 4) + 4 * t) = pk;
            }
          }
        }
        fence_proxy_async();
        // the store of the previous slice has read the other buffer
        if (ct == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        consumers_sync();
        if (ct == 0) {
          const uint32_t src = smem_addr(buf);
          if (p.layout == kDirect)
            tma_store_4d(&tm_o, src, nb, o.x0, o.y0, o.b0);
          else
            tma_store_5d(&tm_o, src, (ph & 1) * p.N + nb, o.x0, ph >> 1, o.y0, o.b0);
          bulk_commit();
        }
        ++slices;
      }
      PHASE(2);  // the epilogue
    }
  }
  if (ct == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // smem outlives them
}

// The narrow kernel's shifts: up2 reads 9 shifted boxes of x per chunk
// (sy, sx in {-1, 0, 1}), each by every phase (a, b) with du = sy + 1 - a
// and dv = sx + 1 - b in {0, 1}; direct reads kh kw, each by its tap. w is
// resident as one B tile per shift and chunk: 8 rows per phase (phase p's
// tap of that shift at rows 8p.., zeros where p does not read it), so one
// m64n32k32 (up2; m64n8k32 direct) takes a shift into every phase at once.
__device__ __forceinline__ int narrow_wtap(bool up2, int sh, int ph) {
  if (!up2) return ph == 0 ? sh : -1;
  const int du = sh / 3 - (ph >> 1), dv = sh % 3 - (ph & 1);  // sy + 1 - a, sx + 1 - b
  return du >= 0 && du <= 1 && dv >= 0 && dv <= 1 ? 4 * ph + 2 * du + dv : -1;
}

template <int OUT>
__global__ void __launch_bounds__(kTmaThreads, 1)
int8_conv_kernel_narrow(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w, TmaArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int kc = p.kc, stages = p.stages;
  const bool up2 = p.layout == kUp2;
  const int P = up2 ? 4 : 1;  // phases
  const uint32_t s_a = smem_addr(smem), s_w = s_a + p.off_b;
  unsigned char* out_st = smem + p.off_misc;  // the output region, in the output dtype
  const uint32_t full = s_a + p.off_bar, empty = full + 8 * kMaxStages,
                 wbar = empty + 8 * kMaxStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int shifts = up2 ? 9 : p.kh * p.kw;
  const int wtile = kNarrowBN * P * kc;  // bytes of one shift's B tile
  const int f = up2 ? 2 : 1;  // output pixels per input pixel along each axis
  PHASE_START;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      // all of w once: each (phase, tap) box of 8 rows x kc bytes into its
      // shift's B tile
      mbar_expect_tx(wbar, (uint32_t)((up2 ? 16 : shifts) * p.chunks * kNarrowBN * kc));
      for (int sh = 0; sh < shifts; ++sh)
        for (int ph = 0; ph < P; ++ph) {
          const int wtap = narrow_wtap(up2, sh, ph);
          if (wtap < 0) continue;
          for (int cc = 0; cc < p.chunks; ++cc)
            tma_load_3d(s_w + (sh * p.chunks + cc) * wtile + ph * kNarrowBN * kc, &tm_w,
                        cc * kc, wtap, 0, wbar);
        }
      const uint32_t bytes = (uint32_t)(p.bw * p.bh * p.bb) * kc;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const Origin o = origin_of(p, tile, kNarrowBN);
        for (int sh = 0; sh < shifts; ++sh) {
          int sy, sx, wtap;
          if (up2) {
            sy = sh / 3 - 1;
            sx = sh % 3 - 1;
          } else {
            tap_of(p, 0, sh, sy, sx, wtap);
          }
          for (int cc = 0; cc < p.chunks; ++cc) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            PHASE(0);
            mbar_expect_tx(full + 8 * stage, bytes);
            load_x(&tm_x, s_a + stage * kNarrowRows * kc, p, o, sy, sx, cc, full + 8 * stage);
            PHASE(1);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1, wq = warp & 3, g = lane >> 2, t = lane & 3, ct = tid - 128;
  // the B tiles' rows no phase loads are zeros (up2: 7 of 36 groups a chunk)
  for (int sh = 0; sh < shifts; ++sh)
    for (int ph = 0; ph < P; ++ph)
      if (narrow_wtap(up2, sh, ph) < 0)
        for (int cc = 0; cc < p.chunks; ++cc) {
          uint4* z = reinterpret_cast<uint4*>(smem + p.off_b + (sh * p.chunks + cc) * wtile +
                                              ph * kNarrowBN * kc);
          for (int i = ct; i < kNarrowBN * kc / 16; i += 256) z[i] = make_uint4(0, 0, 0, 0);
        }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // seen by wgmma
  consumers_sync();
  // this thread's two channels n = 2t + e
  float nws[2], nb[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = 2 * t + e;
    nws[e] = n < p.N ? p.wscale[n] : 0.f;
    nb[e] = p.bias && n < p.N ? bias_at<OUT>(p.bias, n) : 0.f;
  }
  const bool has_bias = p.bias != nullptr;
  mbar_wait(wbar, 0);
  uint32_t acc[2][16];  // [m64 block][fragment]: column 8 ph + 2t + e is phase ph
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Origin o = origin_of(p, tile, kNarrowBN);
    float xs[2][2];  // the rows' scales, loaded during the products
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bi = (cw * 128 + m * 64 + wq * 16 + g + 8 * h) / (p.bw * p.bh);
        xs[m][h] = bi < p.bb && o.b0 + bi < p.B ? p.xscale[o.b0 + bi] : 0.f;
      }
    // two chunks' products in flight: the stage of each of the last two
    int prev[2] = {0, 0}, it = 0;
    for (int sh = 0; sh < shifts; ++sh) {
      for (int cc = 0; cc < p.chunks; ++cc, ++it) {
        mbar_wait(full + 8 * stage, phase);
        PHASE(0);
        const uint32_t xa = s_a + stage * kNarrowRows * kc + cw * 128 * kc;
        const uint32_t wb = s_w + (sh * p.chunks + cc) * wtile;
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            if (32 * s < kc) {
              const uint64_t da = kmajor_desc(xa + m * 64 * kc + 32 * s, kc);
              const uint64_t db = kmajor_desc(wb + 32 * s, kc);
              if (up2)
                wgmma_s8_n32(acc[m], da, db, it | s);
              else
                wgmma_s8_n8(*reinterpret_cast<uint32_t(*)[4]>(acc[m]), da, db, it | s);
            }
        wgmma_commit();
        if (it > 1) {
          wgmma_wait<2>();  // the products of two chunks ago are done: free their stage
          if ((tid & 127) == 0) mbar_arrive(empty + 8 * prev[0]);
        }
        prev[0] = prev[1];
        prev[1] = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
        PHASE(1);
      }
    }
    wgmma_wait<0>();
    hold(acc[0]);
    hold(acc[1]);
    if ((tid & 127) == 0) {
      if (it > 1) mbar_arrive(empty + 8 * prev[0]);
      mbar_arrive(empty + 8 * prev[1]);
    }
    PHASE(1);

    // epilogue: the tile's output region [bb][f bh][f bw][N] staged in the
    // output dtype, then copied out (a row of the region is contiguous; the
    // region is, where its rows span the output's: 16 bytes a thread)
    const int rw = f * p.bw, rh = f * p.bh, L = rw * p.N, esz = OUT == kF32 ? 4 : 2;
    const int Ho = f * p.Hp, Wo = f * p.Wp;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * 128 + m * 64 + wq * 16 + g + 8 * h;
        const int xi = r % p.bw, yi = (r / p.bw) % p.bh, bi = r / (p.bw * p.bh);
        if (bi >= p.bb || o.b0 + bi >= p.B) continue;
#pragma unroll
        for (int ph = 0; ph < 4; ++ph) {
          if (ph >= P) break;
          const int oy = f * yi + (ph >> 1), ox = f * xi + (ph & 1);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (2 * t + e < p.N) {
              const int i = ((bi * rh + oy) * rw + ox) * p.N + 2 * t + e;
              const float v = dequant<OUT>(acc[m][4 * ph + 2 * h + e], nws[e], xs[m][h],
                                           has_bias, nb[e]);
              if (OUT == kF32)
                reinterpret_cast<float*>(out_st)[i] = v;
              else
                reinterpret_cast<__nv_bfloat16*>(out_st)[i] = __float2bfloat16_rn(v);
            }
        }
      }
    consumers_sync();  // the staging is complete
    const int rows = p.bb * rh;
    const int lv = min(rw, Wo - f * o.x0) * p.N;  // a row's elements inside the output
    unsigned char* out = static_cast<unsigned char*>(p.out);
    if (lv == L && L * esz % 16 == 0 && rw == Wo) {
      const int V = L * esz / 16;  // 16-byte pieces a row
      for (int idx = ct; idx < rows * V; idx += 256) {
        const int row = idx / V, v = idx - row * V;
        const int b = o.b0 + row / rh, oy = f * o.y0 + row % rh;
        if (b >= p.B || oy >= Ho) continue;
        *reinterpret_cast<uint4*>(out + (((long long)b * Ho + oy) * L) * esz + 16 * v) =
            *reinterpret_cast<const uint4*>(out_st + (row * L) * esz + 16 * v);
      }
    } else {
      for (int idx = ct; idx < rows * L; idx += 256) {
        const int row = idx / L, e = idx - row * L;
        const int bi = row / rh, oy = f * o.y0 + row % rh, b = o.b0 + bi;
        if (e >= lv || b >= p.B || oy >= Ho) continue;
        const long long off = (((long long)b * Ho + oy) * Wo + f * o.x0) * p.N + e;
        if (OUT == kF32)
          reinterpret_cast<float*>(out)[off] = reinterpret_cast<const float*>(out_st)[idx];
        else
          reinterpret_cast<__nv_bfloat16*>(out)[off] =
              reinterpret_cast<const __nv_bfloat16*>(out_st)[idx];
      }
    }
    consumers_sync();  // staging free for the next tile
    PHASE(2);
  }
}

// ------------------------------------------------------- conv, bytes kernel
// The byte-load kernel, for x and w rows TMA cannot take (C % 16 != 0): one block
// computes a 128 x 128 tile (output pixels x channels) of one phase with 8
// warps of 64 x 32 (128 x 64 and 4 warps where N <= 64), mma.sync.m16n8k32 s8
// on the tensor cores, fragments by ldmatrix; K in chunks of 64 bytes staged
// byte by byte, four stages.
constexpr int kBM = 128, kBK = 64, kStages = 4;
constexpr int kLds = kBK + 16;  // padded row stride in bytes: conflict-free ldmatrix

constexpr int conv_smem_bytes(int wn) { return kStages * (kBM + 32 * wn) * kLds; }

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* wscale;
  const float* xscale;
  const void* bias;
  void* out;
  int B, H, W, C, N;
  int layout, kh, kw, pad;
  int Ho, Wo;      // the output pixels of one phase: M = B Ho Wo
  int K;           // taps of one phase times C
  int w_stride;    // bytes of a packed row (all phases)
};

// The input pixel a (pixel, tap) reads: (iy, ix), and whether it exists.
__device__ __forceinline__ bool tap_at(const ConvArgs& p, int phase, int oy, int ox, int tap,
                                       int& iy, int& ix) {
  if (p.layout == kDirect) {
    iy = oy + tap / p.kw - p.pad;
    ix = ox + tap % p.kw - p.pad;
  } else {
    iy = oy + (tap >> 1) + (phase >> 1) - 1;
    ix = ox + (tap & 1) + (phase & 1) - 1;
  }
  return iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const int8_t* smem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// One block: kBM x (32 kWN) outputs of one phase, warps 2 (M) x kWN (N),
// each 64 x 32 (4 x 4 mma tiles).
template <int kOut, int kWN>
__global__ void __launch_bounds__(64 * kWN, 2)
int8_conv_kernel(ConvArgs p) {
  constexpr int kThreadsT = 64 * kWN, kBNT = 32 * kWN;
  extern __shared__ __align__(16) int8_t smem_b[];
  int8_t* const As = smem_b;                          // [kStages][kBM * kLds]
  int8_t* const Bs = smem_b + kStages * kBM * kLds;   // [kStages][kBNT * kLds]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int phase = blockIdx.z;
  const long long M = (long long)p.B * p.Ho * p.Wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBNT;
  const int8_t* wp = p.w + (long long)phase * p.K;  // this phase's slice of each row
  const int ktiles = (p.K + kBK - 1) / kBK;

  auto stage = [&](int buf, int kt) {
    const int k0 = kt * kBK;
    for (int e = tid; e < kBM * kBK; e += kThreadsT) {
      const int row = e / kBK, kk = e % kBK, k = k0 + kk;
      const long long m = m0 + row;
      int8_t v = 0;
      if (m < M && k < p.K) {
        const int ox = (int)(m % p.Wo), oy = (int)((m / p.Wo) % p.Ho);
        const int b = (int)(m / ((long long)p.Wo * p.Ho));
        const int tap = k / p.C, c = k - tap * p.C;
        int iy, ix;
        if (tap_at(p, phase, oy, ox, tap, iy, ix))
          v = p.x[(((long long)b * p.H + iy) * p.W + ix) * p.C + c];
      }
      As[buf * kBM * kLds + row * kLds + kk] = v;
    }
    for (int e = tid; e < kBNT * kBK; e += kThreadsT) {
      const int row = e / kBK, kk = e % kBK, k = k0 + kk, n = n0 + row;
      Bs[buf * kBNT * kLds + row * kLds + kk] =
          (n < p.N && k < p.K) ? wp[(long long)n * p.w_stride + k] : 0;
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int wm = (warp / kWN) * 64, wn = (warp % kWN) * 32;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix row addresses: A's four 8x16-byte matrices are rows 0-7 / 8-15
  // by bytes 0-15 / 16-31 of a 16 x 32 tile (the s8 A fragment); B's are
  // n rows 0-7 / 8-15 of two n-tiles by bytes 0-15 / 16-31
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 16 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 16 * ((lane >> 3) & 1);
  // the stores of tile kt + kStages - 1 overlap the products of tile kt
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st)
    if (st < ktiles) stage(st, st);
  for (int kt = 0; kt < ktiles; ++kt) {
    __syncthreads();  // tile kt is in, and every warp is done with slot (kt - 1)
    if (kt + kStages - 1 < ktiles) stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    const int8_t* as = As + (kt % kStages) * kBM * kLds;
    const int8_t* bs = Bs + (kt % kStages) * kBNT * kLds;
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], as + (wm + i * 16 + a_row) * kLds + s * 32 + a_col);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        unsigned r[4];
        ldmatrix_x4(r, bs + (wn + j * 8 + b_row) * kLds + s * 32 + b_col);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // epilogue: acc[i][j][r] is row wm + 16 i + g (+ 8 for r >= 2), column
  // wn + 8 j + 2 t + (r & 1) of the tile; a thread's two columns are stored
  // together where both exist and N is even
  const bool paired = (p.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const int ox = (int)(m % p.Wo), oy = (int)((m / p.Wo) % p.Ho);
      const int b = (int)(m / ((long long)p.Wo * p.Ho));
      long long pix;
      if (p.layout == kDirect) {
        pix = ((long long)b * p.Ho + oy) * p.Wo + ox;
      } else {
        pix = ((long long)b * 2 * p.Ho + 2 * oy + (phase >> 1)) * (2 * p.Wo) + 2 * ox +
              (phase & 1);
      }
      const float xs = p.xscale[b];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + t * 2;
        if (n >= p.N) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ne = min(n + e, p.N - 1);
          y[e] = dequant<kOut>((uint32_t)acc[i][j][2 * h + e], p.wscale[ne], xs, p.bias != nullptr,
                               p.bias ? bias_at<kOut>(p.bias, ne) : 0.f);
        }
        if (kOut == kF32) {
          float* o = static_cast<float*>(p.out) + pix * p.N + n;
          if (paired) *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
          else {
            o[0] = y[0];
            if (n + 1 < p.N) o[1] = y[1];
          }
        } else {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + pix * p.N + n;
          if (paired) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y[0], y[1]);
          } else {
            o[0] = __float2bfloat16_rn(y[0]);
            if (n + 1 < p.N) o[1] = __float2bfloat16_rn(y[1]);
          }
        }
      }
    }
  }
}

}  // namespace

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no libcuda
// at link time); null if the driver has none.
static EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

static int device_sms() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// Checks a TMA plan (kernels/int8.py::conv_plan) against the shape and lays
// out the shared memory; false where the kernel cannot take it.
static bool tma_prepare(TmaArgs& a, int variant, int C, int bn, int* smem) {
  const bool narrow = variant == kNarrow;
  const int rows = narrow ? kNarrowRows : kWideRows;
  if (C % 16 != 0 || (a.kc != 128 && a.kc != 64 && a.kc != 32)) return false;
  if (C % a.kc != 0 && a.kc != 32) return false;
  if (a.bw < 1 || a.bh < 1 || a.bb < 1 || a.bw > 256 || a.bh > 256 || a.bb > 256 ||
      a.bw * a.bh * a.bb > rows)
    return false;
  if (narrow ? (bn != kNarrowBN || a.N > kNarrowBN)
             : (bn != 256 && bn != 128 && bn != 64))
    return false;
  a.chunks = (C + a.kc - 1) / a.kc;
  a.tx = (a.Wp + a.bw - 1) / a.bw;
  a.ty = (a.Hp + a.bh - 1) / a.bh;
  a.tn = (a.N + bn - 1) / bn;
  const long long tiles = (long long)a.tx * a.ty * ((a.B + a.bb - 1) / a.bb) * a.tn;
  if (tiles > 0x7fffffff) return false;
  a.tiles = (int)tiles;
  const int bars = 2 * 8 * kMaxStages + 8;
  int fixed, stage, wbytes = 0, misc;
  if (narrow) {
    const bool up2 = a.layout == kUp2;
    wbytes = (up2 ? 9 : a.kh * a.kw) * a.chunks * kNarrowBN * (up2 ? 4 : 1) * a.kc;
    misc = (up2 ? 4 : 1) * kNarrowRows * kNarrowBN * 4;  // the output staging
    stage = kNarrowRows * a.kc;
  } else {
    misc = kStoreBytes + kColBytes;  // the output's staging, the column tables
    stage = (kWideRows + bn) * a.kc;
  }
  fixed = wbytes + misc + bars;
  a.stages = std::min(kMaxStages, (kSmemMax - fixed) / stage);
  if (a.stages < 2) return false;
  if (narrow) {
    a.off_b = a.stages * stage;             // w, resident
    a.off_misc = a.off_b + wbytes;
  } else {
    a.off_b = a.stages * kWideRows * a.kc;  // the w ring
    a.off_misc = a.stages * stage;
  }
  a.off_bar = a.off_misc + misc;
  a.off_bar = (a.off_bar + 7) / 8 * 8;
  *smem = a.off_bar + bars;
  return *smem <= kSmemMax;
}

// x [B, H, W, C] as (C, W, H, B) in boxes of (kc, bw, bh, bb); w [N, taps C]
// as (C, taps, N) in boxes of (kc, 1, bn); both in the swizzle of kc bytes,
// zeros outside the tensors. For the wide kernel's stores (tm_o not null),
// out [B, Ho, Wo, N] as (N, Wo,
// Ho, B) (direct) or, up2, [B, H, 2, W, 2 N] as (2 N, W, 2, H, B), a
// phase's parity b choosing the half of 2 N and its a the middle index, in
// boxes of 128 bytes of channels by the x box's pixels, 128-byte swizzle.
static cudaError_t tma_maps(const int8_t* x, const int8_t* w, void* out, int out_dtype,
                            const TmaArgs& a, int C, int taps, int bn, CUtensorMap* tm_x,
                            CUtensorMap* tm_w, CUtensorMap* tm_o) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle sw = a.kc == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : a.kc == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)a.B};
  const cuuint64_t xs[3] = {(cuuint64_t)C, (cuuint64_t)a.W * C, (cuuint64_t)a.H * a.W * C};
  const cuuint32_t xb[4] = {(cuuint32_t)a.kc, (cuuint32_t)a.bw, (cuuint32_t)a.bh,
                            (cuuint32_t)a.bb};
  if (enc(tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(x), xd, xs, xb, one,
          CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)taps, (cuuint64_t)a.N};
  const cuuint64_t ws[2] = {(cuuint64_t)C, (cuuint64_t)taps * C};
  const cuuint32_t wb[3] = {(cuuint32_t)a.kc, 1, (cuuint32_t)bn};
  if (enc(tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(w), wd, ws, wb, one,
          CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (tm_o == nullptr) return cudaSuccess;
  const cuuint64_t e = out_dtype == kF32 ? 4 : 2, N = (cuuint64_t)a.N;
  const CUtensorMapDataType ot =
      out_dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t sc = (cuuint32_t)(kStoreCols / e);
  CUresult r;
  if (a.layout == kDirect) {
    const cuuint64_t od[4] = {N, (cuuint64_t)a.Wp, (cuuint64_t)a.Hp, (cuuint64_t)a.B};
    const cuuint64_t os[3] = {N * e, a.Wp * N * e, (cuuint64_t)a.Hp * a.Wp * N * e};
    const cuuint32_t ob[4] = {sc, (cuuint32_t)a.bw, (cuuint32_t)a.bh, (cuuint32_t)a.bb};
    r = enc(tm_o, ot, 4, out, od, os, ob, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t W = (cuuint64_t)a.Wp, H = (cuuint64_t)a.Hp;
    const cuuint64_t od[5] = {2 * N, W, 2, H, (cuuint64_t)a.B};
    const cuuint64_t os[4] = {2 * N * e, 2 * W * N * e, 4 * W * N * e, 4 * H * W * N * e};
    const cuuint32_t ob[5] = {sc, (cuuint32_t)a.bw, 1, (cuuint32_t)a.bh, (cuuint32_t)a.bb};
    r = enc(tm_o, ot, 5, out, od, os, ob, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K, typename... Args>
static cudaError_t launch_tma(K kernel, int smem, const TmaArgs& a, cudaStream_t s,
                              Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = device_sms();
  const int grid = std::max(1, std::min(a.tiles, sms > 0 ? sms : 132));
  kernel<<<grid, kTmaThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <int kOut, int kWN>
cudaError_t launch_bytes(dim3 grid, const ConvArgs& p, cudaStream_t s) {
  constexpr int bytes = conv_smem_bytes(kWN);
  // above 48 KB only once the kernel is allowed it (per device: set each call)
  cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<kOut, kWN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int8_conv_kernel<kOut, kWN><<<grid, 64 * kWN, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int OUT>
static cudaError_t conv_tma(const int8_t* x, const int8_t* w, TmaArgs a, int variant, int C,
                            int bn, cudaStream_t s) {
  int smem = 0;
  if (!tma_prepare(a, variant, C, bn, &smem)) return cudaErrorInvalidValue;
  if (variant == kWide) {  // TMA stores: 16-byte rows; up2: a box stays in its parity's N
    const int sc = kStoreCols / (OUT == kF32 ? 4 : 2);
    if (a.N % (16 / (OUT == kF32 ? 4 : 2)) != 0 || (a.layout == kUp2 && a.N % sc != 0) ||
        (uintptr_t)a.out % 16 != 0)
      return cudaErrorInvalidValue;
  }
  const int taps = a.layout == kUp2 ? 16 : a.kh * a.kw;
  CUtensorMap tm_x, tm_w, tm_o = {};
  cudaError_t err = tma_maps(x, w, a.out, OUT, a, C, taps, bn, &tm_x, &tm_w,
                             variant == kWide ? &tm_o : nullptr);
  if (err != cudaSuccess) return err;
  if (variant == kNarrow)
    return launch_tma(int8_conv_kernel_narrow<OUT>, smem, a, s, tm_x, tm_w, a);
  if (bn == 256)
    return launch_tma(int8_conv_kernel_wide<256, OUT>, smem, a, s, tm_x, tm_w, tm_o, a);
  if (bn == 128)
    return launch_tma(int8_conv_kernel_wide<128, OUT>, smem, a, s, tm_x, tm_w, tm_o, a);
  return launch_tma(int8_conv_kernel_wide<64, OUT>, smem, a, s, tm_x, tm_w, tm_o, a);
}

template <typename T>
static cudaError_t quantize(const T* x, long long B, long long E, const float* amax_static,
                            int8_t* q, float* scale, int variant, int cluster, long long slice,
                            cudaStream_t stream) {
  if (variant == kStatic) {
    if (!amax_static) return cudaErrorInvalidValue;
    const long long total = B * E;
    const int vec = ((uintptr_t)x | (uintptr_t)q) % 16 == 0;
    const int sms = device_sms();
    const long long want = std::max(1LL, (total / 16 + 255) / 256);
    const int grid = (int)std::min(want, (long long)std::max(sms, 1) * 16);
    int8_quantize_kernel_static<T><<<grid, 256, 0, stream>>>(x, total, B, amax_static, q, scale,
                                                             vec);
    return cudaGetLastError();
  }
  if (amax_static) return cudaErrorInvalidValue;
  if (variant == kRows) {
    if (E > kRowsMaxE) return cudaErrorInvalidValue;
    const int grid = (int)((B + kRowsWarps - 1) / kRowsWarps);
    int8_quantize_kernel_rows<T><<<grid, 32 * kRowsWarps, 0, stream>>>(x, (int)B, (int)E, q,
                                                                       scale);
    return cudaGetLastError();
  }
  if (cluster < 1 || cluster > 8 || slice <= 0 || slice * cluster < E || B > 65535)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)B, 1);
  cfg.blockDim = dim3(kQThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (variant == kCluster) {
    const long long bytes = slice * (long long)sizeof(T);
    if (E % 16 != 0 || slice % 16 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)q % 16 != 0 ||
        bytes > kSmemMax - 4096)
      return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(int8_quantize_kernel_cluster<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    cfg.dynamicSmemBytes = (size_t)bytes;
    err = cudaLaunchKernelEx(&cfg, int8_quantize_kernel_cluster<T>, x, E, slice, q, scale);
  } else if (variant == kStream) {
    err = cudaLaunchKernelEx(&cfg, int8_quantize_kernel_stream<T>, x, E, slice, q, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// x [B, E] f32 (dtype 0) or bf16 (1); amax_static: a device float (static
// mode, variant 0) or null (dynamic); q [B, E] int8, scale [B] f32.
// variant: 0 static, 1 rows, 2 cluster, 3 stream (kernels/int8.py::
// quantize_plan, which also gives the cluster's size and each block's slice
// of an example). One launch; *launched gains one. Returns a cudaError_t.
extern "C" int mcgm_int8_quantize(const void* x, int dtype, long long B, long long E,
                                  const float* amax_static, int8_t* q, float* scale,
                                  int variant, int cluster, long long slice, int* launched,
                                  void* stream) {
  if (B <= 0 || E <= 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = quantize(static_cast<const float*>(x), B, E, amax_static, q, scale, variant, cluster,
                   slice, s);
  else if (dtype == kBF16)
    err = quantize(static_cast<const __nv_bfloat16*>(x), B, E, amax_static, q, scale, variant,
                   cluster, slice, s);
  else
    return cudaErrorInvalidValue;
  if (err == cudaSuccess) ++*launched;
  return err;
}

// x [B, H, W, C] int8, w [N, taps C] int8 (layout 0: kh kw taps; layout 1:
// 16 taps, phase-major), wscale [N] f32, xscale [B] f32, bias [N] in the
// output dtype or null, out [B, Ho, Wo, N] in out_dtype (0 f32, 1 bf16),
// 16-byte aligned. variant 0 bytes, 1 wide, 2 narrow; kc, bn and the box
// (bw, bh, bb) from kernels/int8.py::conv_plan (the TMA variants; checked
// here). Returns a cudaError_t.
extern "C" int mcgm_int8_conv(const int8_t* x, const int8_t* w, const float* wscale,
                              const float* xscale, const void* bias, void* out, int out_dtype,
                              int B, int H, int W, int C, int N, int layout, int kh, int kw,
                              int pad, int variant, int kc, int bn, int bw, int bh, int bb,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0) return cudaErrorInvalidValue;
  if (out_dtype != kF32 && out_dtype != kBF16) return cudaErrorInvalidValue;
  if (layout != kDirect && layout != kUp2) return cudaErrorInvalidValue;
  const int Hp = layout == kDirect ? H + 2 * pad - kh + 1 : H;
  const int Wp = layout == kDirect ? W + 2 * pad - kw + 1 : W;
  if (Hp <= 0 || Wp <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWide || variant == kNarrow) {
    if (((uintptr_t)x | (uintptr_t)w) % 16 != 0) return cudaErrorInvalidValue;
    TmaArgs a = {};
    a.wscale = wscale;
    a.xscale = xscale;
    a.bias = bias;
    a.out = out;
    a.B = B;
    a.H = H;
    a.W = W;
    a.N = N;
    a.layout = layout;
    a.kh = kh;
    a.kw = kw;
    a.pad = pad;
    a.Hp = Hp;
    a.Wp = Wp;
    a.kc = kc;
    a.bw = bw;
    a.bh = bh;
    a.bb = bb;
    return out_dtype == kF32 ? conv_tma<kF32>(x, w, a, variant, C, bn, s)
                             : conv_tma<kBF16>(x, w, a, variant, C, bn, s);
  }
  if (variant != kBytes) return cudaErrorInvalidValue;
  ConvArgs p{x, w, wscale, xscale, bias, out, B, H, W, C, N, layout, kh, kw, pad, Hp, Wp, 0, 0};
  int phases;
  if (layout == kDirect) {
    p.K = kh * kw * C;
    p.w_stride = p.K;
    phases = 1;
  } else {
    p.K = 4 * C;
    p.w_stride = 16 * C;
    phases = 4;
  }
  const long long M = (long long)B * Hp * Wp;
  const bool wide = N > 64;  // wide: 128 channels a block, 8 warps
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + (wide ? 127 : 63)) /
                                                               (wide ? 128 : 64)), phases);
  cudaError_t err;
  if (out_dtype == kF32)
    err = wide ? launch_bytes<kF32, 4>(grid, p, s) : launch_bytes<kF32, 2>(grid, p, s);
  else
    err = wide ? launch_bytes<kBF16, 4>(grid, p, s) : launch_bytes<kBF16, 2>(grid, p, s);
  return err;
}

#ifdef INT8_CONV_PHASES
// out [24]: the phases' cycle totals since the last call (see PHASE)
extern "C" int mcgm_int8_conv_phases(unsigned long long* out) {
  static const unsigned long long zero[24] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
#endif

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
