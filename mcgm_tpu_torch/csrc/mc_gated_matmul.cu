// MC-gated 1x1 product of the Gated PixelCNN and of Glow's coupling nets,
// with its backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mc_gated_matmul of mcgm_tpu/ops/pallas_kernels.py
// (at commit 0303c43: `_mc_matmul_kernel`, called through `pl.pallas_call`),
// `(x @ w) * (indicator @ codebook)`, and takes the epilogue that the
// PixelCNN puts between the product and the gate when BatchNorm uses its
// running statistics (mcgm_tpu/models/pixelcnn.py, `horiz_resid_*` and the
// head's first 1x1 conv):
//
//   acc[m, n]  = sum_k x(m, k) * w[n, k]                        (f32 sums)
//   code[s, n] = sum_j indicator[s, j] * codebook[j, n]         (f32)
//   out(m, n)  = act(acc[m, n] * alpha[n] + beta[n]) * code[m / P, n]
//
// Rows m = b * P + p run over the P = H * W positions of each sample b, so
// the operands keep the port's NCHW layout: x(m, k) = x[b, k, p] of x
// [B, K, P] and out(m, n) = out[b, n, p] of out [B, N, P]; the sampler's
// per-position calls have P = 1 (x is [B, K]). w is [N, K] (a 1x1 conv's
// OIHW weight). alpha, beta [N] f32 or null (1 and 0), act the identity or
// ReLU, indicator [B, modes] and codebook [modes, N] f32, or null for no
// gate. x, w and out are all f32 or all bf16.
//
// Bound on an H100 SXM at the PixelCNN's shapes (K = 128; N = 128 for the
// residual, 512 for the head): at M = 32,768 rows (an eval batch of 512
// grids of 8 x 8) the head reads 8.4 MB of x and writes 33.6 MB, 12.6 us at
// 3.35 TB/s, against 2.1 G multiply-adds, 4.3 us at 989 TFLOP/s bf16; so
// bytes bound it (K = 128 is far below the ~295 operations per byte where
// the tensor cores would). At the sampler's M = 1,000 the bound is under
// half a microsecond, below the cost of a launch.
//
// Bound at Glow's shapes (K = N = 512, bf16, B = 128): level 1 (P = 256, M =
// 32,768) reads 33.5 MB of x and writes 33.5 MB of out, 20.2 us at 3.35
// TB/s, against 8.6 G multiply-adds, 17.4 us at 989 TFLOP/s: bytes bound it,
// but barely, so the product has to run near the tensor cores' rate too.
// The backward kernel reads x and g and writes gza, ~101 MB, 30 us.
//
// Design: three forward kernels, one launch per call; the entry point picks
// one by an explicit shape test (mcgm_mc_gated_matmul_variant, also
// exported so that a caller can name it). The sampler's per-position calls
// (P = 1) run on rows, the PixelCNN's eval forward (P = 64, K = 128) and
// Glow's coupling nets on wide, f32 and every other shape on generic. (A
// fourth kernel, samples, took P = 64 with K 64 or 128, one wgmma product
// per sample; the wide kernel was faster at the PixelCNN's eval head and
// residual, so it went.)
// - rows (bf16, P = 1, K in {64, 128}, N % 8 == 0): out [M, N] = x [M, K] .
//   w^T on wgmma (m64n64k16, A from registers, B = w from shared memory in
//   the 128-byte K-major swizzle, f32 sums), the whole K in shared memory;
//   one 64 x 64 tile per block of one warpgroup, x and w tiles (all of
//   K) loaded with one round of 16-byte cp.async, the code of the tile's
//   64 samples formed in registers beside the accumulator from indicator
//   and codebook staged 16 modes at a time, then 16-byte stores. 128 tiles
//   at the sampler's head (M = 1,000, N = 512): one wave.
// - generic (f32, and any other shape): a blocked product, one output tile
//   of 64 rows x 64 channels per block of 256 threads, K in chunks of 32
//   through shared memory; bf16 on mma.sync.m16n8k16, f32 on FFMA (4 x 4
//   outputs per thread); rows m = b * P + p gathered with consecutive
//   threads on consecutive addresses, the next chunk's loads in flight
//   during the current chunk's product, the gated tile staged in shared
//   memory for coalesced stores.
// - wide (bf16, K % 64 == 0 up to 512, any N, P 16, 32 or a multiple of 64;
//   the PixelCNN's eval forward, Glow's three levels): the product is
//   taken per sample as out[b] [N, P] = w [N, K] . x[b] [K, P], channels as
//   wgmma's M and positions as its N, so the accumulator's rows are
//   channels (alpha, beta and the code are two scalars a thread) and its
//   columns run along P, as out[b] does. A block owns 128 channels, their w rows resident in
//   shared memory (128 KB at K = 512: w's 512 KB cannot be; a slice read
//   from L2 once per block, not per tile), and walks position tiles of TP =
//   128 (64 where 128 would leave SMs idle, Glow's level 3) consecutive rows
//   m = b P + p: persistent, one block per SM, blocks of one set of slices
//   on the same tiles together so that x comes from device memory once.
//   One producer warp keeps TMA loads in flight through a ring of 5 stages
//   of x [64 k][TP positions] (a 3-D tensor map over (P, K, B): a stage is
//   atoms of [64 k][min(P, 64) positions] of one sample in the swizzle of
//   that width, so a tile spans 8 samples at P = 16), mbarriers full and
//   empty per stage; two consumer warpgroups each run m64nTPk16 wgmma with
//   A = w (K-major, 128-byte swizzle) and B = x (MN-major) from shared
//   memory, f32 sums, one chunk's product in flight while the previous
//   chunk's slot is released. A code warp forms each tile's codes into one
//   of two tables (mbarriers full and empty per table), off the consumers'
//   path (formed by the consumers, the gate cost more than the product's
//   loads). The epilogue is in f32 registers; per 8 rows x 32 columns,
//   stmatrix through 512 bytes of swizzled staging per warp gives each lane
//   8 consecutive positions of one channel, stored as 16 bytes (64
//   contiguous bytes per row and instruction). The next tile's loads run
//   during the epilogue. The consumers, not the loads, set the pace: the
//   product near the tensor cores' rate, then the epilogue, which does not
//   overlap it.
//
// The backward kernel (mc_gated_matmul_backward_kernel, one launch per call,
// for the wide kernel's shapes; the JAX package's VJP leaves this to XLA)
// runs the wide kernel's body with the same tiling, so its recomputed
// pre-activation acc alpha + beta is bit-equal to the forward's and its ReLU
// mask [pre > 0] is the forward's [out > 0] wherever the code is positive
// (where it is 0 both give 0): reading out instead would add 33.5 MB at
// level 1. Each lane reads its tile's g as 16-byte runs before the product
// and takes them back to the accumulator's layout through the same staging
// (ldmatrix). It writes gza = g code [pre > 0] alpha in bf16 as [N, B, P], so
// that dx = w^T gza and dw = gza x^T (x copied once to [K, B, P]) are one
// cuBLAS product each, and dbeta = sum g code [pre > 0], dalpha = the same
// times acc in f32: per block in registers in a fixed order, quads reduced
// by shuffles, written per block; the last block of each 128-channel slice
// (a counter the wrapper keeps, left at 0) adds them in block order. Two
// launches give bit-equal results.

#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTM = 64;        // rows per block
constexpr int kTN = 64;        // channels per block
constexpr int kTK = 32;        // k per chunk
constexpr int kThreads = 256;
constexpr int kLdh = kTK + 8;  // bf16 row stride of the [row][k] chunks (80 bytes)
constexpr int kLdf = kTM + 4;  // f32 row stride of the [k][row] chunks
constexpr int kLdo = kTN + 4;  // f32 row stride of the staged output tile
constexpr int kMC = 16;        // modes per chunk of the code's sums

struct Args {
  const void* x;
  const void* w;
  const float* alpha;
  const float* beta;
  const float* ind;
  const float* cb;
  void* out;
  int M, N, K, P, modes, relu;
};

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
struct Smem {
  static constexpr int kChunk = sizeof(T) == 2 ? kTM * kLdh : kTK * kLdf;  // kTM == kTN
  union {
    struct {  // the operand chunks during the product
      T a[kChunk];
      T b[kChunk];
    } op;
    float out[kTM * kLdo];  // the gated tile, staged for the stores
  } u;
  float code[kTM * kTN];  // [sample of the tile][channel]
  float alpha[kTN], beta[kTN];
  int srow[kTM];          // the tile's sample of each row, from the first one
  long long xrow[kTM];  // offset of x(m, 0); -1 past the last row
  long long orow[kTM];  // offset of out(m, 0)
};
static_assert(kTM * kMC + kMC * kTN <= kTM * kLdo, "the code's chunks fit over the tile");
static_assert(kTM == kTN && kTM * kMC % kThreads == 0, "one mapping for both code chunks");
static_assert(kTM * kTN % kThreads == 0, "each thread forms as many code entries");

constexpr int kLoads = kTM * kTK / kThreads;  // elements of x, and of w, per thread and chunk
static_assert(kTM == kTN, "x and w chunks share one element mapping");

// One chunk of x (rows m0.., k0..) and of w (channels n0.., k0..) in
// registers, zero past the edges: every load of the chunk is issued before
// any is used, and the next chunk's are in flight during the product.
template <typename T>
struct Chunk {
  T x[kLoads], w[kLoads];
};

// Element i of a thread: x's row r and depth kx (consecutive threads on
// consecutive positions for P > 1, on consecutive k for P = 1), w's
// channel c and depth kw.
struct Slot {
  int r, kx, c, kw;
  __device__ __forceinline__ Slot(int i, bool kfast) {
    const int e = threadIdx.x + i * kThreads;
    r = kfast ? e / kTK : e % kTM;
    kx = kfast ? e % kTK : e / kTM;
    c = e / kTK;
    kw = e % kTK;
  }
};

template <typename T>
__device__ __forceinline__ void fetch_chunk(Chunk<T>& ch, const Smem<T>& s,
                                            const T* __restrict__ x, const T* __restrict__ w,
                                            const Args& a, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const Slot q(i, a.P == 1);
    const long long base = s.xrow[q.r];
    const int n = n0 + q.c;
    ch.x[i] = (base >= 0 && k0 + q.kx < a.K) ? x[base + (long long)(k0 + q.kx) * a.P] : T(0.f);
    ch.w[i] = (n < a.N && k0 + q.kw < a.K) ? w[(long long)n * a.K + k0 + q.kw] : T(0.f);
  }
}

// The chunk into shared memory. bf16: [row][k]; f32: [k][row].
template <typename T>
__device__ __forceinline__ void store_chunk(Smem<T>& s, const Chunk<T>& ch, const Args& a) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const Slot q(i, a.P == 1);
    if constexpr (sizeof(T) == 2) {
      s.u.op.a[q.r * kLdh + q.kx] = ch.x[i];
      s.u.op.b[q.c * kLdh + q.kw] = ch.w[i];
    } else {
      s.u.op.a[q.kx * kLdf + q.r] = ch.x[i];
      s.u.op.b[q.kw * kLdf + q.c] = ch.w[i];
    }
  }
}

// act(acc * alpha + beta) * code of tile element (r, c), f32
template <typename T>
__device__ __forceinline__ float epilogue(const Smem<T>& s, const Args& a, int r, int c,
                                          float acc) {
  float v = acc * s.alpha[c] + s.beta[c];
  if (a.relu) v = fmaxf(v, 0.f);
  return v * s.code[s.srow[r] * kTN + c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mc_gated_matmul_kernel(Args a) {
  // raw storage: the operand types have constructors, shared memory none
  __shared__ __align__(16) unsigned char raw[sizeof(Smem<T>)];
  Smem<T>& s = *reinterpret_cast<Smem<T>*>(raw);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;

  // row offsets, samples and the affine of this tile; the code is formed
  // for its ns samples only (1 or 2 of them when P >= 64)
  const int s0 = m0 / a.P, ns = (min(m0 + kTM, a.M) - 1) / a.P - s0 + 1;
  if (tid < kTM) {
    const int m = m0 + tid;
    const long long b = m / a.P, p = m - b * a.P;
    s.xrow[tid] = m < a.M ? b * a.K * a.P + p : -1;
    s.orow[tid] = m < a.M ? b * a.N * a.P + p : -1;
    s.srow[tid] = m < a.M ? (int)b - s0 : 0;
  } else if (tid < kTM + kTN) {
    const int c = tid - kTM, n = n0 + c;
    s.alpha[c] = (a.alpha != nullptr && n < a.N) ? a.alpha[n] : 1.f;
    s.beta[c] = (a.beta != nullptr && n < a.N) ? a.beta[n] : 0.f;
  }
  __syncthreads();
  Chunk<T> ch;  // the first chunk's loads, in flight while the code is formed
  fetch_chunk(ch, s, x, w, a, n0, 0);
  // code = indicator @ codebook for the tile's samples and channels, kMC
  // modes at a time through shared memory (over the operand chunks, not in
  // use yet): the loads of a chunk are independent, the sums in mode order
  constexpr int kPer = kTM * kTN / kThreads;
  float code[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) code[i] = a.ind != nullptr ? 0.f : 1.f;
  if (a.ind != nullptr) {
    float* sInd = s.u.out;              // [sample][kMC]
    float* sCb = s.u.out + kTM * kMC;   // [kMC][kTN]
    for (int j0 = 0; j0 < a.modes; j0 += kMC) {
      constexpr int kL = kTM * kMC / kThreads;  // == kMC * kTN / kThreads
      float iv[kL], cv[kL];
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        const int e = tid + i * kThreads;
        const int q = e / kMC, mi = j0 + e % kMC, mc = j0 + e / kTN, n = n0 + e % kTN;
        iv[i] = (q < ns && mi < a.modes) ? a.ind[(long long)(s0 + q) * a.modes + mi] : 0.f;
        cv[i] = (n < a.N && mc < a.modes) ? a.cb[(long long)mc * a.N + n] : 0.f;
      }
      __syncthreads();  // the previous chunk is consumed
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        sInd[tid + i * kThreads] = iv[i];
        sCb[tid + i * kThreads] = cv[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = tid + i * kThreads, q = e / kTN, c = e % kTN;
        if (q < ns) {
#pragma unroll
          for (int j = 0; j < kMC; ++j)
            code[i] = fmaf(sInd[q * kMC + j], sCb[j * kTN + c], code[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if ((tid + i * kThreads) / kTN < ns) s.code[tid + i * kThreads] = code[i];
  __syncthreads();  // the code is written and its chunks (under the operands) consumed

  if constexpr (sizeof(T) == 2) {
    // tensor cores: warp (wm, wn) owns rows wm*16.. and channels wn*32..
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < a.K; k0 += kTK) {
      store_chunk(s, ch, a);
      __syncthreads();
      if (k0 + kTK < a.K) fetch_chunk(ch, s, x, w, a, n0, k0 + kTK);
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 16) {
        const __nv_bfloat16* ar = s.u.op.a + (wm * 16 + g) * kLdh + kk + 2 * t;
        const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLdh), ld32(ar + 8),
                                ld32(ar + 8 * kLdh + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* br = s.u.op.b + (wn * 32 + j * 8 + g) * kLdh + kk + 2 * t;
          mma_bf16(acc[j], af, ld32(br), ld32(br + 8));
        }
      }
      __syncthreads();  // the chunk is consumed
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 16 + g + (i >> 1) * 8, c = wn * 32 + j * 8 + 2 * t + (i & 1);
        s.u.out[r * kLdo + c] = epilogue(s, a, r, c, acc[j][i]);
      }
  } else {
    // CUDA cores: thread (ty, tx) owns rows ty*4.. and channels tx*4..
    const int tx = tid & 15, ty = tid >> 4;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < a.K; k0 += kTK) {
      store_chunk(s, ch, a);
      __syncthreads();
      if (k0 + kTK < a.K) fetch_chunk(ch, s, x, w, a, n0, k0 + kTK);
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(s.u.op.a + kk * kLdf + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(s.u.op.b + kk * kLdf + tx * 4);
        const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx * 4 + j;
        s.u.out[r * kLdo + c] = epilogue(s, a, r, c, acc[i][j]);
      }
  }
  __syncthreads();

  // coalesced stores: consecutive threads on consecutive positions (P > 1)
  // or channels (P = 1)
  T* __restrict__ out = static_cast<T*>(a.out);
  const bool nfast = a.P == 1;
  for (int e = tid; e < kTM * kTN; e += kThreads) {
    const int r = nfast ? e / kTN : e % kTM;
    const int c = nfast ? e % kTN : e / kTM;
    const long long base = s.orow[r];
    const int n = n0 + c;
    if (base >= 0 && n < a.N) from_f(out + base + (long long)n * a.P, s.u.out[r * kLdo + c]);
  }
}

// ------------------------------------------------------------ wgmma paths
constexpr int kSmemMax = 232448;

// shared memory of the rows kernel: w and x tiles [K/64][64][128 B], the
// indicator [64][kMC] and codebook [kMC][64] chunks, alpha and beta [64]
__host__ __device__ constexpr size_t rows_smem(int K) {
  return (size_t)2 * 64 * K * 2 + (size_t)2 * 64 * kMC * 4 + 2 * 64 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma B operand: a K-major bf16 tile in the 128-byte swizzle (8-row groups
// 1024 bytes apart, 16-byte chunk c of row r at c ^ (r & 7)), 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

// d (64x64 f32, across the warpgroup) += a (64x16 bf16, registers) * b (16x64, smem)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

// Keeps registers that an in-flight wgmma reads or writes live and in place
// until this point (after the wait that retires it).
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory writes of this thread (cp.async included) become visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Issues (does not wait for) the KT / 16 k16 steps of wgmma into acc: A
// from registers, B the 64 channels at row `n_off` of a [KT/64][rows][128 B]
// w tile.
template <int KT>
__device__ __forceinline__ void mma_issue(float (&acc)[32], uint32_t (&af)[KT / 16][4],
                                          uint32_t s_w, int rows, int n_off) {
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KT / 16; ++s)
    wgmma_64x64x16(acc, af[s], sw128_desc(s_w + (s >> 2) * rows * 128 + n_off * 128 +
                                          (s & 3) * 32));
  wgmma_commit();
}

// w rows [n0, n0 + rows) into a [KT/64][rows][128 B] tile, zero past N
template <int KT>
__device__ __forceinline__ void load_w_tile(uint32_t dst, const __nv_bfloat16* w, int n0,
                                            int rows, int N, int tid, int threads) {
  constexpr int kCpr = KT / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * kCpr; i += threads) {
    const int r = i / kCpr, ch = i % kCpr, n = n0 + r;
    cp_async16(dst + (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
               w + (size_t)min(n, N - 1) * KT + ch * 8, n < N);
  }
}

template <int KT>
__global__ void __launch_bounds__(128) mc_gated_matmul_kernel_rows(Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s_w = smem_addr(smem);
  const uint32_t s_x = s_w + 64 * KT * 2;
  unsigned char* xt = smem + 64 * KT * 2;  // the x tile, then the staged output
  float* sInd = reinterpret_cast<float*>(smem + 2 * 64 * KT * 2);  // [64][kMC]
  float* sCb = sInd + 64 * kMC;                                     // [kMC][64]
  float* sAlpha = sCb + kMC * 64;
  float* sBeta = sAlpha + 64;
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* __restrict__ w = static_cast<const __nv_bfloat16*>(a.w);
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(a.out);
  const int M = a.M, N = a.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 64;

  // all of K of both tiles in one round of copies; x rows past M zero
  load_w_tile<KT>(s_w, w, n0, 64, N, tid, 128);
  {
    constexpr int kCpr = KT / 8;
    for (int i = tid; i < 64 * kCpr; i += 128) {
      const int r = i / kCpr, ch = i % kCpr, m = m0 + r;
      cp_async16(s_x + (ch >> 3) * 64 * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                 x + (size_t)min(m, M - 1) * KT + ch * 8, m < M);
    }
  }
  cp_async_commit();
  if (tid < 64) {
    const int n = n0 + tid;
    sAlpha[tid] = (a.alpha != nullptr && n < N) ? a.alpha[n] : 1.f;
    sBeta[tid] = (a.beta != nullptr && n < N) ? a.beta[n] : 0.f;
  }
  // the code of this thread's 32 outputs, beside the accumulator:
  // code[4j + 2h + e] is row 16 warp + g + 8h, channel 8j + 2t + e
  float code[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) code[e] = a.ind != nullptr ? 0.f : 1.f;
  if (a.ind != nullptr) {
    for (int j0 = 0; j0 < a.modes; j0 += kMC) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = tid; e < 64 * kMC; e += 128) {
        const int r = e / kMC, jm = j0 + e % kMC, m = m0 + r;
        sInd[e] = (m < M && jm < a.modes) ? a.ind[(long long)m * a.modes + jm] : 0.f;
        const int jc = j0 + e / 64, n = n0 + e % 64;
        sCb[e] = (n < N && jc < a.modes) ? a.cb[(long long)jc * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* ir = sInd + (16 * warp + g + 8 * h) * kMC;
#pragma unroll
        for (int jj = 0; jj < kMC; ++jj) {
          const float iv = ir[jj];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 cv = *reinterpret_cast<const float2*>(sCb + jj * 64 + 8 * j + 2 * t);
            code[4 * j + 2 * h] = fmaf(iv, cv.x, code[4 * j + 2 * h]);
            code[4 * j + 2 * h + 1] = fmaf(iv, cv.y, code[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // A: this warp's 16 rows x all of K (ldmatrix of the [k/64][row][128 B] tile)
  uint32_t af[KT / 16][4];
  {
    const int r = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4;
#pragma unroll
    for (int s = 0; s < KT / 16; ++s) {
      const int ch = 2 * s + hi;
      ldmatrix_x4(af[s], s_x + (ch >> 3) * 64 * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
    }
  }
  float acc[32];
  mma_issue<KT>(acc, af, s_w, 64, 0);
  wgmma_wait<0>();
  hold(acc);
  hold(af);
  __syncthreads();  // every warp's fragments are loaded: the x tile is free
  // epilogue, staged [row][64 channels] bf16, chunk (channel >> 3) ^ (row & 7)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = 8 * j + 2 * t;
    const float2 al = *reinterpret_cast<const float2*>(sAlpha + ch);
    const float2 be = *reinterpret_cast<const float2*>(sBeta + ch);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      float v0 = acc[4 * j + 2 * h] * al.x + be.x, v1 = acc[4 * j + 2 * h + 1] * al.y + be.y;
      if (a.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(xt + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
          __floats2bfloat162_rn(v0 * code[4 * j + 2 * h], v1 * code[4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < 64 * 8; e += 128) {
    const int r = e >> 3, chk = e & 7, m = m0 + r, n = n0 + chk * 8;
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(out + (size_t)m * N + n) =
          *reinterpret_cast<const uint4*>(xt + r * 128 + ((chk ^ (r & 7)) << 4));
  }
}

// ------------------------------------------------- wide (TMA + wgmma, K up to 512)
constexpr int kWideRows = 128;       // channels per block, w resident: 64 per consumer warpgroup
constexpr int kWideStages = 5;       // x ring
constexpr int kWideThreads = 320;    // two consumer warpgroups, a producer and a code warp
constexpr int kWideMaxK = 512;
constexpr int kWideMaxSamples = 8;   // samples one tile spans (TP / P at P = 16)

// Everything the wide kernels read besides the two tensor maps.
struct WideArgs {
  const float* alpha;
  const float* beta;
  const float* ind;
  const float* cb;
  void* out;                // forward: out [B, N, P]; backward: gza [N, B, P]
  const __nv_bfloat16* g;   // backward: the upstream gradient [B, N, P]
  float* partial;           // backward: [2][sets][N] per-block sums (dbeta, then dalpha)
  int* counters;            // backward: [slices] blocks done, 0 between launches
  float* dalpha;
  float* dbeta;
  int B, N, K, P, modes, relu;
  int store_xt;  // backward: slice 0's blocks write x as xt [K, B, P] (for dw)
  int W;      // positions per swizzle atom of an x stage: min(P, 64)
  int loads;  // x loads per stage (64-position boxes when a tile lies in one sample)
  int lg_p;   // log2(P) when a tile spans several samples (P < TP), else -1
  int slices, sets, tiles;
};

// shared memory of the wide kernels: w [K/64][128 rows][128 B], the x ring
// [kWideStages][TP positions x 64 k], two code tables [kWideMaxSamples][128]
// f32, the consumer warps' staging [8][512 B], the barriers (full and empty
// per stage, w, full and empty per code table) and the last-block flag
__host__ __device__ constexpr size_t wide_smem(int K, int TP) {
  return (size_t)K / 64 * 16384 + (size_t)kWideStages * TP * 128 +
         2 * kWideMaxSamples * kWideRows * 4 + 8 * 512 + (2 * kWideStages + 5) * 8 + 8;
}
static_assert(wide_smem(kWideMaxK, 128) <= kSmemMax, "the wide kernel fits at K = 512");

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's groups of bulk stores still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wgmma B operand: an MN-major bf16 tile of 64 k rows per atom of W
// positions (2 W bytes a row, the TMA swizzle of that width), atoms 128 W
// bytes apart (LBO), 8-row groups 16 W bytes apart (SBO).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, int W) {
  const uint64_t layout = W == 64 ? 1 : W == 32 ? 2 : 3;  // 128-, 64-, 32-byte swizzle
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(8 * W) << 16 | (uint64_t)W << 32 |
         layout << 62;
}

// d (64 x 64 f32, across the warpgroup) (+)= a (64 x 16, K-major in shared memory)
// * b (16 x 64, MN-major in shared memory); d = a * b where scale_d is 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 f32, across the warpgroup) (+)= a (64 x 16, K-major in shared memory)
// * b (16 x 128, MN-major in shared memory); d = a * b where scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int TP>
__device__ __forceinline__ void wgmma_ss(float (&d)[TP / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (TP == 128)
    wgmma_ss_n128(d, a, b, scale_d);
  else
    wgmma_ss_n64(d, a, b, scale_d);
}

// four 8x8 bf16 matrices from registers to shared memory, row-major (the
// inverse of ldmatrix_x4): the row address of row r of matrix m comes from
// lane 8 m + r, and each lane holds the pair of its mma fragment (row
// lane / 4, columns 2 (lane % 4)..)
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&d)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]) : "memory");
}

// A warp's staging of 8 rows x 32 bf16 columns (four 8-column blocks) between
// the accumulator's layout and 16-byte runs of one row: row r (64 bytes)
// holds block m in 16-byte chunk (m ^ (r >> 1)) & 3, so that the 8 rows of
// one block (stmatrix, ldmatrix) and each quarter-warp's runs fall on
// distinct banks.
__device__ __forceinline__ uint32_t stage_off(int r, int m) {
  return r * 64 + (((m ^ (r >> 1)) & 3) << 4);
}

// The body of both wide kernels. Block i owns the 128 channels of slice
// i % slices (its w rows, resident) and walks the position tiles set,
// set + sets, ... of set i / slices; a tile is TP consecutive rows m = b P +
// p. Warp 8 loads, warp 9 forms each tile's codes (indicator @ codebook for
// the tile's samples and the block's channels) into one of two tables, and
// each of the two consumer warpgroups forms 64 channels x TP positions per
// tile: acc = w . x in f32 over K in 64-deep chunks from the ring, then the
// epilogue. Forward: out = act(acc alpha + beta) code in bf16. Backward:
// with the upstream g, gz = g code [pre > 0] (f32), gza = gz alpha (bf16,
// [N, B, P]), and per channel dbeta = sum gz, dalpha = sum gz acc, summed per
// block in registers, then over the blocks of a slice in set order by the
// slice's last block.
template <int TP, bool BWD>
__device__ __forceinline__ void wide_body(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                          const CUtensorMap* tm_xt, const WideArgs& a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int KC = a.K / 64, N = a.N, B = a.B, P = a.P;
  const uint32_t s_w = smem_addr(smem);
  const uint32_t s_x = s_w + KC * 16384;
  float* sCode = reinterpret_cast<float*>(smem + KC * 16384 + kWideStages * TP * 128);
  unsigned char* stage_base = reinterpret_cast<unsigned char*>(sCode + 2 * kWideMaxSamples *
                                                                        kWideRows);
  unsigned char* bar_base = stage_base + 8 * 512;
  const uint32_t b_full = smem_addr(bar_base), b_empty = b_full + 8 * kWideStages;
  const uint32_t b_w = b_full + 16 * kWideStages, b_cfull = b_w + 8, b_cempty = b_w + 24;
  int* sLast = reinterpret_cast<int*>(bar_base + (2 * kWideStages + 5) * 8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slice = blockIdx.x % a.slices, set = blockIdx.x / a.slices;
  const int n0 = slice * kWideRows;
  const bool gated = a.ind != nullptr;
  const int ns = a.lg_p >= 0 ? TP >> a.lg_p : 1;  // samples of a tile
  // backward, slice 0: thread 0 writes each x chunk it reads on to xt by TMA
  const bool store_xt = BWD && a.store_xt && slice == 0 && tid == 0;

  if (tid == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    mbar_init(b_w, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(b_cfull + 8 * s, 32);    // every lane of the code warp
      mbar_init(b_cempty + 8 * s, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int rw = wq * 16 + g;  // this thread's first row of its warpgroup's 64 (and rw + 8)
  float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};  // backward: dalpha, dbeta of the two rows

  if (warp == 8) {
    // producer: the w slice once, then every tile's x chunks through the ring
    if (lane == 0) {
      mbar_expect_tx(b_w, KC * 16384);
      for (int c = 0; c < KC; ++c) tma_load_2d(s_w + c * 16384, tm_w, 64 * c, n0, b_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = set; tile < a.tiles; tile += a.sets) {
        const long long m0 = (long long)tile * TP;
        const int bt = (int)(m0 / P), pt = (int)(m0 % P);
        for (int c = 0; c < KC; ++c) {
          mbar_wait(b_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(b_full + 8 * stage, TP * 128);
          const uint32_t dst = s_x + stage * TP * 128;
          for (int l = 0; l < a.loads; ++l)
            tma_load_3d(dst + l * 8192, tm_x, pt + 64 * l, 64 * c, bt, b_full + 8 * stage);
          if (++stage == kWideStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (warp == 9) {
    // the codes: lane l takes channels n0 + 4 l .. + 3 for the tile's samples,
    // summed over the modes in order as the other kernels do
    if (gated) {
      int buf = 0;
      uint32_t phase = 0;
      const int nb = n0 + 4 * lane;
      for (int tile = set; tile < a.tiles; tile += a.sets) {
        const int bt = (int)((long long)tile * TP / P);
        float v[kWideMaxSamples][4];
#pragma unroll
        for (int s = 0; s < kWideMaxSamples; ++s)
#pragma unroll
          for (int u = 0; u < 4; ++u) v[s][u] = 0.f;
        // four modes' loads in flight together (past the last mode, zeros:
        // exact, so the sums are the other kernels')
        for (int j0 = 0; j0 < a.modes; j0 += 4) {
          float c[4][4], iv[4][kWideMaxSamples];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + jj;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              c[jj][u] = (j < a.modes && nb + u < N) ? a.cb[(size_t)j * N + nb + u] : 0.f;
#pragma unroll
            for (int s = 0; s < kWideMaxSamples; ++s)
              iv[jj][s] = (j < a.modes && s < ns && bt + s < B)
                              ? a.ind[(size_t)(bt + s) * a.modes + j] : 0.f;
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int s = 0; s < kWideMaxSamples; ++s)
              if (s < ns) {
#pragma unroll
                for (int u = 0; u < 4; ++u) v[s][u] = fmaf(iv[jj][s], c[jj][u], v[s][u]);
              }
        }
        mbar_wait(b_cempty + 8 * buf, phase ^ 1);
        float* tab = sCode + buf * kWideMaxSamples * kWideRows;
#pragma unroll
        for (int s = 0; s < kWideMaxSamples; ++s)
          if (s < ns)
            *reinterpret_cast<float4*>(tab + s * kWideRows + 4 * lane) =
                make_float4(v[s][0], v[s][1], v[s][2], v[s][3]);
        mbar_arrive(b_cfull + 8 * buf);
        if (++buf == 2) {
          buf = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumers: warpgroup wg takes channels n0 + 64 wg ..
    float al[2], be[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wg * 64 + rw + 8 * h;
      al[h] = (a.alpha != nullptr && n < N) ? a.alpha[n] : 1.f;
      be[h] = (a.beta != nullptr && n < N) ? a.beta[n] : 0.f;
    }
    const uint32_t a_base = s_w + wg * 64 * 128;
    unsigned char* stage = stage_base + warp * 512;
    const uint32_t s_stage = smem_addr(stage) + stage_off(lane & 7, lane >> 3);
    // the sample of 8-column block j of a tile: j >> jsh (0 when one sample)
    const int jsh = a.lg_p >= 0 ? a.lg_p - 3 : 5;
    mbar_wait(b_w, 0);
    int stage_i = 0, cbuf = 0;
    uint32_t phase = 0, cphase = 0;
    for (int tile = set; tile < a.tiles; tile += a.sets) {
      const long long m0 = (long long)tile * TP;
      const int bt = (int)(m0 / P), pt = (int)(m0 % P);
      // column col of the tile is sample bt + (col >> lg_p), position col & (P - 1)
      // (several samples), or sample bt, position pt + col
      auto sample_of = [&](int col) { return a.lg_p >= 0 ? bt + (col >> a.lg_p) : bt; };
      auto pos_of = [&](int col) { return a.lg_p >= 0 ? (col & (P - 1)) : pt + col; };
      uint4 gv[2][TP / 32];  // backward: g at this thread's 8-column runs, in flight
      if constexpr (BWD) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < TP / 32; ++q) {
            const int col = 8 * (4 * q + t), b = sample_of(col);
            const int n = n0 + wg * 64 + rw + 8 * h;
            gv[h][q] = (b < B && n < N)
                           ? *reinterpret_cast<const uint4*>(
                                 a.g + ((size_t)b * N + n) * P + pos_of(col))
                           : make_uint4(0u, 0u, 0u, 0u);
          }
      }
      float acc[TP / 2];
      int last = 0;
      for (int c = 0; c < KC; ++c) {
        mbar_wait(b_full + 8 * stage_i, phase);
        const uint32_t xs = s_x + stage_i * TP * 128;
        if (store_xt) {  // one group per chunk
          for (int l = 0; l < a.loads; ++l)
            tma_store_3d(tm_xt, xs + l * 8192, pt + 64 * l, 64 * c, bt);
          bulk_commit();
        }
        // a fence per chunk: with one per tile both kernels ran slower
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_ss<TP>(acc, sw128_desc(a_base + c * 16384 + s * 32),
                       mn_desc(xs + s * 32 * a.W, a.W), c | s);
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();  // the previous chunk's product is done: free its slot
          if (store_xt) bulk_wait_read<1>();  // and its store to xt has read it
          if ((tid & 127) == 0) mbar_arrive(b_empty + 8 * last);
        }
        last = stage_i;
        if (++stage_i == kWideStages) {
          stage_i = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      hold(acc);
      if (store_xt) bulk_wait_read<0>();
      if ((tid & 127) == 0) mbar_arrive(b_empty + 8 * last);
      const float* code = sCode + cbuf * kWideMaxSamples * kWideRows + wg * 64 + rw;
      if (gated) mbar_wait(b_cfull + 8 * cbuf, cphase);

      // epilogue, in f32: acc[4j + 2h + e] is row rw + 8h, column 8j + 2t + e;
      // each 8-row x 32-column group goes through the warp's staging
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wg * 64 + rw + 8 * h;
#pragma unroll
        for (int q = 0; q < TP / 32; ++q) {
          const int col = 8 * (4 * q + t), b = sample_of(col);
          uint32_t gi[4];
          if constexpr (BWD) {  // g back to the accumulator's layout
            *reinterpret_cast<uint4*>(stage + stage_off(g, t)) = gv[h][q];
            __syncwarp();
            ldmatrix_x4(gi, s_stage);
            __syncwarp();
          }
          uint32_t pk[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * q + jj;
            const float cd = gated ? code[(j >> jsh) * kWideRows + 8 * h] : 1.f;
            const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
            // the pre-activation, one expression for both kernels: the
            // backward's ReLU mask is the forward's
            float v0 = fmaf(x0, al[h], be[h]), v1 = fmaf(x1, al[h], be[h]);
            if constexpr (BWD) {
              const __nv_bfloat162 gg = *reinterpret_cast<const __nv_bfloat162*>(&gi[jj]);
              const float g0 = (a.relu && !(v0 > 0.f)) ? 0.f : __low2float(gg) * cd;
              const float g1 = (a.relu && !(v1 > 0.f)) ? 0.f : __high2float(gg) * cd;
              sb[h] += g0;
              sb[h] += g1;
              sa[h] = fmaf(g0, x0, sa[h]);
              sa[h] = fmaf(g1, x1, sa[h]);
              pk[jj] = pack_bf16(g0 * al[h], g1 * al[h]);
            } else {
              if (a.relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              pk[jj] = pack_bf16(v0 * cd, v1 * cd);
            }
          }
          // lane t stores columns 8 (4q + t) .. + 7 of its row: 16 bytes
          stmatrix_x4(s_stage, pk);
          __syncwarp();
          const uint4 o = *reinterpret_cast<const uint4*>(stage + stage_off(g, t));
          __syncwarp();
          if (b < B && n < N) {
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) +
                                 (BWD ? ((size_t)n * B + b) * P : ((size_t)b * N + n) * P) +
                                 pos_of(col);
            *reinterpret_cast<uint4*>(dst) = o;
          }
        }
      }
      if (gated) {
        mbar_arrive(b_cempty + 8 * cbuf);  // this thread has read the table
        if (++cbuf == 2) {
          cbuf = 0;
          cphase ^= 1;
        }
      }
    }
  }

  if constexpr (BWD) {
    // this block's sums per channel (lane t = 0 of each quad holds its row's),
    // then the slice's last block adds the sets' sums in set order
    if (store_xt) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (warp < 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sa[h] += __shfl_xor_sync(0xffffffffu, sa[h], 1);
        sb[h] += __shfl_xor_sync(0xffffffffu, sb[h], 1);
        sa[h] += __shfl_xor_sync(0xffffffffu, sa[h], 2);
        sb[h] += __shfl_xor_sync(0xffffffffu, sb[h], 2);
        const int n = n0 + wg * 64 + rw + 8 * h;
        if (t == 0 && n < N) {
          a.partial[(size_t)set * N + n] = sb[h];
          a.partial[(size_t)(a.sets + set) * N + n] = sa[h];
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *sLast = atomicAdd(a.counters + slice, 1) == a.sets - 1;
    __syncthreads();
    if (*sLast) {
      __threadfence();
      for (int i = tid; i < 2 * kWideRows; i += kWideThreads) {
        const int which = i / kWideRows, n = n0 + i % kWideRows;
        if (n >= N) continue;
        float v = 0.f;
        for (int s = 0; s < a.sets; ++s)
          v += __ldcg(a.partial + (size_t)(which * a.sets + s) * N + n);
        (which == 0 ? a.dbeta : a.dalpha)[n] = v;
      }
      if (tid == 0) a.counters[slice] = 0;  // ready for the next launch
    }
  }
}

template <int TP>
__global__ void __launch_bounds__(kWideThreads, 1)
    mc_gated_matmul_kernel_wide(const __grid_constant__ CUtensorMap tm_x,
                                const __grid_constant__ CUtensorMap tm_w, WideArgs a) {
  wide_body<TP, false>(&tm_x, &tm_w, nullptr, a);
}

template <int TP>
__global__ void __launch_bounds__(kWideThreads, 1)
    mc_gated_matmul_backward_kernel(const __grid_constant__ CUtensorMap tm_x,
                                    const __grid_constant__ CUtensorMap tm_w,
                                    const __grid_constant__ CUtensorMap tm_xt, WideArgs a) {
  wide_body<TP, true>(&tm_x, &tm_w, &tm_xt, a);
}

}  // namespace

template <int KT>
cudaError_t launch_rows(const Args& a, cudaStream_t st) {
  auto kern = mc_gated_matmul_kernel_rows<KT>;
  const size_t smem = rows_smem(KT);
  static_assert(rows_smem(128) <= 48 * 1024, "the rows kernel needs no opt-in");
  const dim3 grid((unsigned)((a.M + 63) / 64), (unsigned)((a.N + 63) / 64));
  kern<<<grid, 128, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wide, host
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

// The tiling of a wide call, the forward's and the backward's alike (the
// backward's ReLU mask relies on it): TP = 128 positions per tile, or 64
// where P is a multiple of 64 but not of 128, or where 128-position tiles
// would leave SMs without one.
struct WidePlan {
  int TP, W, loads, box_b, lg_p, slices, sets, tiles;
};

static WidePlan wide_plan(int M, int N, int P, int sms) {
  WidePlan p;
  p.slices = (N + kWideRows - 1) / kWideRows;
  p.TP = ((P >= 128 && P % 128 != 0) || (long long)p.slices * ((M + 127) / 128) < sms) ? 64 : 128;
  p.W = std::min(P, 64);
  p.loads = P >= p.TP ? p.TP / 64 : 1;
  p.box_b = P >= p.TP ? 1 : p.TP / P;
  p.lg_p = -1;
  if (P < p.TP) {
    p.lg_p = 0;
    while ((1 << p.lg_p) < P) ++p.lg_p;
  }
  p.tiles = (M + p.TP - 1) / p.TP;
  p.sets = std::max(1, std::min(p.tiles, sms / p.slices));
  return p;
}

// The shapes the wide kernels take: bf16, K % 64 == 0 up to 512 (w's slice
// resident), any N (w's rows past N read as zero, their outputs not
// stored), and P in {16, 32} or a multiple of 64 (a swizzle atom of an x
// stage is min(P, 64) positions of one sample).
static bool wide_takes(int M, int N, int K, int P) {
  return K % 64 == 0 && K >= 64 && K <= kWideMaxK && N > 0 && M > 0 &&
         (P == 16 || P == 32 || P % 64 == 0) && M % P == 0;
}

// The SM count and the shared-memory allowance of the four wide kernels,
// set once per device.
static cudaError_t wide_setup(int dev, int* sms) {
  static int count[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    const int bytes = (int)wide_smem(kWideMaxK, 128);
    cudaError_t err = cudaFuncSetAttribute(mc_gated_matmul_kernel_wide<128>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mc_gated_matmul_kernel_wide<64>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mc_gated_matmul_backward_kernel<128>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mc_gated_matmul_backward_kernel<64>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    count[dev] = n;
  }
  *sms = count[dev];
  return cudaSuccess;
}

static cudaError_t wide_plan_here(int M, int N, int P, WidePlan* plan) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = wide_setup(dev, &sms);
  if (err == cudaSuccess) *plan = wide_plan(M, N, P, sms);
  return err;
}

// x [B, K, P] as (P, K, B) in boxes of (W, 64, box_b), swizzled to the
// atom's width; w [N, K] as (K, N) in boxes of (64, 128), 128-byte swizzle.
// Rows past N and samples past B read as zero.
// xt [K, B, P], when given, in x's coordinates (P, K, B) and boxes, so that
// a stage of x in shared memory stores to it as it was loaded.
static cudaError_t wide_maps(const void* x, const void* w, const void* xt, int B, int N, int K,
                             int P, const WidePlan& p, CUtensorMap* tm_x, CUtensorMap* tm_w,
                             CUtensorMap* tm_xt) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t xd[3] = {(cuuint64_t)P, (cuuint64_t)K, (cuuint64_t)B};
  const cuuint64_t xs[2] = {(cuuint64_t)P * 2, (cuuint64_t)K * P * 2};
  const cuuint32_t xb[3] = {(cuuint32_t)p.W, 64, (cuuint32_t)p.box_b};
  const CUtensorMapSwizzle sw = p.W == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : p.W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  if (enc(tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), xd, xs, xb, one,
          CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t ts[2] = {(cuuint64_t)B * P * 2, (cuuint64_t)P * 2};
  if (xt != nullptr &&
      enc(tm_xt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(xt), xd, ts, xb, one,
          CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_NONE,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wd[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t ws[1] = {(cuuint64_t)K * 2};
  const cuuint32_t wb[2] = {64, (cuuint32_t)kWideRows};
  if (enc(tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wd, ws, wb, one,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

static cudaError_t launch_wide(const void* x, const void* w, const void* xt, WideArgs a,
                               bool backward, cudaStream_t st) {
  WidePlan p;
  cudaError_t err = wide_plan_here(a.B * a.P, a.N, a.P, &p);
  CUtensorMap tm_x, tm_w, tm_xt = {};
  if (err == cudaSuccess) err = wide_maps(x, w, xt, a.B, a.N, a.K, a.P, p, &tm_x, &tm_w, &tm_xt);
  if (err != cudaSuccess) return err;
  a.store_xt = xt != nullptr;
  a.W = p.W;
  a.loads = p.loads;
  a.lg_p = p.lg_p;
  a.slices = p.slices;
  a.sets = p.sets;
  a.tiles = p.tiles;
  const unsigned grid = (unsigned)(p.slices * p.sets);
  const size_t smem = wide_smem(a.K, p.TP);
  if (p.TP == 128) {
    if (backward)
      mc_gated_matmul_backward_kernel<128><<<grid, kWideThreads, smem, st>>>(tm_x, tm_w, tm_xt,
                                                                             a);
    else
      mc_gated_matmul_kernel_wide<128><<<grid, kWideThreads, smem, st>>>(tm_x, tm_w, a);
  } else {
    if (backward)
      mc_gated_matmul_backward_kernel<64><<<grid, kWideThreads, smem, st>>>(tm_x, tm_w, tm_xt,
                                                                            a);
    else
      mc_gated_matmul_kernel_wide<64><<<grid, kWideThreads, smem, st>>>(tm_x, tm_w, a);
  }
  return cudaGetLastError();
}

// Which kernel takes a call (see the head of the file): 1 = rows (bf16, P
// = 1, K 64 or 128, N % 8 == 0), 2 = wide (bf16, K % 64 == 0 up to 512, P
// 16, 32 or a multiple of 64: the PixelCNN's eval forward and Glow's K = N
// = 512 among them), both only with x, w and out 16-byte aligned; 0 =
// generic, every other shape. dtype: 0 = f32, 1 = bf16.
extern "C" int mcgm_mc_gated_matmul_variant(int M, int N, int K, int P, int dtype, int aligned) {
  if (dtype != 1 || !aligned || M <= 0 || N <= 0) return 0;
  if ((K == 64 || K == 128) && P == 1 && N % 8 == 0 && (N + 63) / 64 <= 65535) return 1;
  if (wide_takes(M, N, K, P)) return 2;
  return 0;
}

// dtype: 0 = f32, 1 = bf16. The kernel is mcgm_mc_gated_matmul_variant's
// choice. Returns the launch's CUDA error (0 if none).
extern "C" int mcgm_mc_gated_matmul(const void* x, const void* w, const void* alpha,
                                    const void* beta, const void* indicator,
                                    const void* codebook, void* out, int M, int N, int K, int P,
                                    int modes, int relu, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || P <= 0 || M % P != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((indicator == nullptr) != (codebook == nullptr) || (indicator != nullptr && modes <= 0))
    return cudaErrorInvalidValue;
  Args a{x, w, static_cast<const float*>(alpha), static_cast<const float*>(beta),
         static_cast<const float*>(indicator), static_cast<const float*>(codebook), out,
         M, N, K, P, modes, relu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  switch (mcgm_mc_gated_matmul_variant(M, N, K, P, dtype, aligned)) {
    case 1:
      return K == 64 ? launch_rows<64>(a, st) : launch_rows<128>(a, st);
    case 2: {
      WideArgs wa{a.alpha, a.beta, a.ind, a.cb, out, nullptr, nullptr, nullptr, nullptr, nullptr,
                  M / P, N, K, P, modes, relu};
      return launch_wide(x, w, nullptr, wa, false, st);
    }
    default:
      break;
  }
  const long long mblocks = ((long long)M + kTM - 1) / kTM;
  if (mblocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)mblocks, (unsigned)((N + kTN - 1) / kTN));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (dtype == 1)
    mc_gated_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    mc_gated_matmul_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// The scratch of a backward call on the current device: `partial` floats of
// per-block sums (written whole by every launch) and `counters` ints, zero
// before the first launch (each launch leaves them zero).
extern "C" int mcgm_mc_gated_matmul_backward_scratch(int M, int N, int K, int P, int* partial,
                                                     int* counters) {
  if (!wide_takes(M, N, K, P)) return cudaErrorInvalidValue;
  WidePlan p;
  const cudaError_t err = wide_plan_here(M, N, P, &p);
  if (err != cudaSuccess) return err;
  *partial = 2 * p.sets * N;
  *counters = p.slices;
  return cudaSuccess;
}

// One launch: gza [N, B, P] (bf16) = g code [pre > 0] alpha, dalpha and
// dbeta [N] (f32), and, unless xt is null, x copied to xt [K, B, P], for the
// calls whose forward takes the wide kernel (its ReLU mask recomputes the
// forward's pre-activation with the same tiling). x, w, g bf16; alpha,
// beta, indicator, codebook f32 or null as in the forward. Returns the
// launch's CUDA error (0 if none).
extern "C" int mcgm_mc_gated_matmul_backward(const void* x, const void* w, const void* alpha,
                                             const void* beta, const void* indicator,
                                             const void* codebook, const void* g, void* gza,
                                             void* xt, void* dalpha, void* dbeta, void* partial,
                                             void* counters, int M, int N, int K, int P,
                                             int modes, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || P <= 0 || M % P != 0) return cudaErrorInvalidValue;
  if ((indicator == nullptr) != (codebook == nullptr) || (indicator != nullptr && modes <= 0))
    return cudaErrorInvalidValue;
  const bool aligned =
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)g | (uintptr_t)gza | (uintptr_t)xt) % 16 == 0;
  if (mcgm_mc_gated_matmul_variant(M, N, K, P, 1, aligned) != 2) return cudaErrorInvalidValue;
  WideArgs a{static_cast<const float*>(alpha), static_cast<const float*>(beta),
             static_cast<const float*>(indicator), static_cast<const float*>(codebook), gza,
             static_cast<const __nv_bfloat16*>(g), static_cast<float*>(partial),
             static_cast<int*>(counters), static_cast<float*>(dalpha), static_cast<float*>(dbeta),
             M / P, N, K, P, modes, relu};
  return launch_wide(x, w, xt, a, true, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
