// MC-gated 1x1 product of the Gated PixelCNN, for Hopper (sm_90a).
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
// Design: three kernels, one launch per call; the entry point picks one by
// an explicit shape test (mcgm_mc_gated_matmul_variant, also exported so
// that a caller can name it). The bf16 paths of the PixelCNN
// (P = 64 at an eval forward, P = 1 in the sampler, K = 128) run on wgmma
// (m64n64k16, A from registers, B = w from shared memory in the 128-byte
// K-major swizzle, f32 sums), with the whole K in shared memory:
// - samples (bf16, P = 64, K in {64, 128}): each sample is one product
//   out[b]^T [P, N] = x[b]^T [P, K] . w^T [K, N]. The 64-channel chunks of
//   N are split into `groups` contiguous groups (2 at N = 512, K = 128), so
//   that a block keeps at most 64 KB of w resident in shared memory: every
//   block fetches its w from L2 first, and all of it (128 KB) on 132 SMs
//   took ~5 us. Persistent blocks, in sets of `groups`, each set a
//   contiguous run of samples. w is loaded once per block with 16-byte
//   cp.async (rows past N zero); x[b] (16 KB, contiguous) flows through a
//   ring of kStages slots by 16-byte cp.async, so x is read from device
//   memory once (from L2 by each group). Each warp takes 16 positions and
//   loads its A fragments (x[b] transposed) once per sample with
//   ldmatrix.trans; the two warpgroups take alternate chunks. The epilogue
//   runs in f32 registers with alpha, beta and the sample's code (formed
//   for kCodeBatch samples at a time in shared memory, the first batch
//   while w is in flight), rounds once to bf16, and stmatrix.trans writes
//   the [64 channels][64 positions] tile into one of two stage buffers per
//   warpgroup (16-byte chunk (position / 8) ^ (channel % 8), no bank
//   conflicts); out[b] rows are 128 contiguous bytes, so a chunk leaves as
//   8 KB of coalesced 16-byte stores.
// - rows (bf16, P = 1, K in {64, 128}, N % 8 == 0): out [M, N] = x [M, K] .
//   w^T; one 64 x 64 tile per block of one warpgroup, x and w tiles (all of
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
constexpr int kStages = 4;      // x ring of the samples kernel
constexpr int kPos = 64;        // positions per sample there (P)
constexpr int kCodeBatch = 8;   // samples whose codes are formed together there
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// The samples kernel splits the channels' 64-wide chunks into `groups`
// contiguous groups, one per block of a set of `groups` blocks, so that a
// block keeps at most 64 KB of w resident: w is fetched from L2 by every
// block, and at N = 512, K = 128 all of it (128 KB) on 132 SMs took ~5 us.
__host__ __device__ constexpr int samples_groups(int N, int K) {
  return (pad64(N) / 64 * (64 * K * 2) + 65535) / 65536 < pad64(N) / 64
             ? (pad64(N) / 64 * (64 * K * 2) + 65535) / 65536
             : pad64(N) / 64;
}

// channels of one group, padded to 64
__host__ __device__ constexpr int samples_group_rows(int N, int K) {
  return (pad64(N) / 64 + samples_groups(N, K) - 1) / samples_groups(N, K) * 64;
}

// shared memory of the samples kernel: w [K/64][rows][128 B] of the group's
// channels, the x ring [kStages][K][128 B], two staged output chunks
// [64][128 B] per warpgroup, alpha and beta [rows] f32 and two batches of
// kCodeBatch samples' codes [2][kCodeBatch][rows] f32
__host__ __device__ constexpr size_t samples_smem(int N, int K) {
  return (size_t)samples_group_rows(N, K) * K * 2 + (size_t)kStages * K * 128 +
         4 * 64 * 128 + (size_t)(2 + 2 * kCodeBatch) * samples_group_rows(N, K) * 4;
}

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
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// four 8x8 bf16 matrices from registers, each stored transposed: row r of
// matrix m (at the address of lane 8 m + r) receives column r
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&d)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]) : "memory");
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

__device__ __forceinline__ void hold(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory writes of this thread (cp.async included) become visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 128 threads of one warpgroup (barrier id 1 + warpgroup; 0 is __syncthreads)
__device__ __forceinline__ void bar_warpgroup(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
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
__global__ void __launch_bounds__(256, 1) mc_gated_matmul_kernel_samples(Args a, int groups) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int N = a.N, B = a.M / kPos, rows = samples_group_rows(N, KT);
  const int grp = blockIdx.x % groups, sets = gridDim.x / groups, set = blockIdx.x / groups;
  const int n0 = grp * rows, nc = min(rows, pad64(N) - n0) / 64;  // the group's chunks
  const uint32_t s_w = smem_addr(smem);
  const uint32_t s_x = s_w + rows * KT * 2;
  const uint32_t s_stage = s_x + kStages * KT * 128;
  unsigned char* stage_base = smem + rows * KT * 2 + kStages * KT * 128;
  float* sAlpha = reinterpret_cast<float*>(stage_base + 4 * 64 * 128);
  float* sBeta = sAlpha + rows;
  float* sCode = sBeta + rows;  // [2][kCodeBatch][rows]
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* __restrict__ w = static_cast<const __nv_bfloat16*>(a.w);
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(a.out);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int t = lane & 3, pw = warp & 3;
  const int b0 = (int)((long long)set * B / sets);
  const int nb = (int)((long long)(set + 1) * B / sets) - b0;
  if (nb <= 0 || nc <= 0) return;

  // x[b] [K][P] into ring slot `slot`: row k is 128 bytes, chunk c at c ^ (k & 7)
  auto load_x = [&](int slot, int b) {
    const __nv_bfloat16* src = x + (size_t)b * KT * kPos;
    const uint32_t dst = s_x + slot * KT * 128;
    for (int i = tid; i < KT * 8; i += 256) {
      const int k = i >> 3, ch = i & 7;
      cp_async16(dst + k * 128 + ((ch ^ (k & 7)) << 4), src + i * 8);
    }
  };
  // the codes of samples [first, first + kCodeBatch) into batch buffer `buf`:
  // each thread's entries are independent, their loads in flight together
  auto form_codes = [&](int buf, int first) {
    float* dst = sCode + buf * kCodeBatch * rows;
    for (int e0 = tid; e0 < kCodeBatch * rows; e0 += 256 * 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + 256 * u, q = e / rows, r = e - q * rows;
        const bool live = e < kCodeBatch * rows && first + q < b0 + nb;
        v[u] = (live && a.ind != nullptr) ? 0.f : 1.f;
        if (live && a.ind != nullptr && n0 + r >= N) v[u] = 0.f;
      }
      if (a.ind != nullptr) {
#pragma unroll 4
        for (int j = 0; j < a.modes; ++j) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + 256 * u, q = e / rows, r = e - q * rows;
            if (e < kCodeBatch * rows && first + q < b0 + nb && n0 + r < N)
              v[u] = fmaf(a.ind[(long long)(first + q) * a.modes + j],
                          a.cb[(long long)j * N + n0 + r], v[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + 256 * u < kCodeBatch * rows) dst[e0 + 256 * u] = v[u];
    }
  };
  load_w_tile<KT>(s_w, w, n0, rows, N, tid, 256);
  load_x(0, b0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < nb) load_x(s, b0 + s);
    cp_async_commit();
  }
  for (int r = tid; r < rows; r += 256) {
    const int n = n0 + r;
    sAlpha[r] = (a.alpha != nullptr && n < N) ? a.alpha[n] : 1.f;
    sBeta[r] = (a.beta != nullptr && n < N) ? a.beta[n] : 0.f;
  }
  form_codes(0, b0);  // while w and the first samples are in flight

  // this thread's stmatrix rows: matrix m of the x4 number q is channels
  // 16 q + 8 (m >> 1).. and positions 16 pw + 8 (m & 1)..; row r = lane & 7
  uint32_t st_off[4];
  {
    const int m = lane >> 3, r = lane & 7;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      st_off[q] = (16 * q + 8 * (m >> 1) + r) * 128 + (((2 * pw + (m & 1)) ^ r) << 4);
  }
  int chunks_done = 0;  // this warpgroup's chunks so far: its stage buffer
  for (int i = 0; i < nb; ++i) {
    const int b = b0 + i;
    cp_async_wait<kStages - 2>();  // sample i's group (and w's, with the first) landed
    fence_proxy_async();
    __syncthreads();  // copies and codes visible; sample i - 1's slot consumed
    if (i + kStages - 1 < nb) load_x((i + kStages - 1) % kStages, b + kStages - 1);
    cp_async_commit();

    // A: x[b]^T, this warp's 16 positions x all of K (ldmatrix.trans of the
    // [k][p] slot: matrix j of the x4 is k rows 8 (j >> 1).., p chunk 2 pw + (j & 1))
    uint32_t af[KT / 16][4];
    {
      const uint32_t xs = s_x + (i % kStages) * KT * 128;
      const int mj = lane >> 3, r = lane & 7, pc = 2 * pw + (mj & 1);
#pragma unroll
      for (int s = 0; s < KT / 16; ++s) {
        const int k = 16 * s + r + (mj >> 1) * 8;
        ldmatrix_x4_trans(af[s], xs + k * 128 + ((pc ^ (k & 7)) << 4));
      }
    }
    const float* code = sCode + ((i / kCodeBatch) & 1) * kCodeBatch * rows +
                        (i % kCodeBatch) * rows;
    for (int c = wg; c < nc; c += 2) {
      float acc[32];
      mma_issue<KT>(acc, af, s_w, rows, c * 64);
      wgmma_wait<0>();
      hold(acc);
      // f32 epilogue; acc[4j + 2h + e] is position 16 pw + g + 8h, channel
      // 8j + 2t + e of the chunk; bf16 pairs of channels, stored transposed
      // by stmatrix into the stage [channel][position] (16-byte chunk
      // (position >> 3) ^ (channel & 7)), one of this warpgroup's two
      uint32_t pk[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = c * 64 + 8 * j + 2 * t;
        const float2 al = *reinterpret_cast<const float2*>(sAlpha + r);
        const float2 be = *reinterpret_cast<const float2*>(sBeta + r);
        const float2 cd = *reinterpret_cast<const float2*>(code + r);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h] * al.x + be.x, v1 = acc[4 * j + 2 * h + 1] * al.y + be.y;
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          pk[2 * j + h] = pack_bf16(v0 * cd.x, v1 * cd.y);
        }
      }
      const int buf = 2 * wg + (chunks_done & 1);
      const uint32_t st = s_stage + buf * 64 * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // matrices (j, h) = (2q + (m >> 1), m & 1)
        const uint32_t d[4] = {pk[4 * q], pk[4 * q + 1], pk[4 * q + 2], pk[4 * q + 3]};
        stmatrix_x4_trans(st + st_off[q], d);
      }
      // the stage is written; this buffer's previous stores (two chunks back)
      // were read before every warp of the warpgroup reached this point
      bar_warpgroup(wg);
      const unsigned char* stage = stage_base + buf * 64 * 128;
      for (int e = tid & 127; e < 64 * 8; e += 128) {
        const int row = e >> 3, chk = e & 7, n = n0 + c * 64 + row;
        if (n < N) {
          const uint4 v = *reinterpret_cast<const uint4*>(stage + row * 128 +
                                                          ((chk ^ (row & 7)) << 4));
          *reinterpret_cast<uint4*>(out + ((size_t)b * N + n) * kPos + chk * 8) = v;
        }
      }
      ++chunks_done;
    }
    hold(af);
    // the next batch's codes, into the buffer the batch before this one used
    if ((i + 1) % kCodeBatch == 0 && i + 1 < nb) form_codes(((i + 1) / kCodeBatch) & 1, b + 1);
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

}  // namespace

// The samples kernel's SM count and shared-memory allowance, set once per
// device and K.
template <int KT>
cudaError_t samples_setup(int dev, int* sms) {
  static int count[64];
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(mc_gated_matmul_kernel_samples<KT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  return cudaSuccess;
}

template <int KT>
cudaError_t launch_samples(const Args& a, cudaStream_t st) {
  auto kern = mc_gated_matmul_kernel_samples<KT>;
  const size_t smem = samples_smem(a.N, KT);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = samples_setup<KT>(dev, &sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 256, smem);
  if (err != cudaSuccess) return err;
  // sets of `groups` blocks, each set a contiguous run of samples
  const int groups = samples_groups(a.N, KT), B = a.M / kPos;
  const long long sets = std::min<long long>(B, std::max(1LL, (long long)sms * per_sm / groups));
  kern<<<(unsigned)(sets * groups), 256, smem, st>>>(a, groups);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_rows(const Args& a, cudaStream_t st) {
  auto kern = mc_gated_matmul_kernel_rows<KT>;
  const size_t smem = rows_smem(KT);
  static_assert(rows_smem(128) <= 48 * 1024, "the rows kernel needs no opt-in");
  const dim3 grid((unsigned)((a.M + 63) / 64), (unsigned)((a.N + 63) / 64));
  kern<<<grid, 128, smem, st>>>(a);
  return cudaGetLastError();
}

// Which kernel takes a call (see the head of the file): 1 = samples (bf16,
// P = 64, K 64 or 128, its shared memory within a block's), 2 = rows (bf16,
// P = 1, K 64 or 128, N % 8 == 0), both only with x, w and out 16-byte
// aligned; 0 = generic, every other shape. dtype: 0 = f32, 1 = bf16.
extern "C" int mcgm_mc_gated_matmul_variant(int M, int N, int K, int P, int dtype, int aligned) {
  if (dtype != 1 || !aligned || (K != 64 && K != 128) || M <= 0 || N <= 0) return 0;
  if (P == kPos && samples_smem(N, K) <= kSmemMax) return 1;
  if (P == 1 && N % 8 == 0 && (N + 63) / 64 <= 65535) return 2;
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
      return K == 64 ? launch_samples<64>(a, st) : launch_samples<128>(a, st);
    case 2:
      return K == 64 ? launch_rows<64>(a, st) : launch_rows<128>(a, st);
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

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
