// Nearest-code search of the VQ-VAE's vector quantizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel vq_assign of mcgm_tpu/ops/pallas_kernels.py (at
// commit 0303c43: `_vq_assign_kernel`, called through `pl.pallas_call`),
// whose live form is the XLA code of mcgm_tpu/ops/vq.py::VectorQuantizerEMA
// (`dist = |x|^2 - 2 x.e + |e|^2`, `argmin`, then `embedding.T[code]`):
//
//   idx[n]  = argmin_k (|x_n|^2 - 2 x_n . e_k) + |e_k|^2    (lowest k on ties)
//   q[n, :] = emb[:, idx[n]]                                 (optional)
//
// x [N, D] f32 row-major, emb [D, K] f32 row-major (the codebook's columns
// are the codes), idx [N] int32, q [N, D] f32 or null; rescored two ints on
// the device or null (see below).
//
// Bound on an H100 SXM at the VQ-VAE's train shape (N = 128 x 8 x 8 = 8,192,
// D = 64, K = 512): 268 M multiply-adds, 1.1 us at the 495 TFLOP/s TF32
// tensor-core peak (8.0 us at the 67 TFLOP/s f32 peak of the CUDA cores);
// bytes 4.2 MB (x and q 2.1 MB each, the codebook 128 KB), 1.3 us at
// 3.35 TB/s. So on the tensor cores the bytes bound it.
//
// Two kernels; the entry point picks one by the shape alone
// (mcgm_vq_assign_variant, exported so that a caller can name it):
//
// tf32 (D % 8 == 0, D <= 256, any K): the cross term on the tensor cores, a
// screen, and an exact f32 decision of the rows the screen cannot decide.
// - Persistent blocks of three warpgroups, one per SM; a block takes tiles
//   of 64 rows in turn. The codebook is transposed on its way into shared
//   memory (each code's D floats in a row, K-major, the 128-byte swizzle
//   that wgmma reads) and |e_k|^2 formed from it: once per
//   block when it fits (D 64, K 512: 128 KB), else in chunks of codes
//   reloaded per tile. Warpgroups 0 and 1 screen; warpgroup 2 loads the
//   rows (cp.async), forms |x|^2 and the rows rounded to TF32, then decides
//   a tile, rescores it and writes it out. With the codebook resident they
//   form a pipeline over the tiles, the tiles' rows in three buffers: tile
//   i is screened while tile i - 1 is decided and tile i + 1's rows load.
// - The screen: wgmma.m64n128k8.f32.tf32 of the tile's rounded rows (A) by
//   128 codes (B), both from shared memory; the two warpgroups take
//   alternate tiles of 128 codes, warpgroup 1 starting when warpgroup 0's
//   first product is done, so that each product after the first runs
//   during the other's epilogue. The epilogue forms per (row, code) the
//   lower bound L_k below (shifted to be >= 0, the code's place in the
//   thread's tile packed into the low 5 bits of its mantissa, so that
//   plain float min / max order by (value, place)) and keeps the three
//   least per row; threads, then warpgroups, merge by (value, code).
// - The bound. The rows are rounded to the nearest TF32 value (relative
//   error <= 2^-11), the tensor cores cut the codebook's low 13 mantissa
//   bits (< 2^-10) and sum in f32. With a = |x|, n_k = |e_k| and s_k =
//   |e_k|^2 - 2 x.e_k exact, the screened value obeys
//     |s^_k - s_k| <= alpha a n_k + beta n_k^2,
//     alpha = 3 2^-10 (1 + 2^-10) + (D + 16) 2^-21,  beta = (D + 8) 2^-24
//   (2 x the product's 3 2^-11 + 2^-21, the f32 sums of the tensor cores,
//   of |e|^2 and of the fmas that form s^, with room for the f32
//   evaluation of the rule; when the codebook is chunked the rows are cut
//   too, and 2^-8 takes the place of 3 2^-10). So L_k = s^_k - alpha a n_k
//   - beta n_k^2 <= s_k <= L_k + w_k, w_k = 2 (alpha a n_k + beta n_k^2):
//   each code's own norm sets its width, and a codebook whose unused
//   columns are ~1/eps larger (a train step's, after an EMA update) widens
//   nothing for the codes in reach.
// - The decision, per row, with L_1 <= L_2 <= L_3 the three least (codes
//   k1, k2): if L_2 > L_1 + w_k1, k1 is the exact argmin (every other s_k
//   >= L_k >= L_2 > s_k1); else if L_3 > L_1 + w_k1, the argmin is k1 or
//   k2, and their exact f32 distances decide (a warp a row); else the row
//   is rescored against every code. (2^-16 of the values is added to each
//   margin for the packed places.) On random N(0, 1) rows at D 64 about
//   one row in sixteen goes to k1 or k2 and one in 250 to every code.
// - The exact distance, on the CUDA cores from the shared copies of the
//   exact rows and the codebook: dist = (|x|^2 - 2 x.e) + |e|^2, x.e summed
//   over d in a fixed order; every code: the rows 8 at a time, each thread
//   its codes in increasing order, merged by (dist, k), so the lowest
//   index wins ties, as the plain version's argmin. `rescored`, if not
//   null, gains the rows decided in f32: [0] those against every code, [1]
//   those by their two best codes (counts for the checks; the main path
//   passes null). No order in the kernel changes from run to run.
// - q is gathered from the shared codebook with 16-byte stores (when the
//   codebook is chunked, from device memory).
//
// ffma (every other D): a blocked f32 matrix product on the CUDA cores with
// the argmin in its epilogue. A block of 256 threads (16 x 16) takes 64
// rows of x, held transposed in shared memory with their |x|^2, and walks
// the codebook in tiles of 64 codes; each thread forms a 4 rows x 4 codes
// tile of dot products and keeps per row the best (distance, code) of its
// codes, visited in increasing order; the 16 threads of a row reduce by
// warp shuffles by (distance, code). q is gathered from device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

// The phase probe (python -m mcgm_tpu_torch.bench.vq_assign_phases) builds
// this file with -DVQ_ASSIGN_PHASES: at each PHASE(k) the first thread of a
// warpgroup adds the SM cycles since its last mark to phase k's total of
// its warpgroup, g_phase[k + 8 warpgroup], which mcgm_vq_assign_phases
// reads and clears. Without the macro the marks are empty.
#ifdef VQ_ASSIGN_PHASES
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

namespace {

constexpr int kMaxD = 256;

// ------------------------------------------------------------------ ffma
constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 64;        // codes per tile
constexpr int kThreads = 256;  // 16 x 16; each thread a 4 x 4 tile
constexpr int kLdx = kBM + 4;  // row stride of the transposed x tile (16-byte rows)

__host__ __device__ constexpr size_t ffma_smem(int D) {
  return sizeof(float) * ((size_t)D * kLdx + (size_t)D * kBN + kBN + kBM) + sizeof(int) * kBM;
}

__global__ void __launch_bounds__(kThreads)
    vq_assign_kernel_ffma(const float* __restrict__ x, const float* __restrict__ emb,
                          int* __restrict__ idx, float* __restrict__ q, int N, int D, int K) {
  extern __shared__ float4 smem4[];
  float* sX = reinterpret_cast<float*>(smem4);  // [D][kLdx], x transposed
  float* sE = sX + D * kLdx;                    // [D][kBN], one tile of codes
  float* sEsq = sE + D * kBN;                   // [kBN]
  float* sXsq = sEsq + kBN;                     // [kBM]
  int* sIdx = reinterpret_cast<int*>(sXsq + kBM);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * kBM;

  for (int i = tid; i < kBM * D; i += kThreads) {
    const int r = i / D, d = i - r * D, row = row0 + r;
    sX[d * kLdx + r] = row < N ? x[(long long)row * D + d] : 0.f;
  }
  __syncthreads();
  if (tid < kBM) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = sX[d * kLdx + tid];
      s += v * v;
    }
    sXsq[tid] = s;
  }

  float best[4];
  int bestk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    bestk[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += kBN) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < D * kBN; i += kThreads) {
      const int d = i / kBN, c = i - d * kBN, k = k0 + c;
      sE[i] = k < K ? emb[(long long)d * K + k] : 0.f;
    }
    __syncthreads();
    if (tid < kBN) {
      float s = 0.f;
      for (int d = 0; d < D; ++d) {
        const float v = sE[d * kBN + tid];
        s += v * v;
      }
      sEsq[tid] = s;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(sX + d * kLdx + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(sE + d * kBN + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // sEsq (and, on the first tile, sXsq) written
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xsq = sXsq[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx * 4 + j;
        const float dist = (xsq - 2.f * acc[i][j]) + sEsq[tx * 4 + j];
        if (k < K && dist < best[i]) {
          best[i] = dist;
          bestk[i] = k;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float b = best[i];
    int k = bestk[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {  // the 16 threads of this row
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const int ok = __shfl_xor_sync(0xffffffffu, k, off);
      if (ob < b || (ob == b && ok < k)) {
        b = ob;
        k = ok;
      }
    }
    if (tx == 0) sIdx[ty * 4 + i] = k;
  }
  __syncthreads();
  for (int r = tid; r < kBM; r += kThreads)
    if (row0 + r < N) idx[row0 + r] = sIdx[r];
  if (q != nullptr) {
    for (int i = tid; i < kBM * D; i += kThreads) {
      const int r = i / D, d = i - r * D, row = row0 + r;
      if (row < N) q[(long long)row * D + d] = emb[(long long)d * K + sIdx[r]];
    }
  }
}

// ------------------------------------------------------------------ tf32
constexpr int kRows = 64;          // rows of x per tile: wgmma's M
constexpr int kTileCodes = 128;    // codes per wgmma: its N
constexpr int kScreenThreads = 256;  // warpgroups 0 and 1: the screen
constexpr int kPostThreads = 128;    // warpgroup 2: rows in, decisions and rows out
constexpr int kTcThreads = kScreenThreads + kPostThreads;
constexpr int kPostWarps = kPostThreads / 32;
constexpr int kBatch = 8;          // rows rescored against every code together, at most
constexpr int kLoadUnroll = 8;     // 16-byte units of the codebook in flight per thread
constexpr int kSmemMax = 232448;   // a block's shared memory on sm_90
static_assert(kPostThreads == 2 * kRows, "two threads per row form |x|^2");
// named barriers (0 is __syncthreads): the screen's stagger; a tile's rows
// in, and its screen done (one of each per tile parity); warpgroup 2's
// own; the screen's own (chunks); warpgroup 2 done with a tile (chunks)
enum : int {
  kBarStagger = 1,
  kBarRowsIn = 2,
  kBarScreened = 4,
  kBarPost = 6,
  kBarScreen = 7,
  kBarPosted = 8
};

// Per row of a tile, and the rescoring's lists and partial results; what
// the screen of one tile and the decision of the one before share, per
// tile parity.
struct Misc {
  float4 other[2][2][kRows];   // [parity][warpgroup][row]: the screen's (L'_1, k1, |e_k1|, L'_2)
  float2 other2[2][2][kRows];  // and (k2, L'_3)
  float xsq[2][kRows];         // [parity][row]: |x|^2
  int code[kRows];      // the chosen code
  int list[kRows];      // the rows for every code, in row order
  int plist[kRows];     // the rows for their two best, in row order
  int k2[kRows];        // a row's second-best code
  float bv[kRows];      // per undecided row, the least exact distance so far
  int bk[kRows];        // and its code
  float rv[kPostWarps][kBatch];  // per warp, a batch's best
  int rk[kPostWarps][kBatch];
  int nflag, npair;
};

// Shared memory: the codebook chunk [dp / 32][kc][128 B];
// row tiles of x [dp / 32][64][128 B], exact (three when resident, else
// one) and, when resident, two rounded to TF32 for wgmma; per code |e|^2
// and (|e|^2 (1 - beta), |e|) [kc]; Misc.
__host__ __device__ constexpr size_t tc_smem(int dp, int kc, bool resident) {
  return (size_t)kc * dp * 4 + (size_t)(resident ? 5 : 1) * kRows * dp * 4 + (size_t)kc * 12 +
         sizeof(Misc);
}

struct Plan {
  int dp;      // D rounded up to 32: a row is dp / 32 swizzle atoms of 128 bytes
  int kc;      // codes per chunk in shared memory, a multiple of kTileCodes
  int chunks;  // 1: the codebook is resident for the whole launch
  size_t smem;
};

// The whole codebook if it fits beside five row tiles, else chunks of the
// most codes that fit beside one.
Plan tc_plan(int D, int K) {
  Plan p{};
  p.dp = (D + 31) / 32 * 32;
  const long long kpad = ((long long)K + kTileCodes - 1) / kTileCodes * kTileCodes;
  const long long per_code = (long long)p.dp * 4 + 12;
  long long kc = kpad;
  if ((long long)tc_smem(p.dp, 0, true) + kpad * per_code > kSmemMax) {
    const long long room = kSmemMax - (long long)tc_smem(p.dp, 0, false);
    kc = std::min(kpad, room / per_code / kTileCodes * kTileCodes);
  }
  p.kc = (int)kc;
  p.chunks = kc > 0 ? (int)((kpad + kc - 1) / kc) : 0;
  p.smem = tc_smem(p.dp, p.kc, p.chunks == 1);
  return p;
}

struct TcArgs {
  const float* x;
  const float* emb;
  int* idx;
  float* q;
  int* rescored;
  int N, D, K, tiles;
  int dp, kc, chunks;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk ch (floats 4 ch .. 4 ch + 3 of D) of row
// r in a K-major [dp / 32][rows][128 B] tile in the 128-byte swizzle (chunk c
// of a 128-byte row at c ^ (r & 7)).
__device__ __forceinline__ uint32_t swz(int r, int ch, int rows) {
  return (uint32_t)((ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ float4 lds4(const unsigned char* base, uint32_t off) {
  return *reinterpret_cast<const float4*>(base + off);
}

// 16 bytes, or 16 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
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

// Shared-memory writes of this thread (cp.async included) become visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The bits of v rounded to the nearest TF32 value (ties away from zero;
// finite v): the low 13 bits of the mantissa cleared, the carry into the
// exponent kept.
__device__ __forceinline__ uint32_t tf32_rna_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// wgmma operand: a K-major tile in the 128-byte swizzle (8-row groups 1024
// bytes apart), 1024-aligned at its atom; the k-step's 32 bytes start at addr.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
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

// Barrier `id` (0 is __syncthreads) of `count` threads: wait for it, or
// only arrive at it.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d (64 x 128 f32, across the warpgroup) = a (64 x 8, smem) * b (8 x 128, smem) (+ d if
// accumulate), TF32
__device__ __forceinline__ void wgmma_tf32_64x128x8(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Keeps the accumulator live and in place until this point (after the wait
// that retires the wgmma writing it).
__device__ __forceinline__ void hold(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The screen's state of a row over a set of codes: the least L (b1, code
// k1, |e_k1| n1), the second-least (b2, k2) by (L, code), the third-least
// value b3.
struct Best3 {
  float b1, n1, b2, b3;
  int k1, k2;
};

__device__ __forceinline__ bool before(float v, int k, float ov, int ok) {
  return v < ov || (v == ov && k < ok);
}

// s <- the state over both sets of codes
__device__ __forceinline__ void merge_best(Best3& s, Best3 o) {
  if (before(o.b1, o.k1, s.b1, s.k1)) {
    const Best3 t = s;
    s = o;
    o = t;
  }
  if (before(o.b1, o.k1, s.b2, s.k2)) {
    s.b3 = fminf(s.b2, o.b2);
    s.b2 = o.b1;
    s.k2 = o.k1;
  } else {
    s.b3 = fminf(s.b3, o.b1);
  }
}

__device__ __forceinline__ Best3 shfl_xor(const Best3& s, int off) {
  Best3 o;
  o.b1 = __shfl_xor_sync(0xffffffffu, s.b1, off);
  o.n1 = __shfl_xor_sync(0xffffffffu, s.n1, off);
  o.b2 = __shfl_xor_sync(0xffffffffu, s.b2, off);
  o.b3 = __shfl_xor_sync(0xffffffffu, s.b3, off);
  o.k1 = __shfl_xor_sync(0xffffffffu, s.k1, off);
  o.k2 = __shfl_xor_sync(0xffffffffu, s.k2, off);
  return o;
}

__device__ __forceinline__ void best_of(float& v, int& k, float ov, int ok) {
  if (before(ov, ok, v, k)) {
    v = ov;
    k = ok;
  }
}

// One step of the exact dot product: the 4 floats of chunk ch, d in order.
__device__ __forceinline__ float dot4(float acc, float4 v, float4 e) {
  return fmaf(v.w, e.w, fmaf(v.z, e.z, fmaf(v.y, e.y, fmaf(v.x, e.x, acc))));
}

// The exact f32 distance as the rescoring forms it: (|x|^2 - 2 x.e) + |e|^2
__device__ __forceinline__ float exact_dist(float xsq, float dot, float esq) {
  return fmaf(-2.f, dot, xsq) + esq;
}

// The error bound's constants (see the head of the file): alpha with x
// rounded to TF32 (resident) or cut by the tensor cores (chunked).
__device__ __forceinline__ float bound_alpha(int D, bool x_rounded) {
  return (x_rounded ? 3.f * 0x1p-10f : 0x1p-8f) * (1.f + 0x1p-10f) + (float)(D + 16) * 0x1p-21f;
}
__device__ __forceinline__ float bound_beta(int D) { return (float)(D + 8) * 0x1p-24f; }
constexpr float kGrow = 1.f + 0x1p-16f;  // over the f32 norms' own rounding
constexpr float kPastK = 0x1p120f;        // the screen's |e|^2 of a code past K

// Barrier `id` of `count` threads; 0 is __syncthreads.
__device__ __forceinline__ void group_sync(int id, int count) {
  if (id == 0)
    __syncthreads();
  else
    named_barrier_sync(id, count);
}

__global__ void __launch_bounds__(kTcThreads, 1) vq_assign_kernel_tf32(TcArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const bool resident = a.chunks == 1;
  const int xbytes = kRows * a.dp * 4;
  unsigned char* s_cb = smem;
  unsigned char* s_x0 = smem + (size_t)a.kc * a.dp * 4;
  unsigned char* s_xr0 = s_x0 + 3 * (size_t)xbytes;  // resident: the rounded tiles
  float* s_esq = reinterpret_cast<float*>(s_x0 + (size_t)(resident ? 5 : 1) * xbytes);
  float2* s_en = reinterpret_cast<float2*>(s_esq + a.kc);
  Misc& m = *reinterpret_cast<Misc*>(s_en + a.kc);
  const float* __restrict__ emb = a.emb;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int nq = a.D >> 2;  // 16-byte chunks of a row of x or of a code
  const float alpha = bound_alpha(a.D, resident), beta = bound_beta(a.D);
  PHASE_START;
  auto tile_of = [&](int it) { return (int)blockIdx.x + it * (int)gridDim.x; };
  // tile it's rows: three buffers when resident (tile it + 2 loads while
  // it + 1 waits and it is screened), else one
  auto xbuf = [&](int it) { return s_x0 + (size_t)(resident ? it % 3 : 0) * xbytes; };

  // codes [lo, hi) of the chunk at code cb0 transposed into the codebook
  // tile (codes past K zero), by threads [t0, t0 + n)
  auto load_codes = [&](int cb0, int lo, int hi, int t0, int n) {
    const int kv = min(a.kc, a.K - cb0), nc = hi - lo, units = nq * nc;
    for (int u0 = tid - t0; u0 < units; u0 += n * kLoadUnroll) {
      float4 v[kLoadUnroll];
#pragma unroll
      for (int i = 0; i < kLoadUnroll; ++i) {  // consecutive threads on consecutive codes
        const int u = u0 + i * n, ch = u / nc, c = lo + u - ch * nc;
        v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (u < units && c < kv) {
          const float* src = emb + (size_t)(4 * ch) * a.K + cb0 + c;
          v[i] = make_float4(__ldg(src), __ldg(src + a.K), __ldg(src + 2 * (size_t)a.K),
                             __ldg(src + 3 * (size_t)a.K));
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadUnroll; ++i) {
        const int u = u0 + i * n, ch = u / nc, c = lo + u - ch * nc;
        if (u < units) *reinterpret_cast<float4*>(s_cb + swz(c, ch, a.kc)) = v[i];
      }
    }
  };
  // a chunk and its codes' |e|^2 and (|e|^2 (1 - beta), |e| kGrow) (past K:
  // +inf, and kPastK and 0, so that they never win), by threads [t0, t0 +
  // n) with barrier `bar`
  auto load_chunk = [&](int cb0, int t0, int n, int bar) {
    load_codes(cb0, 0, a.kc, t0, n);
    fence_proxy_async();
    group_sync(bar, n);
    const int kv = min(a.kc, a.K - cb0);
    for (int c = tid - t0; c < a.kc; c += n) {
      float s = 0.f;
      for (int ch = 0; ch < nq; ++ch) {
        const float4 v = lds4(s_cb, swz(c, ch, a.kc));
        s = fmaf(v.x, v.x, s);
        s = fmaf(v.y, v.y, s);
        s = fmaf(v.z, v.z, s);
        s = fmaf(v.w, v.w, s);
      }
      s_esq[c] = c < kv ? s : INFINITY;
      s_en[c] = c < kv ? make_float2(s * (1.f - beta), sqrtf(s) * kGrow)
                       : make_float2(kPastK, 0.f);
    }
    group_sync(bar, n);
  };

  // warpgroup 2 loads the rows, by 16-byte cp.async (rows past N zero)
  const int u = tid - kScreenThreads, uw = u >> 5;
  auto load_x = [&](int it) {
    const uint32_t dst = smem_addr(xbuf(it));
    const int row0 = tile_of(it) * kRows;
    for (int i = u; i < kRows * nq; i += kPostThreads) {
      const int r = i / nq, ch = i - r * nq, row = row0 + r;
      cp_async16(dst + swz(r, ch, kRows), a.x + (size_t)min(row, a.N - 1) * a.D + ch * 4,
                 row < a.N);
    }
  };
  if (resident) {  // the first two tiles' rows load beside the codebook
    if (wg == 2) {
      if (tile_of(0) < a.tiles) load_x(0);
      cp_async_commit();
      if (tile_of(1) < a.tiles) load_x(1);
      cp_async_commit();
    }
    load_chunk(0, 0, kTcThreads, 0);
  }
  PHASE(7);  // the codebook staged

  if (wg < 2) {
    // ---------------------------------------------------------- the screen
    for (int it = 0; tile_of(it) < a.tiles; ++it) {
      const int p = it & 1;
      if (!resident && it > 0) named_barrier_sync(kBarPosted, kTcThreads);  // chunks free
      named_barrier_sync(kBarRowsIn + p, kTcThreads);
      PHASE(0);  // waiting for the tile's rows
      const unsigned char* s_x = xbuf(it);
      // rows r0 + 8 h of this thread, its codes 8 j + 2 t + e of each of its
      // warpgroup's tiles of 128. L_k = |e_k|^2 (1 - beta) - 2 x.e_k - alpha
      // |x| |e_k| <= the exact s_k; shifted by C = |x|^2 (1 + 4 alpha) it is
      // >= 0, so its bits order as its value, and the low 5 carry the code's
      // place in the thread's tile (2 j + e): a tile's three least are three
      // min / max chains, merged into st[h] (Best3, codes decoded) per tile
      const int r0 = 16 * (warp & 3) + g;
      float cr[2], cc[2];
      Best3 st[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float xsq = m.xsq[p][r0 + 8 * h];
        cr[h] = alpha * sqrtf(xsq) * kGrow;
        cc[h] = xsq * (kGrow * kGrow) * (1.f + 4.f * alpha);
        st[h] = Best3{INFINITY, 0.f, INFINITY, INFINITY, 0, 0};
      }
      // A: the rows rounded to TF32 (resident), else as the tensor cores cut them
      const uint32_t xa = smem_addr(resident ? s_xr0 + (size_t)p * xbytes : s_x);
      for (int c = 0; c < a.chunks; ++c) {
        const int cb0 = c * a.kc;
        if (!resident) {
          if (c > 0) named_barrier_sync(kBarScreen, kScreenThreads);  // the last is consumed
          load_chunk(cb0, 0, kScreenThreads, kBarScreen);
        }
        const int kv = min(a.kc, a.K - cb0);
        auto issue = [&](float(&acc)[64], int j0) {  // acc is written by the first k-step
          const uint32_t ca = smem_addr(s_cb) + j0 * 128;
          wgmma_fence();
          for (int s = 0; s < (a.D >> 3); ++s)
            wgmma_tf32_64x128x8(acc, sw128_desc(xa + (s >> 2) * kRows * 128 + (s & 3) * 32),
                                sw128_desc(ca + (s >> 2) * a.kc * 128 + (s & 3) * 32), s > 0);
          wgmma_commit();
        };
        // acc[4 j + 2 h + e]: row r0 + 8 h, code j0 + 8 j + 2 t + e
        auto epilogue = [&](float(&acc)[64], int j0) {
          float t1[2], t2[2], t3[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) t1[h] = t2[h] = t3[h] = INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float4 en = *reinterpret_cast<const float4*>(s_en + j0 + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float esq = e ? en.z : en.x, nk = e ? en.w : en.y;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float l =
                    fmaf(-cr[h], nk, fmaf(-2.f, acc[4 * j + 2 * h + e], esq + cc[h]));
                const float v = __uint_as_float((__float_as_uint(l) & ~31u) | (2 * j + e));
                t3[h] = fminf(t3[h], fmaxf(t2[h], v));
                t2[h] = fminf(t2[h], fmaxf(t1[h], v));
                t1[h] = fminf(t1[h], v);
              }
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // decode: the place's code and |e|
            const uint32_t p1 = __float_as_uint(t1[h]) & 31u, p2 = __float_as_uint(t2[h]) & 31u;
            const int c1 = j0 + 8 * (p1 >> 1) + 2 * t + (p1 & 1);
            const int c2 = j0 + 8 * (p2 >> 1) + 2 * t + (p2 & 1);
            merge_best(st[h], Best3{t1[h], s_en[c1].y, t2[h], t3[h], cb0 + c1, cb0 + c2});
          }
        };
        // warpgroup 1 starts when warpgroup 0's first product is done, so
        // that each product after the first runs during the other's epilogue
        if (c == 0 && wg == 1) named_barrier_sync(kBarStagger, kScreenThreads);
        for (int j0 = wg * kTileCodes; j0 < kv; j0 += 2 * kTileCodes) {
          float acc[64];
          issue(acc, j0);
          wgmma_wait<0>();
          hold(acc);
          if (c == 0 && wg == 0 && j0 == 0) named_barrier_arrive(kBarStagger, kScreenThreads);
          epilogue(acc, j0);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)  // the four threads of the row
          merge_best(st[h], shfl_xor(st[h], off));
      if (t == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const Best3& b = st[h];
          m.other[p][wg][r0 + 8 * h] = make_float4(b.b1, __int_as_float(b.k1), b.n1, b.b2);
          m.other2[p][wg][r0 + 8 * h] = make_float2(__int_as_float(b.k2), b.b3);
        }
      PHASE(1);  // the screen
      named_barrier_arrive(kBarScreened + p, kTcThreads);
    }
    return;
  }

  // ------------------------------------------ warpgroup 2: rows in and out
  auto post_sync = [&]() { named_barrier_sync(kBarPost, kPostThreads); };
  // tile it's rows have landed: their |x|^2 (two threads a row, in a fixed
  // order) and, when resident, their copy rounded to TF32; then the screen
  // may start
  auto rows_in = [&](int it) {
    post_sync();
    const unsigned char* s_x = xbuf(it);
    unsigned char* s_xr = s_xr0 + (size_t)(it & 1) * xbytes;
    const int r = u >> 1, part = u & 1;
    float s = 0.f;
    for (int ch = part; ch < nq; ch += 2) {
      const float4 v = lds4(s_x, swz(r, ch, kRows));
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
      if (resident)
        *reinterpret_cast<uint4*>(s_xr + swz(r, ch, kRows)) =
            make_uint4(tf32_rna_bits(v.x), tf32_rna_bits(v.y), tf32_rna_bits(v.z),
                       tf32_rna_bits(v.w));
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (part == 0) m.xsq[it & 1][r] = s;
    fence_proxy_async();  // the rounded copy is read by wgmma
    named_barrier_arrive(kBarRowsIn + (it & 1), kTcThreads);
  };

  // the decision of tile it, its rescoring and its outputs
  auto post = [&](int it) {
    const int p = it & 1, row0 = tile_of(it) * kRows;
    const unsigned char* s_x = xbuf(it);
    if (uw == 0) {  // rows lane and lane + 32: both warpgroups' codes, the decision
      int flag[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        Best3 b{INFINITY, 0.f, INFINITY, INFINITY, 0, 0};
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const float4 o = m.other[p][w][r];
          const float2 o2 = m.other2[p][w][r];
          merge_best(b, Best3{o.x, o.z, o.w, o2.y, __float_as_int(o.y), __float_as_int(o2.x)});
        }
        // s_k1 + C <= L'_1 + w, every other code's s_k + C >= its L': a
        // code whose L' exceeds L'_1 + w is not the argmin (with 2^-18 of
        // each value for its packed place, and the f32 rounding of the rule)
        const float cw = alpha * sqrtf(m.xsq[p][r]) * kGrow;
        const float w = 2.f * (cw * b.n1 + beta * b.n1 * b.n1);
        auto out = [&](float v) {
          return v == INFINITY || v - b.b1 - w > 0x1p-16f * (b.b1 + v) + 0x1p-20f * w;
        };
        // 0: k1 alone; 2: k1 or k2 (when the codebook is resident); 1: any
        flag[h] = row0 + r >= a.N || out(b.b2) ? 0 : resident && out(b.b3) ? 2 : 1;
        m.code[r] = b.k1;
        m.k2[r] = b.k2;
      }
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int want = 1; want <= 2; ++want) {  // the rows for every code; the pairs
        const unsigned m0 = __ballot_sync(0xffffffffu, flag[0] == want);
        const unsigned m1 = __ballot_sync(0xffffffffu, flag[1] == want);
        int* list = want == 1 ? m.list : m.plist;
        if (flag[0] == want) list[__popc(m0 & below)] = lane;
        if (flag[1] == want) list[__popc(m0) + __popc(m1 & below)] = lane + 32;
        if (lane == 0) (want == 1 ? m.nflag : m.npair) = __popc(m0) + __popc(m1);
      }
    }
    post_sync();
    const int nflag = m.nflag, npair = m.npair;

    // a row whose L'_3 is out: the exact distances of k1 (lanes 0-15) and k2
    // (16-31), a warp per row, each half's chunks summed in a fixed tree
    for (int i = uw; i < npair; i += kPostWarps) {
      const int r = m.plist[i], half = lane >> 4;
      const int code = half ? m.k2[r] : m.code[r];
      float dot = 0.f;
      for (int ch = lane & 15; ch < nq; ch += 16)
        dot = dot4(dot, lds4(s_x, swz(r, ch, kRows)), lds4(s_cb, swz(code, ch, a.kc)));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float d = exact_dist(m.xsq[p][r], dot, s_esq[code]);
      const float d2 = __shfl_sync(0xffffffffu, d, 16);
      const int c2 = __shfl_sync(0xffffffffu, code, 16);
      if (lane == 0 && before(d2, c2, d, code)) m.code[r] = c2;
    }

    // the rest: exact f32 distances to every code
    if (nflag > 0) {
      for (int i = u; i < nflag; i += kPostThreads) {
        m.bv[i] = INFINITY;
        m.bk[i] = INT_MAX;
      }
      for (int c = 0; c < a.chunks; ++c) {
        const int cb0 = c * a.kc;
        if (!resident) {
          post_sync();
          load_chunk(cb0, kScreenThreads, kPostThreads, kBarPost);
        }
        const int kv = min(a.kc, a.K - cb0);
        // rows [f0, f0 + nb) of the list, computed NB at a time (past nb:
        // the last row again); each thread's codes cl, cl + 128, ... in order
        auto batch = [&](int f0, int nb, auto nb_max) {
          constexpr int NB = decltype(nb_max)::value;
          int rows[NB], bk[NB];
          float xs[NB], bv[NB];
#pragma unroll
          for (int f = 0; f < NB; ++f) {
            rows[f] = m.list[f0 + min(f, nb - 1)];
            xs[f] = m.xsq[p][rows[f]];
            bv[f] = INFINITY;
            bk[f] = INT_MAX;
          }
          for (int cl = u; cl < kv; cl += 2 * kPostThreads) {  // codes cl, cl + 128
            const int cl2 = min(cl + kPostThreads, kv - 1);
            float acc[2][NB];
#pragma unroll
            for (int f = 0; f < NB; ++f) acc[0][f] = acc[1][f] = 0.f;
            for (int ch = 0; ch < nq; ++ch) {
              const float4 ea = lds4(s_cb, swz(cl, ch, a.kc));
              const float4 eb = lds4(s_cb, swz(cl2, ch, a.kc));
#pragma unroll
              for (int f = 0; f < NB; ++f) {
                const float4 v = lds4(s_x, swz(rows[f], ch, kRows));
                acc[0][f] = dot4(acc[0][f], v, ea);
                acc[1][f] = dot4(acc[1][f], v, eb);
              }
            }
            const float ea2 = s_esq[cl], eb2 = s_esq[cl2];
#pragma unroll
            for (int f = 0; f < NB; ++f) {
              const float da = exact_dist(xs[f], acc[0][f], ea2);
              const float db = exact_dist(xs[f], acc[1][f], eb2);
              if (da < bv[f]) {
                bv[f] = da;
                bk[f] = cb0 + cl;
              }
              if (cl + kPostThreads < kv && db < bv[f]) {
                bv[f] = db;
                bk[f] = cb0 + cl2;
              }
            }
          }
#pragma unroll
          for (int f = 0; f < NB; ++f) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              best_of(bv[f], bk[f], __shfl_xor_sync(0xffffffffu, bv[f], off),
                      __shfl_xor_sync(0xffffffffu, bk[f], off));
            if (lane == 0) {
              m.rv[uw][f] = bv[f];
              m.rk[uw][f] = bk[f];
            }
          }
          post_sync();
          if (u < nb) {
            float v = m.bv[f0 + u];
            int k = m.bk[f0 + u];
#pragma unroll
            for (int w = 0; w < kPostWarps; ++w) best_of(v, k, m.rv[w][u], m.rk[w][u]);
            m.bv[f0 + u] = v;
            m.bk[f0 + u] = k;
          }
          post_sync();  // the batch's partial results are consumed
        };
        for (int f0 = 0; f0 < nflag; f0 += kBatch) {
          const int nb = min(kBatch, nflag - f0);
          if (nb > 4)
            batch(f0, nb, std::integral_constant<int, 8>{});
          else if (nb > 2)
            batch(f0, nb, std::integral_constant<int, 4>{});
          else if (nb == 2)
            batch(f0, nb, std::integral_constant<int, 2>{});
          else
            batch(f0, nb, std::integral_constant<int, 1>{});
        }
      }
      for (int i = u; i < nflag; i += kPostThreads)
        if (m.bk[i] != INT_MAX) m.code[m.list[i]] = m.bk[i];
    }
    post_sync();  // the pairs' and the rescoring's codes are written

    for (int r = u; r < kRows; r += kPostThreads)
      if (row0 + r < a.N) a.idx[row0 + r] = m.code[r];
    if (a.q != nullptr) {
      if (resident) {  // from the shared codebook, 16 bytes at a time
        for (int i = u; i < kRows * nq; i += kPostThreads) {
          const int r = i / nq, ch = i - r * nq, row = row0 + r;
          if (row < a.N)
            *reinterpret_cast<float4*>(a.q + (size_t)row * a.D + 4 * ch) =
                lds4(s_cb, swz(m.code[r], ch, a.kc));
        }
      } else {
        for (int i = u; i < kRows * a.D; i += kPostThreads) {
          const int r = i / a.D, d = i - r * a.D, row = row0 + r;
          if (row < a.N) a.q[(size_t)row * a.D + d] = __ldg(emb + (size_t)d * a.K + m.code[r]);
        }
      }
    }
    if (a.rescored != nullptr && u == 0 && nflag + npair > 0) {
      atomicAdd(a.rescored, nflag);
      atomicAdd(a.rescored + 1, npair);
    }
    post_sync();  // the codes and the lists are free
  };

  if (resident) {
    // tile it + 2's rows load while tile it + 1's wait and tile it is screened
    if (tile_of(0) < a.tiles) {
      cp_async_wait<1>();
      rows_in(0);
    }
    for (int it = 0; tile_of(it) < a.tiles; ++it) {
      if (tile_of(it + 2) < a.tiles) load_x(it + 2);
      cp_async_commit();
      if (tile_of(it + 1) < a.tiles) {
        cp_async_wait<1>();
        rows_in(it + 1);
      }
      PHASE(0);  // the next tile's rows in
      named_barrier_sync(kBarScreened + (it & 1), kTcThreads);
      PHASE(1);  // waiting for the screen
      post(it);
      PHASE(2);  // the decision, the rescoring, the outputs
    }
  } else {
    // one row buffer and the codebook in chunks: each tile in turn
    for (int it = 0; tile_of(it) < a.tiles; ++it) {
      load_x(it);
      cp_async_commit();
      cp_async_wait<0>();
      rows_in(it);
      named_barrier_sync(kBarScreened + (it & 1), kTcThreads);
      post(it);
      if (tile_of(it + 1) < a.tiles) named_barrier_arrive(kBarPosted, kTcThreads);
    }
  }
}

cudaError_t launch_tf32(const TcArgs& base, cudaStream_t st) {
  TcArgs a = base;
  const Plan p = tc_plan(a.D, a.K);
  a.dp = p.dp;
  a.kc = p.kc;
  a.chunks = p.chunks;
  const long long tiles = ((long long)a.N + kRows - 1) / kRows;
  if (tiles > INT_MAX / 2) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  // the shared-memory allowance and the SM count, once per device
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(vq_assign_kernel_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vq_assign_kernel_tf32, kTcThreads,
                                                      p.smem);
  if (err != cudaSuccess) return err;
  const int blocks = (int)std::min<long long>(tiles, (long long)sms[dev] * std::max(per_sm, 1));
  vq_assign_kernel_tf32<<<blocks, kTcThreads, p.smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Which kernel takes a call (see the head of the file): 1 = tf32 (D % 8 ==
// 0, D <= 256, any K), 0 = ffma (every other shape).
extern "C" int mcgm_vq_assign_variant(int N, int D, int K) {
  if (N <= 0 || D <= 0 || D > kMaxD || K <= 0) return 0;
  return D % 8 == 0 && tc_plan(D, K).kc >= kTileCodes ? 1 : 0;
}

// x and q 16-byte aligned for the tf32 kernel. rescored: two ints on the
// device that gain the rows the tf32 kernel decided in f32 against every code
// and by their two best codes, or null. Returns the launch's CUDA error (0 if
// none).
extern "C" int mcgm_vq_assign(const void* x, const void* emb, void* idx, void* q, int N, int D,
                              int K, void* rescored, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mcgm_vq_assign_variant(N, D, K) == 1) {
    if (((uintptr_t)x | (uintptr_t)q) % 16) return cudaErrorMisalignedAddress;
    TcArgs a{static_cast<const float*>(x), static_cast<const float*>(emb), static_cast<int*>(idx),
             static_cast<float*>(q), static_cast<int*>(rescored), N, D, K, 0, 0, 0, 0};
    return launch_tf32(a, st);
  }
  const size_t smem = ffma_smem(D);
  // set once per device: the x tile and a codebook tile pass 48 KB above D = 88
  static int ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(vq_assign_kernel_ffma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ffma_smem(kMaxD));
    if (err != cudaSuccess) return err;
    ready[dev] = 1;
  }
  const long long blocks = ((long long)N + kBM - 1) / kBM;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  vq_assign_kernel_ffma<<<(int)blocks, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(emb), static_cast<int*>(idx),
      static_cast<float*>(q), N, D, K);
  return cudaGetLastError();
}

#ifdef VQ_ASSIGN_PHASES
// out [24]: the phases' cycle totals since the last call (see PHASE)
extern "C" int mcgm_vq_assign_phases(unsigned long long* out) {
  static const unsigned long long zero[24] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
#endif

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
