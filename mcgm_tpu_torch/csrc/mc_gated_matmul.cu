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
// Design: a simple blocked product, one output tile of 64 rows x 64
// channels per block of 256 threads, K in chunks of 32 through shared
// memory, the whole epilogue in f32 registers.
// - bf16: mma.sync.m16n8k16 on the tensor cores, f32 sums. The x chunk is
//   held [row][k] and the w chunk [channel][k] (k contiguous, rows padded
//   to 80 bytes so that the fragments' 32-bit loads hit 32 banks); each of
//   the 8 warps owns 16 rows x 32 channels (4 mma per step of 16 in k).
// - f32: FFMA on the CUDA cores; the chunks are held transposed ([k][row],
//   [k][channel]) and each thread forms 4 rows x 4 channels from one
//   16-byte load of each per step of k.
// - x is gathered by rows: each row's offset b*K*P + p is computed once per
//   block; for P > 1 consecutive threads take consecutive positions, for
//   P = 1 consecutive k (both contiguous in memory). Each thread issues all
//   its loads of a chunk before storing any, and the next chunk's loads
//   before the current chunk's product.
// - The code of the tile's samples (64 at P = 1, one or two at P = 64) and
//   channels is formed before the product from indicator and codebook
//   staged 16 modes at a time in shared memory (independent loads, summed
//   in mode order); alpha and beta likewise.
// - The gated tile is staged in shared memory (over the operand chunks)
//   and written with the same row mapping, so the stores are coalesced
//   for both P = 1 and P > 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = f32, 1 = bf16. Returns the launch's CUDA error (0 if none).
extern "C" int mcgm_mc_gated_matmul(const void* x, const void* w, const void* alpha,
                                    const void* beta, const void* indicator,
                                    const void* codebook, void* out, int M, int N, int K, int P,
                                    int modes, int relu, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || P <= 0 || M % P != 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if ((indicator == nullptr) != (codebook == nullptr) || (indicator != nullptr && modes <= 0))
    return cudaErrorInvalidValue;
  const long long mblocks = ((long long)M + kTM - 1) / kTM;
  if (mblocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)mblocks, (unsigned)((N + kTN - 1) / kTN));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  Args a{x, w, static_cast<const float*>(alpha), static_cast<const float*>(beta),
         static_cast<const float*>(indicator), static_cast<const float*>(codebook), out,
         M, N, K, P, modes, relu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    mc_gated_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    mc_gated_matmul_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
