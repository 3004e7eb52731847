// EMA codebook update of the VQ-VAE's vector quantizer, for Hopper (sm_90a).
//
// The train-time half of the TPU kernel vq_assign's lineage
// (mcgm_tpu/ops/pallas_kernels.py at commit 0303c43; live XLA form
// mcgm_tpu/ops/vq.py::VectorQuantizerEMA.__call__, the `train` branch):
//
//   count[k]      = sum_n w[n] [idx[n] == k]                  (w = 1 if null)
//   sum[d, k]     = sum_n w[n] x[n, d] [idx[n] == k]          (x^T . onehot)
//   cluster[k]    = cs_in[k] * decay + count[k] * (1 - decay)
//   mean[d, k]    = mean[d, k] * decay + sum[d, k] * (1 - decay)   (in place)
//   n             = sum_k cluster[k]
//   emb[d, k]     = mean[d, k] / ((cluster[k] + eps) / (n + K eps) * n)
//
// x [N, D] f32 row-major and 16-byte aligned, D a multiple of 4 up to 256,
// idx [N] int32 in [0, K), w [N] f32 or null,
// cs_in / cs_out [K] f32 (distinct buffers: every block reads all of
// cs_in), mean and emb [D, K] f32 (distinct). keep = 1 - decay and
// k_eps = K eps come rounded from the caller, as the plain version's f32
// arithmetic takes them, so the cluster sizes are the plain version's bit
// for bit (the counts are exact).
//
// Bound on an H100 SXM at the VQ-VAE's train shape (N = 8,192, D = 64,
// K = 512): 0.5 M adds, nothing; bytes 2.4 MB (x 2.1 MB, idx 32 KB, the
// mean read and written and the codebook written, 128 KB each), 0.7 us at
// 3.35 TB/s. So the bytes bound it.
//
// Design: one launch, no atomics in device memory and no order that changes
// from run to run in the sums over rows.
// - Block b owns the codes [8 b, 8 b + 8). Every block stages idx (and w)
//   through shared memory in chunks of 2,048 rows and builds the counts of
//   ALL K codes there (K floats); so every block holds all new cluster sizes
//   and their sum n, reduced in one fixed order, and no block waits for
//   another.
// - Per chunk, the block lists the rows whose code it owns, in row order
//   (a warp ballot and a prefix over the 8 warps), and walks that list with
//   all 256 threads: D / 4 threads per row, one 16-byte load each, 1024 / D
//   rows in flight (16 at D = 64), each thread keeping float4 sums of its
//   8 codes in registers. So a block whose codes take every row of the
//   batch (codes collapse onto a few early in training) still has 16 rows
//   in flight, not 4. The lanes' sums join in lane order, then the block
//   applies the EMA, the Laplace smoothing and the division to its codes.
// The 64 blocks (K = 512) each read all of idx (32 KB, from L2) and only the rows of x
// of their codes, so x is read once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCodes = 8;     // codes per block
constexpr int kChunk = 2048;  // rows staged per pass
constexpr int kMaxD = 256;    // and D % 4 == 0
constexpr int kLaneFloats = 4 * kThreads;  // lanes * D: 1024 / D lanes of D floats

__host__ __device__ constexpr size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)K + (size_t)kLaneFloats * kCodes + kChunk + 32) +
         sizeof(int) * (2 * kChunk + kWarps);
}

__global__ void __launch_bounds__(kThreads)
    vq_ema_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  const float* __restrict__ w, const float* __restrict__ cs_in,
                  float* __restrict__ cs_out, float* __restrict__ mean, float* __restrict__ emb,
                  int N, int D, int K, float decay, float keep, float eps, float k_eps) {
  extern __shared__ float4 smem4[];
  float* sPart = reinterpret_cast<float*>(smem4);  // [lanes][kCodes][D]
  float* sCnt = sPart + kLaneFloats * kCodes;      // [K] counts, then cluster sizes
  float* sW = sCnt + K;                            // [kChunk]
  float* sRed = sW + kChunk;                       // [32]
  int* sIdx = reinterpret_cast<int*>(sRed + 32);   // [kChunk]
  int* sList = sIdx + kChunk;                      // [kChunk] rows of this block's codes
  int* sWarp = sList + kChunk;                     // [kWarps]

  const int tid = threadIdx.x, wid = tid >> 5, bit = tid & 31;
  const int quads = D / 4, lanes = kThreads / quads;
  const int lane = tid / quads, q = tid - lane * quads;  // lane >= lanes: idle in the sums
  const int k0 = blockIdx.x * kCodes;
  const float4* x4 = reinterpret_cast<const float4*>(x);

  float4 acc[kCodes];
#pragma unroll
  for (int c = 0; c < kCodes; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < K; i += kThreads) sCnt[i] = 0.f;
  for (int base = 0; base < N; base += kChunk) {
    const int n = min(kChunk, N - base);
    __syncthreads();  // the previous chunk is consumed (and the zeroing done)
    for (int i = tid; i < n; i += kThreads) {
      sIdx[i] = idx[base + i];
      sW[i] = w != nullptr ? w[base + i] : 1.f;
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int k = sIdx[i];
      if ((unsigned)k < (unsigned)K) atomicAdd(&sCnt[k], sW[i]);
    }
    int listed = 0;  // the same in every thread
    for (int r0 = 0; r0 < n; r0 += kThreads) {
      const int i = r0 + tid;
      const bool mine = i < n && (unsigned)(sIdx[i] - k0) < (unsigned)kCodes;
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (bit == 0) sWarp[wid] = __popc(ballot);
      __syncthreads();
      int before = 0, round = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        before += v < wid ? sWarp[v] : 0;
        round += sWarp[v];
      }
      if (mine) sList[listed + before + __popc(ballot & ((1u << bit) - 1u))] = i;
      listed += round;
      __syncthreads();  // sWarp is read before the next round writes it
    }
    if (lane < lanes) {
#pragma unroll 4
      for (int j = lane; j < listed; j += lanes) {
        const int i = sList[j], kk = sIdx[i] - k0;
        const float wv = sW[i];
        const float4 v = x4[(long long)(base + i) * quads + q];
#pragma unroll
        for (int c = 0; c < kCodes; ++c) {
          if (kk == c) {
            acc[c].x += wv * v.x;
            acc[c].y += wv * v.y;
            acc[c].z += wv * v.z;
            acc[c].w += wv * v.w;
          }
        }
      }
    }
  }
  if (lane < lanes) {
#pragma unroll
    for (int c = 0; c < kCodes; ++c)
      reinterpret_cast<float4*>(sPart + (lane * kCodes + c) * D)[q] = acc[c];
  }
  __syncthreads();

  // rounded as the plain version rounds: a product, a product, a sum
  for (int i = tid; i < K; i += kThreads)
    sCnt[i] = __fadd_rn(__fmul_rn(cs_in[i], decay), __fmul_rn(sCnt[i], keep));
  __syncthreads();
  float s = 0.f;
  for (int i = tid; i < K; i += kThreads) s += sCnt[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (bit == 0) sRed[wid] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int i = 0; i < kWarps; ++i) t += sRed[i];
    sRed[31] = t;
  }
  __syncthreads();
  const float total = sRed[31];
  const float denom = __fadd_rn(total, k_eps);

  for (int i = tid; i < D * kCodes; i += kThreads) {
    const int dd = i / kCodes, kk = i - dd * kCodes, k = k0 + kk;
    if (k >= K) continue;
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += sPart[(l * kCodes + kk) * D + dd];
    const long long at = (long long)dd * K + k;
    const float m = __fadd_rn(__fmul_rn(mean[at], decay), __fmul_rn(sum, keep));
    const float smoothed = __fmul_rn(__fdiv_rn(__fadd_rn(sCnt[k], eps), denom), total);
    mean[at] = m;
    emb[at] = m / smoothed;
  }
  if (tid < kCodes && k0 + tid < K) cs_out[k0 + tid] = sCnt[k0 + tid];
}

}  // namespace

extern "C" int mcgm_vq_ema(const void* x, const void* idx, const void* w, const void* cs_in,
                           void* cs_out, void* mean, void* emb, int N, int D, int K,
                           float decay, float keep, float eps, float k_eps, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD || D % 4 || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // set once per device: past 48 KB of shared memory (K = 512 takes 58 KB)
  static int ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(vq_ema_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024);
    if (err != cudaSuccess) return err;
    ready[dev] = 1;
  }
  const int blocks = (K + kCodes - 1) / kCodes;
  vq_ema_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<const float*>(w),
      static_cast<const float*>(cs_in), static_cast<float*>(cs_out), static_cast<float*>(mean),
      static_cast<float*>(emb), N, D, K, decay, keep, eps, k_eps);
  return cudaGetLastError();
}

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
