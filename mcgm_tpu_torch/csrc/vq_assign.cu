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
// are the codes), idx [N] int32, q [N, D] f32 or null.
//
// Bound on an H100 SXM at the VQ-VAE's train shape (N = 128 x 8 x 8 = 8,192,
// D = 64, K = 512): 268 M multiply-adds, 8.0 us at the 67 TFLOP/s f32 peak
// outside the tensor cores; bytes 4.2 MB (x and q 2.1 MB each, the codebook
// 128 KB), 1.3 us at 3.35 TB/s. So the operations bound it. The sums stay in
// f32 on the CUDA cores, so that the argmin is the f32 reference's wherever
// the two best codes are further apart than the rounding of the sums.
//
// Design: a blocked f32 matrix product with the argmin in its epilogue, so
// the [N, K] distances never reach device memory.
// - A block of 256 threads (16 x 16) takes 64 rows of x, held transposed in
//   shared memory with their |x|^2, and walks the codebook in tiles of 64
//   codes (D x 64 floats in shared memory, |e|^2 computed from the tile).
// - Each thread forms a 4 rows x 4 codes tile of dot products, one 16-byte
//   load of x and one of e per step of d: 16 multiply-adds per two shared
//   loads, and the 16 threads of a half-warp share their x loads.
// - Each thread keeps, per row, the best (distance, code) of its codes; codes
//   are visited in increasing order and replaced only on a strictly smaller
//   distance, so the lowest index wins ties; the 16 threads of a row reduce
//   by warp shuffles with the same rule.
// - The chosen rows of the codebook are gathered into q from device memory
//   (the codebook is 128 KB and stays in L2).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 64;        // codes per tile
constexpr int kThreads = 256;  // 16 x 16; each thread a 4 x 4 tile
constexpr int kLdx = kBM + 4;  // row stride of the transposed x tile (16-byte rows)
constexpr int kMaxD = 256;

__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * kLdx + (size_t)D * kBN + kBN + kBM) + sizeof(int) * kBM;
}

__global__ void __launch_bounds__(kThreads)
    vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ emb,
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

}  // namespace

extern "C" int mcgm_vq_assign(const void* x, const void* emb, void* idx, void* q, int N, int D,
                              int K, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD || K <= 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  // set once per device: the x tile and a codebook tile pass 48 KB above D = 88
  static int ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(vq_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return err;
    ready[dev] = 1;
  }
  const long long blocks = ((long long)N + kBM - 1) / kBM;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  vq_assign_kernel<<<(int)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(emb), static_cast<int*>(idx),
      static_cast<float*>(q), N, D, K);
  return cudaGetLastError();
}

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
