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
// idx [N] int32 in [0, K) (rows with a code outside it are left out),
// w [N] f32 or null, cs_in / cs_out [K] f32 (distinct buffers), mean and
// emb [D, K] f32 (distinct). keep = 1 - decay and k_eps = K eps come
// rounded from the caller, as the plain version's f32 arithmetic takes
// them, so the cluster sizes are the plain version's bit for bit when w is
// a 0/1 mask (the counts are then exact).
//
// Bound on an H100 SXM at the VQ-VAE's train shape (N = 8,192, D = 64,
// K = 512): 0.5 M adds, nothing; bytes 2.4 MB (x 2.1 MB, idx 32 KB, the
// mean read and written and the codebook written, 128 KB each), 0.7 us at
// 3.35 TB/s. So the bytes bound it, and at this size a launch costs more.
//
// Design: the work is split over rows, not codes, so that the time does
// not follow the largest cluster (a train step's codes fall on a few), in
// three launches with no atomics and no order that changes from run to run:
// two launches on the same inputs give bit-equal buffers, for any w.
// - rows: one block per chunk of kRows rows (128 blocks at N = 8,192,
//   about one wave on 132 SMs). It stages the chunk's rows with 16-byte
//   loads, numbers the codes present in the chunk in order of their first
//   row, lists each code's rows in row order, and writes per code present
//   its partial count (sum of w) and its partial sum ([D], w-weighted, in
//   row order) into slot `chunk * kRows + s` of the scratch, and the
//   chunk's row of the slot table `slot [chunks, K]` (int8: the code's
//   slot in the chunk, -1 if absent).
// - counts: one thread per (code, split of the chunks); the splits join in
//   a fixed order. The cluster sizes go to cs_out.
// - codes: one block per code, its threads over (d / 4, split of the
//   chunks); the splits join in a fixed order, then the EMA, the Laplace
//   smoothing and the division round as the plain version's f32 ops do. n
//   is reduced from all K cluster sizes in one fixed order, the same in
//   every block. A hot code has at most `chunks` partials; an absent one
//   costs one table byte per chunk.
// Scratch: one device buffer of mcgm_vq_ema_scratch_bytes(N, D, K) bytes from
// the caller, laid out here (ScratchLayout): part [chunks * kRows, D] f32,
// pcnt [chunks * kRows] f32, slot [chunks, K] int8, each 256-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;            // rows per chunk
constexpr int kRowThreads = 256;
constexpr int kCountCodes = 32;      // counts: codes per block (a warp's lanes)
constexpr int kCountSplits = 32;     // and splits of the chunks (warps)
constexpr int kCodeThreads = 256;    // codes: threads per code
constexpr int kMaxD = 256;           // and D % 4 == 0

__host__ __device__ constexpr size_t rows_smem(int D, int K) {
  return sizeof(float) * (size_t)kRows * D + (size_t)K;
}

constexpr size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// Byte offsets of the scratch's parts (see the head of the file) and its size.
struct ScratchLayout {
  size_t pcnt, slot, bytes;
  ScratchLayout(int N, int D, int K) {
    const size_t chunks = ((size_t)N + kRows - 1) / kRows;
    pcnt = align256(sizeof(float) * chunks * kRows * D);
    slot = pcnt + align256(sizeof(float) * chunks * kRows);
    bytes = slot + align256(chunks * K);
  }
};

__global__ void __launch_bounds__(kRowThreads)
    vq_ema_kernel_rows(const float* __restrict__ x, const int* __restrict__ idx,
                       const float* __restrict__ w, int N, int D, int K,
                       float* __restrict__ part, float* __restrict__ pcnt,
                       signed char* __restrict__ slot) {
  extern __shared__ float4 smem4[];
  const int quads = D / 4;
  float4* sX = smem4;                                                      // [kRows][quads]
  signed char* sTab = reinterpret_cast<signed char*>(sX + kRows * quads);  // [K]
  __shared__ int sCode[kRows], sRowSlot[kRows], sOrder[kRows], sStart[kRows], sCount[kRows];
  __shared__ float sW[kRows];
  __shared__ int sLeads[2];

  const int tid = threadIdx.x, chunk = blockIdx.x;
  const long long base = (long long)chunk * kRows;
  const int n = (int)min((long long)kRows, (long long)N - base);

  const float4* x4 = reinterpret_cast<const float4*>(x) + base * quads;
  for (int e = tid; e < n * quads; e += kRowThreads) sX[e] = x4[e];
  for (int k = tid; k < K; k += kRowThreads) sTab[k] = -1;
  if (tid < kRows) {
    int code = -1;
    float wv = 0.f;
    if (tid < n) {
      code = idx[base + tid];
      if ((unsigned)code >= (unsigned)K) code = -1;
      wv = w != nullptr ? w[base + tid] : 1.f;
    }
    sCode[tid] = code;
    sW[tid] = wv;
  }
  __syncthreads();

  // Threads 0..63 (two whole warps) own a row each: the first row of its
  // code (the lead) and its rank among that code's rows; leads are
  // numbered in row order.
  int code = -1, first = tid, rank = 0, prefix = 0;
  bool lead = false;
  if (tid < kRows) {
    code = sCode[tid];
    if (code >= 0)
      for (int j = tid - 1; j >= 0; --j)
        if (sCode[j] == code) {
          first = j;
          ++rank;
        }
    lead = code >= 0 && first == tid;
    const unsigned ballot = __ballot_sync(0xffffffffu, lead);
    prefix = __popc(ballot & ((1u << (tid & 31)) - 1u));
    if ((tid & 31) == 0) sLeads[tid >> 5] = __popc(ballot);
  }
  __syncthreads();
  const int nslots = sLeads[0] + sLeads[1];
  if (tid < kRows) sRowSlot[tid] = lead ? prefix + (tid >= 32 ? sLeads[0] : 0) : -1;
  __syncthreads();
  int myslot = -1;
  if (tid < kRows && code >= 0) myslot = sRowSlot[first];
  __syncthreads();  // every lead's slot is read before the rows' slots overwrite them
  if (tid < kRows) sRowSlot[tid] = myslot;
  __syncthreads();
  // the rows sorted by (slot, row): rows of earlier slots, then the rank
  if (tid < kRows && myslot >= 0) {
    int before = 0, count = 0;
    for (int j = 0; j < kRows; ++j) {
      const int sj = sRowSlot[j];
      before += (sj >= 0 && sj < myslot) ? 1 : 0;
      count += sj == myslot ? 1 : 0;
    }
    sOrder[before + rank] = tid;
    if (lead) {
      sStart[myslot] = before;
      sCount[myslot] = count;
      sTab[code] = (signed char)myslot;
    }
  }
  __syncthreads();

  signed char* trow = slot + (long long)chunk * K;
  for (int k = tid; k < K; k += kRowThreads) trow[k] = sTab[k];
  if (tid < nslots) {  // the slot's count: its rows' weights in row order
    const int j0 = sStart[tid], j1 = j0 + sCount[tid];
    float cnt = 0.f;
    for (int j = j0; j < j1; ++j) cnt += sW[sOrder[j]];
    pcnt[base + tid] = cnt;
  }
  float4* part4 = reinterpret_cast<float4*>(part) + base * quads;
  for (int p = tid; p < nslots * quads; p += kRowThreads) {
    const int s = p / quads, q = p - s * quads;
    const int j0 = sStart[s], j1 = j0 + sCount[s];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = j0; j < j1; ++j) {
      const int r = sOrder[j];
      const float wv = sW[r];
      const float4 v = sX[r * quads + q];
      acc.x += wv * v.x;
      acc.y += wv * v.y;
      acc.z += wv * v.z;
      acc.w += wv * v.w;
    }
    part4[s * quads + q] = acc;
  }
}

__global__ void __launch_bounds__(kCountCodes * kCountSplits)
    vq_ema_kernel_counts(const float* __restrict__ pcnt, const signed char* __restrict__ slot,
                         const float* __restrict__ cs_in, float* __restrict__ cs_out, int chunks,
                         int K, float decay, float keep) {
  __shared__ float sPart[kCountSplits][kCountCodes + 1];
  const int kk = threadIdx.x & 31, sp = threadIdx.x >> 5;
  const int k = blockIdx.x * kCountCodes + kk;
  float cnt = 0.f;
  if (k < K) {
#pragma unroll 4
    for (int c = sp; c < chunks; c += kCountSplits) {
      const int s = slot[(long long)c * K + k];
      if (s >= 0) cnt += pcnt[(long long)c * kRows + s];
    }
  }
  sPart[sp][kk] = cnt;
  __syncthreads();
  if (sp == 0 && k < K) {
    float t = 0.f;
    for (int j = 0; j < kCountSplits; ++j) t += sPart[j][kk];
    // rounded as the plain version rounds: a product, a product, a sum
    cs_out[k] = __fadd_rn(__fmul_rn(cs_in[k], decay), __fmul_rn(t, keep));
  }
}

__global__ void __launch_bounds__(kCodeThreads)
    vq_ema_kernel_codes(const float* __restrict__ part, const signed char* __restrict__ slot,
                        const float* __restrict__ cs, float* __restrict__ mean,
                        float* __restrict__ emb, int chunks, int D, int K, float decay,
                        float keep, float eps, float k_eps) {
  __shared__ float4 sSum[kCodeThreads];  // [split][quads]
  __shared__ float sRed[kCodeThreads / 32];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int quads = D / 4, splits = kCodeThreads / quads;
  const int sp = tid / quads, q = tid - sp * quads;
  if (sp < splits) {
    const float4* part4 = reinterpret_cast<const float4*>(part);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = sp; c < chunks; c += splits) {
      const int s = slot[(long long)c * K + k];
      if (s >= 0) {
        const float4 v = part4[((long long)c * kRows + s) * quads + q];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    sSum[tid] = acc;
  }
  // n: all K cluster sizes in one fixed order, the same in every block
  float t = 0.f;
  for (int i = tid; i < K; i += kCodeThreads) t += cs[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
  if ((tid & 31) == 0) sRed[tid >> 5] = t;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kCodeThreads / 32; ++i) total += sRed[i];
  const float denom = __fadd_rn(total, k_eps);
  const float smoothed = __fmul_rn(__fdiv_rn(__fadd_rn(cs[k], eps), denom), total);
  const float* sums = reinterpret_cast<const float*>(sSum);
  for (int d = tid; d < D; d += kCodeThreads) {
    float sum = 0.f;
    for (int j = 0; j < splits; ++j) sum += sums[j * D + d];
    const long long at = (long long)d * K + k;
    const float m = __fadd_rn(__fmul_rn(mean[at], decay), __fmul_rn(sum, keep));
    mean[at] = m;
    emb[at] = m / smoothed;
  }
}

}  // namespace

// Bytes of scratch that mcgm_vq_ema needs for N rows, D and K.
extern "C" long long mcgm_vq_ema_scratch_bytes(int N, int D, int K) {
  if (N <= 0 || D <= 0 || K <= 0) return 0;
  return (long long)ScratchLayout(N, D, K).bytes;
}

// scratch: mcgm_vq_ema_scratch_bytes(N, D, K) bytes, 256-byte aligned.
// *launched gains one for each kernel launched (three a call). Returns the
// first launch error (0 if none).
extern "C" int mcgm_vq_ema(const void* x, const void* idx, const void* w, const void* cs_in,
                           void* cs_out, void* mean, void* emb, void* scratch, int N, int D,
                           int K, float decay, float keep, float eps, float k_eps,
                           int* launched, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD || D % 4 || K <= 0) return cudaErrorInvalidValue;
  if (cs_in == cs_out || (uintptr_t)scratch % 256) return cudaErrorInvalidValue;
  const size_t smem = rows_smem(D, K);
  if (smem > 200 * 1024) return cudaErrorInvalidValue;  // beside the static arrays
  // past 48 KB of dynamic shared memory (D = 256 takes 64 KB): the allowance,
  // raised per device to the largest asked for so far
  static size_t allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(vq_ema_kernel_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  const ScratchLayout lay(N, D, K);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* part = reinterpret_cast<float*>(base);
  float* pcnt = reinterpret_cast<float*>(base + lay.pcnt);
  signed char* slot = reinterpret_cast<signed char*>(base + lay.slot);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (N + kRows - 1) / kRows;
  vq_ema_kernel_rows<<<chunks, kRowThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<const float*>(w),
      N, D, K, part, pcnt, slot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  vq_ema_kernel_counts<<<(K + kCountCodes - 1) / kCountCodes, kCountCodes * kCountSplits, 0,
                         st>>>(pcnt, slot, static_cast<const float*>(cs_in),
                               static_cast<float*>(cs_out), chunks, K, decay, keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  vq_ema_kernel_codes<<<K, kCodeThreads, 0, st>>>(
      part, slot, static_cast<const float*>(cs_out), static_cast<float*>(mean),
      static_cast<float*>(emb), chunks, D, K, decay, keep, eps, k_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
