// Fused first discriminator block of MCGAN, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/ab_first_block.py::pallas_block (its body
// `_kernel`, reference `xla_block`): the function of
// mcgm_tpu/models/gan.py::_MCFirstDisResBlock with the model's biases and
// spectrally normalised weights:
//
//   h[b,i,j,:] = relu(conv3x3_pad1(x)[b,i,j,:] + b1) * code[b,:]
//   y[b,m,n,:] = sum_{4x4 taps} h . w2f (stride 2, pad 1) + b2
//                + avgpool2(x)[b,m,n,:] . w3 + b3
//
// w2f is the 4x4 fold of conv3x3 + avgpool2 (the wrapper's prologue builds
// it, with the SN division of every weight and code = indicator @ codebook).
// The full-resolution h never reaches device memory: each block computes
// its h tile into shared memory, in bf16 as the Pallas kernel keeps it.
//
// Bound on an H100 SXM at B=128, 128x128x3 -> 64x64x64: conv1 2.10 M
// positions x 64 x 27 MACs, conv2 0.52 M x 64 x 1024 MACs, the shortcut
// 0.2 GFLOP: ~76 GFLOP, 77 us at 989 TFLOP/s bf16. Device memory: 12.6 MB
// of x read, 67 MB of y written, ~24 us at 3.35 TB/s. So operations bound
// it; the unfused chain would also write and read the 268 MB h.
//
// Design (simple first; tensor cores, TMA and wgmma are later work):
// - one block of 256 threads per (sample, tile of 2 output rows x TC output
//   columns), TC = 32 at C_out 64 and 16 at C_out 128;
// - the x halo tile is staged in shared memory as f32, zero outside the
//   image; the h tile ((2*2+2) x (2*TC+2) x C_out) is computed from it with
//   f32 accumulation and stored as bf16, zero outside the image (conv2's
//   padding), with the channel stride padded by 2 against bank conflicts;
// - w2f streams tap by tap through a double buffer in shared memory, as
//   f32: the next tap is read into registers while the current one is used;
// - each thread accumulates 2 positions x 8 output channels in f32 registers
//   on the CUDA cores, adds the biases and the pooled shortcut, and writes
//   bf16 y.
//
// Shapes: C_in in {1, 3}, C_out in {64, 128}, H and W even. x, y NHWC
// contiguous bf16; w1 [3,3,C_in,C_out], w2f [4,4,C_out,C_out],
// w3 [C_in,C_out] bf16; code [B,C_out], b1, b2, b3 [C_out] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 2;  // output rows per block

template <int COUT>
struct Tile {
  static constexpr int TC = 2048 / COUT;             // output columns per block
  static constexpr int COG = COUT / 8;               // groups of 8 output channels
  static constexpr int PG = kThreads / COG;          // position groups
  static constexpr int P = kTR * TC / PG;            // positions per thread
  static constexpr int HR = 2 * kTR + 2;             // h tile rows
  static constexpr int HC = 2 * TC + 2;              // h tile columns
  static constexpr int XR = HR + 2;                  // x tile rows
  static constexpr int XC = HC + 2;                  // x tile columns
  static constexpr int HS = COUT + 2;                // h channel stride (bf16)
  static constexpr int TAP = COUT * COUT;            // w2f elements per tap
  static constexpr int VEC = TAP / 8 / kThreads;     // 16-byte loads per thread per tap
  static_assert(P * PG == kTR * TC, "positions must tile the block");
  static_assert(VEC * 8 * kThreads == TAP, "tap must split over the threads");
};

template <int CIN, int COUT>
constexpr size_t smem_bytes() {
  using T = Tile<COUT>;
  return sizeof(float) * (2 * T::TAP + T::XR * T::XC * CIN + 9 * CIN * COUT +
                          CIN * COUT + 4 * COUT) +
         sizeof(__nv_bfloat16) * T::HR * T::HC * T::HS;
}

// Output channel held in slot j (0..7) by channel group cog: two runs of 4,
// so that the 8 threads of a quarter warp read 128 contiguous bytes of w.
template <int COUT>
__device__ __forceinline__ int slot_channel(int cog, int j) {
  return (j < 4 ? 0 : COUT / 2) + cog * 4 + (j & 3);
}

template <int COUT>
__device__ __forceinline__ void store_tap(float* dst, const uint4 (&v)[Tile<COUT>::VEC],
                                          int tid) {
#pragma unroll
  for (int i = 0; i < Tile<COUT>::VEC; ++i) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
    float2 f0 = __bfloat1622float2(p[0]), f1 = __bfloat1622float2(p[1]);
    float2 f2 = __bfloat1622float2(p[2]), f3 = __bfloat1622float2(p[3]);
    float4* d = reinterpret_cast<float4*>(dst + (size_t)(tid + i * kThreads) * 8);
    d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
first_dblock_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ code,
                    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                    const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
                    __nv_bfloat16* __restrict__ y, int H, int W) {
  using T = Tile<COUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w2s = reinterpret_cast<float*>(smem);   // [2][C_out][C_out]
  float* xs = w2s + 2 * T::TAP;                  // [XR][XC][C_in]
  float* w1s = xs + T::XR * T::XC * CIN;         // [9*C_in][C_out]
  float* w3s = w1s + 9 * CIN * COUT;             // [C_in][C_out]
  float* b1s = w3s + CIN * COUT;
  float* b2s = b1s + COUT;
  float* b3s = b2s + COUT;
  float* cs = b3s + COUT;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(cs + COUT);  // [HR][HC][HS]

  const int Ho = H / 2, Wo = W / 2;
  const int n0 = blockIdx.x * T::TC;
  const int m0 = blockIdx.y * kTR;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // ---- stage the small operands, the x halo tile and the first w2f tap
  const uint4* w2v = reinterpret_cast<const uint4*>(w2);
  uint4 pre[T::VEC];
#pragma unroll
  for (int i = 0; i < T::VEC; ++i) pre[i] = w2v[tid + i * kThreads];
  for (int i = tid; i < 9 * CIN * COUT; i += kThreads) w1s[i] = __bfloat162float(w1[i]);
  for (int i = tid; i < CIN * COUT; i += kThreads) w3s[i] = __bfloat162float(w3[i]);
  for (int i = tid; i < COUT; i += kThreads) {
    b1s[i] = b1[i];
    b2s[i] = b2[i];
    b3s[i] = b3[i];
    cs[i] = code[(size_t)b * COUT + i];
  }
  const __nv_bfloat16* xb = x + (size_t)b * H * W * CIN;
  for (int i = tid; i < T::XR * T::XC * CIN; i += kThreads) {
    const int c = i % CIN, q = i / CIN;
    const int gr = 2 * m0 - 2 + q / T::XC, gc = 2 * n0 - 2 + q % T::XC;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = __bfloat162float(xb[((size_t)gr * W + gc) * CIN + c]);
    xs[i] = v;
  }
  store_tap<COUT>(w2s, pre, tid);
  __syncthreads();

  // ---- h tile: relu(conv3x3(x) + b1) * code, zero outside the image
  constexpr int CP = COUT / 2;
  for (int i = tid; i < T::HR * T::HC * CP; i += kThreads) {
    const int co = 2 * (i % CP), pos = i / CP;
    const int hr = pos / T::HC, hc = pos % T::HC;
    const int gr = 2 * m0 - 1 + hr, gc = 2 * n0 - 1 + hc;
    float a0 = 0.f, a1 = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
      a0 = b1s[co];
      a1 = b1s[co + 1];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci) {
            const float xv = xs[((hr + dy) * T::XC + hc + dx) * CIN + ci];
            const float* wr = w1s + ((dy * 3 + dx) * CIN + ci) * COUT + co;
            a0 = fmaf(xv, wr[0], a0);
            a1 = fmaf(xv, wr[1], a1);
          }
      a0 = fmaxf(a0, 0.f) * cs[co];
      a1 = fmaxf(a1, 0.f) * cs[co + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(hs + pos * T::HS + co) = __floats2bfloat162_rn(a0, a1);
  }
  __syncthreads();

  // ---- conv2: 16 taps of a stride-2 4x4 conv over the h tile
  const int cog = tid % T::COG, pg = tid / T::COG;
  int hoff[T::P];
#pragma unroll
  for (int k = 0; k < T::P; ++k) {
    const int p = pg + T::PG * k;
    hoff[k] = (2 * (p / T::TC) * T::HC + 2 * (p % T::TC)) * T::HS;
  }
  float acc[T::P][8];
#pragma unroll
  for (int k = 0; k < T::P; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;

  for (int t = 0; t < 16; ++t) {
    if (t + 1 < 16) {
#pragma unroll
      for (int i = 0; i < T::VEC; ++i) pre[i] = w2v[(t + 1) * (T::TAP / 8) + tid + i * kThreads];
    }
    const float* wt = w2s + (t & 1) * T::TAP + cog * 4;
    const __nv_bfloat16* ht = hs + ((t >> 2) * T::HC + (t & 3)) * T::HS;
#pragma unroll 4
    for (int ci = 0; ci < COUT; ci += 2) {
      const float4 wa0 = *reinterpret_cast<const float4*>(wt + ci * COUT);
      const float4 wa1 = *reinterpret_cast<const float4*>(wt + ci * COUT + COUT / 2);
      const float4 wb0 = *reinterpret_cast<const float4*>(wt + (ci + 1) * COUT);
      const float4 wb1 = *reinterpret_cast<const float4*>(wt + (ci + 1) * COUT + COUT / 2);
#pragma unroll
      for (int k = 0; k < T::P; ++k) {
        const float2 hv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ht + hoff[k] + ci));
        float* a = acc[k];
        a[0] = fmaf(hv.x, wa0.x, fmaf(hv.y, wb0.x, a[0]));
        a[1] = fmaf(hv.x, wa0.y, fmaf(hv.y, wb0.y, a[1]));
        a[2] = fmaf(hv.x, wa0.z, fmaf(hv.y, wb0.z, a[2]));
        a[3] = fmaf(hv.x, wa0.w, fmaf(hv.y, wb0.w, a[3]));
        a[4] = fmaf(hv.x, wa1.x, fmaf(hv.y, wb1.x, a[4]));
        a[5] = fmaf(hv.x, wa1.y, fmaf(hv.y, wb1.y, a[5]));
        a[6] = fmaf(hv.x, wa1.z, fmaf(hv.y, wb1.z, a[6]));
        a[7] = fmaf(hv.x, wa1.w, fmaf(hv.y, wb1.w, a[7]));
      }
    }
    // The other buffer was last read in step t-1, which the barrier closed.
    if (t + 1 < 16) store_tap<COUT>(w2s + ((t + 1) & 1) * T::TAP, pre, tid);
    __syncthreads();
  }

  // ---- epilogue: + b2 + avgpool2(x) . w3 + b3, bf16 out
  __nv_bfloat16* yb = y + (size_t)b * Ho * Wo * COUT;
#pragma unroll
  for (int k = 0; k < T::P; ++k) {
    const int p = pg + T::PG * k;
    const int mr = p / T::TC, nc = p % T::TC;
    const int m = m0 + mr, n = n0 + nc;
    if (m >= Ho || n >= Wo) continue;
    float pooled[CIN];
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) {
      const float* r0 = xs + ((2 * mr + 2) * T::XC + 2 * nc + 2) * CIN + ci;
      const float* r1 = r0 + T::XC * CIN;
      pooled[ci] = 0.25f * ((r0[0] + r0[CIN]) + (r1[0] + r1[CIN]));
    }
    float out[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = slot_channel<COUT>(cog, j);
      float v = acc[k][j] + b2s[co] + b3s[co];
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) v = fmaf(pooled[ci], w3s[ci * COUT + co], v);
      out[j] = v;
    }
    __nv_bfloat16* dst = yb + ((size_t)m * Wo + n) * COUT + cog * 4;
    __nv_bfloat162* d0 = reinterpret_cast<__nv_bfloat162*>(dst);
    __nv_bfloat162* d1 = reinterpret_cast<__nv_bfloat162*>(dst + COUT / 2);
    d0[0] = __floats2bfloat162_rn(out[0], out[1]);
    d0[1] = __floats2bfloat162_rn(out[2], out[3]);
    d1[0] = __floats2bfloat162_rn(out[4], out[5]);
    d1[1] = __floats2bfloat162_rn(out[6], out[7]);
  }
}

template <int CIN, int COUT>
cudaError_t launch(const void* x, const void* code, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3, const void* b3, void* y,
                   int B, int H, int W, cudaStream_t stream) {
  using T = Tile<COUT>;
  constexpr size_t smem = smem_bytes<CIN, COUT>();
  auto kern = first_dblock_kernel<CIN, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W / 2 + T::TC - 1) / T::TC, (H / 2 + kTR - 1) / kTR, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(code),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(y), H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mcgm_first_dblock(const void* x, const void* code, const void* w1,
                                 const void* b1, const void* w2, const void* b2,
                                 const void* w3, const void* b3, void* y, int B, int H,
                                 int W, int cin, int cout, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 2 || W % 2 || H / 2 / kTR >= 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 3 && cout == 64) return launch<3, 64>(x, code, w1, b1, w2, b2, w3, b3, y, B, H, W, s);
  if (cin == 3 && cout == 128) return launch<3, 128>(x, code, w1, b1, w2, b2, w3, b3, y, B, H, W, s);
  if (cin == 1 && cout == 64) return launch<1, 64>(x, code, w1, b1, w2, b2, w3, b3, y, B, H, W, s);
  if (cin == 1 && cout == 128) return launch<1, 128>(x, code, w1, b1, w2, b2, w3, b3, y, B, H, W, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
