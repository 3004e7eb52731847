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
// int8_quantize: x [B, E] (f32 or bf16, E = H W C of one NHWC example),
// amax per example (dynamic: one launch of int8_quantize_kernel_amax, an
// atomicMax of |x|'s bits per example, which orders as the floats do) or
// one scalar read from the device (static: the calibrated act_amax), then
// int8_quantize_kernel_apply writes q [B, E] int8 and scale [B] f32.
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
//   reads its 4 C-long slice. The kernel writes the interleaved output.
//
// Bound on an H100 SXM: at the GAN's 3x3 256 -> 256 at 32 px and B = 1,000
// the 1.2 T int8 operations take 0.61 ms at 1,979 TOP/s, the 0.79 GB of x,
// w and the bf16 output 0.24 ms at 3.35 TB/s: the operations bound it; the
// 1x1s, the Dense layers and the 3-channel head are bound by their bytes.
//
// Design: one block computes a 128 x 128 tile (output pixels x channels) of
// one phase with 8 warps of 64 x 32 (128 x 64 and 4 warps where N <= 64),
// with mma.sync.m16n8k32 s8 on the tensor cores, fragments by ldmatrix; K
// in chunks of 64 bytes, staged to shared memory by cp.async with zero
// fill (padding, tile edges), four stages (80 KB a block, two blocks an
// SM). A row of a chunk is 16-byte
// pieces of one tap when C % 16 == 0; other C (a Dense of a one-hot) load
// byte by byte. The epilogue stores a thread's two neighbouring channels
// together. A simple kernel: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBK = 64, kStages = 4;
constexpr int kLds = kBK + 16;  // padded row stride in bytes: conflict-free ldmatrix

// Dynamic shared memory of a block with kWN warps across N: kStages slots of
// an A tile (kBM rows) and a B tile (32 kWN rows), kLds bytes a row.
constexpr int conv_smem_bytes(int wn) { return kStages * (kBM + 32 * wn) * kLds; }
constexpr int kQuantThreads = 256;
constexpr int kQuantChunk = 8192;  // elements of one example per quantize block

enum { kDirect = 0, kUp2 = 1 };
enum { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
int8_quantize_kernel_amax(const T* __restrict__ x, long long E, unsigned int* __restrict__ amax) {
  const int b = blockIdx.y;
  const long long lo = (long long)blockIdx.x * kQuantChunk;
  const long long hi = min(E, lo + kQuantChunk);
  const T* xb = x + (long long)b * E;
  float m = 0.f;
  for (long long i = lo + threadIdx.x; i < hi; i += kQuantThreads) m = fmaxf(m, fabsf(load_f(xb, i)));
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kQuantThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax + b, __float_as_uint(m));  // m >= 0: its bits order as the floats
  }
}

// amax_bits [B] (dynamic) or amax_static (one float) gives the scale.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
int8_quantize_kernel_apply(const T* __restrict__ x, long long E,
                           const unsigned int* __restrict__ amax_bits,
                           const float* __restrict__ amax_static, int8_t* __restrict__ q,
                           float* __restrict__ scale) {
  const int b = blockIdx.y;
  const float amax = amax_static ? *amax_static : __uint_as_float(amax_bits[b]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[b] = s;
  const long long lo = (long long)blockIdx.x * kQuantChunk;
  const long long hi = min(E, lo + kQuantChunk);
  const T* xb = x + (long long)b * E;
  int8_t* qb = q + (long long)b * E;
  for (long long i = lo + threadIdx.x; i < hi; i += kQuantThreads) {
    const float v = rintf(__fdiv_rn(load_f(xb, i), s));
    qb[i] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
template <bool kVec, int kOut, int kWN>
__global__ void __launch_bounds__(64 * kWN, 2)
int8_conv_kernel(ConvArgs p) {
  constexpr int kThreadsT = 64 * kWN, kBNT = 32 * kWN;
  constexpr int kArows = kThreadsT / 4;   // A rows one pass of the threads stages
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* const As = smem;                        // [kStages][kBM * kLds]
  int8_t* const Bs = smem + kStages * kBM * kLds;  // [kStages][kBNT * kLds]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int phase = blockIdx.z;
  const long long M = (long long)p.B * p.Ho * p.Wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBNT;
  const int8_t* wp = p.w + (long long)phase * p.K;  // this phase's slice of each row
  const int ktiles = (p.K + kBK - 1) / kBK;

  // the vector path: thread tid stages rows tid / 4 + kArows r of A and of
  // B, the 16-byte piece tid % 4 of each; its piece's k, tap (ky, kx) and
  // channel c advance with each tile staged (tiles are staged in order),
  // so no division runs in the loop
  constexpr int kAR = kBM / kArows, kBR = kBNT / kArows;
  const int piece = tid & 3;
  const int8_t* a_ptr[kAR];
  int a_y[kAR], a_x[kAR];
  bool a_ok[kAR];
#pragma unroll
  for (int r = 0; r < kAR; ++r) {
    const long long m = m0 + (tid >> 2) + kArows * r;
    a_ok[r] = m < M;
    const long long mm = a_ok[r] ? m : 0;
    a_x[r] = (int)(mm % p.Wo);
    a_y[r] = (int)((mm / p.Wo) % p.Ho);
    const long long b = mm / ((long long)p.Wo * p.Ho);
    a_ptr[r] = p.x + ((b * p.H + a_y[r]) * p.W + a_x[r]) * p.C;
  }
  const int8_t* b_ptr[kBR];
  bool b_ok[kBR];
#pragma unroll
  for (int r = 0; r < kBR; ++r) {
    const int n = n0 + (tid >> 2) + kArows * r;
    b_ok[r] = n < p.N;
    b_ptr[r] = wp + (long long)(b_ok[r] ? n : 0) * p.w_stride;
  }
  // the tap grid (kh x kw direct, 2 x 2 a phase) and its offset into x
  const int tw = p.layout == kDirect ? p.kw : 2;
  const int oy0 = p.layout == kDirect ? -p.pad : (phase >> 1) - 1;
  const int ox0 = p.layout == kDirect ? -p.pad : (phase & 1) - 1;
  int sk = piece * 16, stap = sk / p.C, sc = sk - stap * p.C;
  int sky = stap / tw, skx = stap - sky * tw;

  auto stage = [&](int buf, int kt) {
    const int k0 = kt * kBK;
    if (kVec) {
      const int dy = sky + oy0, dx = skx + ox0;
      const int off = (dy * p.W + dx) * p.C + sc;
#pragma unroll
      for (int r = 0; r < kAR; ++r) {
        const int iy = a_y[r] + dy, ix = a_x[r] + dx;
        const bool ok = a_ok[r] && sk < p.K && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
        cp_async16(As + buf * kBM * kLds + ((tid >> 2) + kArows * r) * kLds + piece * 16,
                   ok ? a_ptr[r] + off : p.x, ok);
      }
#pragma unroll
      for (int r = 0; r < kBR; ++r) {
        const bool ok = b_ok[r] && sk < p.K;
        cp_async16(Bs + buf * kBNT * kLds + ((tid >> 2) + kArows * r) * kLds + piece * 16,
                   ok ? b_ptr[r] + sk : p.w, ok);
      }
      sk += kBK;
      for (sc += kBK; sc >= p.C; sc -= p.C) {
        if (++skx == tw) {
          skx = 0;
          ++sky;
        }
      }
    } else {
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
  // kStages - 1 tiles in flight ahead of the one the warps multiply; one
  // group committed per step (empty past the end) keeps the wait count fixed
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in, and every warp is done with slot (kt - 1)
    if (kt + kStages - 1 < ktiles) stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
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
  cp_async_wait<0>();

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
          y[e] = __fmul_rn((float)acc[i][j][2 * h + e], __fmul_rn(p.wscale[ne], xs));
          if (kOut == kF32) {
            if (p.bias) y[e] = __fadd_rn(y[e], static_cast<const float*>(p.bias)[ne]);
          } else {
            y[e] = __bfloat162float(__float2bfloat16_rn(y[e]));
            if (p.bias)
              y[e] = __fadd_rn(
                  y[e], __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[ne]));
          }
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

template <bool kVec, int kOut, int kWN>
cudaError_t launch_conv(dim3 grid, const ConvArgs& p, cudaStream_t s) {
  constexpr int bytes = conv_smem_bytes(kWN);
  // above 48 KB only once the kernel is allowed it (per device: set each call)
  cudaError_t err = cudaFuncSetAttribute(int8_conv_kernel<kVec, kOut, kWN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int8_conv_kernel<kVec, kOut, kWN><<<grid, 64 * kWN, bytes, s>>>(p);
  return cudaSuccess;
}

template <typename T>
int quantize(const T* x, long long B, long long E, const float* amax_static, int8_t* q,
             float* scale, unsigned int* amax_bits, int* launched, cudaStream_t stream) {
  const dim3 grid((unsigned)((E + kQuantChunk - 1) / kQuantChunk), (unsigned)B);
  if (!amax_static) {
    cudaError_t err = cudaMemsetAsync(amax_bits, 0, sizeof(unsigned int) * B, stream);
    if (err != cudaSuccess) return err;
    int8_quantize_kernel_amax<T><<<grid, kQuantThreads, 0, stream>>>(x, E, amax_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  int8_quantize_kernel_apply<T><<<grid, kQuantThreads, 0, stream>>>(x, E, amax_bits, amax_static,
                                                                   q, scale);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// x [B, E] f32 (dtype 0) or bf16 (1); amax_static: a device float (static
// mode) or null (dynamic: amax_bits, B unsigned ints of scratch, is used);
// q [B, E] int8, scale [B] f32. *launched gains one per kernel launched
// (two a dynamic call, one a static one). Returns a cudaError_t.
extern "C" int mcgm_int8_quantize(const void* x, int dtype, long long B, long long E,
                                  const float* amax_static, int8_t* q, float* scale,
                                  unsigned int* amax_bits, int* launched, void* stream) {
  if (B <= 0 || E <= 0 || B > 65535 || (!amax_static && !amax_bits))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return quantize(static_cast<const float*>(x), B, E, amax_static, q, scale, amax_bits,
                    launched, s);
  if (dtype == kBF16)
    return quantize(static_cast<const __nv_bfloat16*>(x), B, E, amax_static, q, scale,
                    amax_bits, launched, s);
  return cudaErrorInvalidValue;
}

// x [B, H, W, C] int8, w [N, taps C] int8 (layout 0: kh kw taps; layout 1:
// 16 taps, phase-major), wscale [N] f32, xscale [B] f32, bias [N] in the
// output dtype or null, out [B, Ho, Wo, N] in out_dtype (0 f32, 1 bf16).
// Every pointer 16-byte aligned. Returns a cudaError_t.
extern "C" int mcgm_int8_conv(const int8_t* x, const int8_t* w, const float* wscale,
                              const float* xscale, const void* bias, void* out, int out_dtype,
                              int B, int H, int W, int C, int N, int layout, int kh, int kw,
                              int pad, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0) return cudaErrorInvalidValue;
  ConvArgs p{x, w, wscale, xscale, bias, out, B, H, W, C, N, layout, kh, kw, pad, 0, 0, 0, 0};
  int phases;
  if (layout == kDirect) {
    p.Ho = H + 2 * pad - kh + 1;
    p.Wo = W + 2 * pad - kw + 1;
    p.K = kh * kw * C;
    p.w_stride = p.K;
    phases = 1;
  } else if (layout == kUp2) {
    p.Ho = H;  // per phase; the output is 2H x 2W
    p.Wo = W;
    p.K = 4 * C;
    p.w_stride = 16 * C;
    phases = 4;
  } else {
    return cudaErrorInvalidValue;
  }
  if (p.Ho <= 0 || p.Wo <= 0) return cudaErrorInvalidValue;
  const long long M = (long long)B * p.Ho * p.Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 16 == 0, wide = N > 64;  // wide: 128 channels a block, 8 warps
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + (wide ? 127 : 63)) /
                                                               (wide ? 128 : 64)), phases);
#define MCGM_INT8_LAUNCH(VEC, OUT)                                                   \
  if (wide) err = launch_conv<VEC, OUT, 4>(grid, p, s);                            \
  else err = launch_conv<VEC, OUT, 2>(grid, p, s);
  cudaError_t err;
  if (out_dtype == kF32) {
    if (vec) { MCGM_INT8_LAUNCH(true, kF32) } else { MCGM_INT8_LAUNCH(false, kF32) }
  } else if (out_dtype == kBF16) {
    if (vec) { MCGM_INT8_LAUNCH(true, kBF16) } else { MCGM_INT8_LAUNCH(false, kBF16) }
  } else {
    return cudaErrorInvalidValue;
  }
#undef MCGM_INT8_LAUNCH
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* mcgm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
