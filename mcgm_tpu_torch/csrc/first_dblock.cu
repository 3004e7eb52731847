// Fused first discriminator block of MCGAN, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/ab_first_block.py::pallas_block (its body
// `_kernel`, reference `xla_block`): the function of
// mcgm_tpu/models/gan.py::_MCFirstDisResBlock with the model's biases and
// spectrally normalised weights:
//
//   h[b,i,j,:] = relu(conv3x3_pad1(x)[b,i,j,:] + b1) * code[b,:]   (bf16)
//   y[b,m,n,:] = sum_{4x4 taps} h . w2f (stride 2, pad 1) + b2
//                + avgpool2(x)[b,m,n,:] . w3 + b3
//
// w2f is the 4x4 fold of conv3x3 + avgpool2 (the wrapper's prologue builds
// it, with the SN division of every weight and code = indicator @ codebook).
// The full-resolution h never reaches device memory: each tile's h is
// computed into shared memory, in bf16 as the Pallas kernel keeps it.
//
// Bound on an H100 SXM at B=128, 128x128x3 -> 64x64x64: conv1 2.10 M
// positions x 64 x 27 MACs, conv2 0.52 M x 64 x 1024 MACs, the shortcut
// 0.2 GFLOP: ~76 GFLOP, 77 us at 989 TFLOP/s bf16. Device memory: 12.6 MB
// of x read, 67 MB of y written, ~24 us at 3.35 TB/s. So the tensor cores
// bound it; the unfused chain would also write and read the 268 MB h.
//
// Design: both convolutions are implicit GEMMs on the tensor cores, bf16
// operands and f32 sums.
// - Persistent blocks of 8 warps (two warpgroups), as many as fit on the
//   SMs, walk work items (sample, tile of TR x TC output positions). TR = 4;
//   TC = 32 at C_out 64, 16 at C_out 128, so a tile has 128 x 64 or
//   64 x 128 outputs.
// - conv1 (mma.sync.m16n8k16): M = the tile's (2TR+2) x (2TC+2) h positions,
//   N = C_out, K = 9 C_in padded to 32 (16 at C_in 1). A is gathered from the
//   x halo tile (im2col in registers); B is w1 packed [C_out][K], held in
//   registers with b1 and the code. The epilogue adds b1, applies ReLU and
//   the mode code, zeroes positions outside the image (conv2's padding),
//   rounds to bf16 and stores into the h tile.
// - conv2 (wgmma.m64n64k16, A from registers, B from shared memory): each
//   warpgroup takes 64 output positions x 64 channels, K = 16 taps x C_out.
//   A rows of one tap are h positions two apart, which no shared-memory
//   descriptor can describe, so each warp loads its 16 rows with ldmatrix;
//   the h tile swizzles each position's 16-byte chunks by
//   (position >> 1) & 7 so that the 8 rows of an 8x8 matrix hit 8 bank
//   groups. The next tap's A is loaded while the current tap's wgmmas run.
//   B is w2f packed [tap][C_out][C_in] and laid out in shared memory in
//   wgmma's K-major 128-byte swizzle.
// - w2f: at C_out 64 (128 KB bf16) it is loaded once per block and stays
//   resident beside the 84 KB h tile; at C_out 128 (512 KB) it streams tap by
//   tap (32 KB) through a double buffer with cp.async.
// - The next work item's x halo and code row are prefetched with cp.async
//   while the current item's conv2 runs.
// - Epilogue: + b2 + b3 + avgpool2(x) . w3 (f32, from the x tile), bf16 y
//   staged in shared memory and written in 16-byte coalesced stores.
//
// Shapes: C_in in {1, 3}, C_out in {64, 128}, H and W even. x, y NHWC
// contiguous bf16 (x 4-byte aligned); code [B,C_out] f32 (16-byte aligned);
// w1 packed [C_out][K] bf16 with K = 32 (C_in 3) or 16 (C_in 1),
// k = (dy*3+dx)*C_in + ci, zero for k >= 9 C_in; w2 packed
// [16][C_out][C_out] bf16, tap = ky*4+kx, C_in innermost (both 16-byte
// aligned); w3 [C_in,C_out] bf16; b1, b2, b3 [C_out] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int CIN, int COUT>
struct Cfg {
  static constexpr bool RESIDENT = COUT == 64;           // w2f kept in shared memory
  static constexpr int TR = 4;                           // output rows per tile
  static constexpr int TC = COUT == 64 ? 32 : 16;        // output columns per tile
  static constexpr int M = TR * TC;                      // conv2 GEMM rows
  static constexpr int HR = 2 * TR + 2, HC = 2 * TC + 2; // h tile
  static constexpr int HP = HR * HC;                     // h positions
  static constexpr int XR = HR + 2, XC = HC + 2;         // x halo tile
  static constexpr int XBYTES = (XR * XC * CIN * 2 + 15) / 16 * 16;
  static constexpr int XWORDS = XC * CIN / 2;            // 4-byte words per x tile row
  static constexpr int K1 = CIN == 3 ? 32 : 16;          // conv1 depth, padded
  static constexpr int W1S = K1 + 8;                     // w1 row stride in smem (bank spread)
  static constexpr int MT1 = (HP + 15) / 16;             // conv1 m16 tiles
  static constexpr int NH = COUT / 64;                   // conv1 n64 halves (one per warp)
  static constexpr int ROWB = COUT * 2;                  // bytes of one h position / w2 row
  static constexpr int TAPB = COUT * ROWB;               // bytes of one w2f tap
  static constexpr int W2B = RESIDENT ? 16 * TAPB : 2 * TAPB;
  // shared-memory layout, byte offsets
  static constexpr int O_W2 = 0;
  static constexpr int O_H = O_W2 + W2B;
  static constexpr int O_X = O_H + HP * ROWB;
  static constexpr int O_W1 = O_X + 2 * XBYTES;
  static constexpr int O_CODE = O_W1 + COUT * W1S * 2;
  static constexpr int O_B1 = O_CODE + 2 * COUT * 4;
  static constexpr int O_B23 = O_B1 + COUT * 4;
  static constexpr int O_W3 = O_B23 + COUT * 4;
  static constexpr int SMEM = O_W3 + CIN * COUT * 4;
  static_assert(M * COUT == 2 * 64 * 64, "two warpgroups of 64 x 64 cover the conv2 tile");
  static_assert(TC % 16 == 0, "an m16 tile must stay in one output row");
  static_assert(SMEM <= 232448, "over the 227 KB a block can use");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// 4 bytes, or 4 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ float bf(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// One w2f tap into shared memory as wgmma's B: K-major, 128-byte swizzle,
// in blocks of 64 input channels ([ci / 64][co][128 bytes]).
template <int COUT>
__device__ __forceinline__ void load_w2_tap(uint32_t dst, const __nv_bfloat16* w2, int tap,
                                            int tid) {
  constexpr int CPR = COUT / 8;  // 16-byte chunks per row
  const __nv_bfloat16* src = w2 + (size_t)tap * COUT * COUT;
  for (int i = tid; i < COUT * CPR; i += kThreads) {
    const int co = i / CPR, ch = i % CPR;
    cp_async16(dst + (ch >> 3) * COUT * 128 + co * 128 + (((ch & 7) ^ (co & 7)) << 4),
               src + i * 8);
  }
}

// The x halo tile (zero outside the image) and the code row of one work item.
template <int CIN, int COUT>
__device__ __forceinline__ void load_item(uint32_t xdst, uint32_t cdst,
                                          const __nv_bfloat16* x, const float* code, int b,
                                          int m0, int n0, int H, int W, int tid) {
  using C = Cfg<CIN, COUT>;
  const char* xb = reinterpret_cast<const char*>(x);
  const int rowbytes = W * CIN * 2;
  const int col0 = (2 * n0 - 2) * CIN * 2;  // byte of the tile's first column in a row
  for (int i = tid; i < C::XR * C::XWORDS; i += kThreads) {
    const int r = i / C::XWORDS, wd = i % C::XWORDS;
    const int gr = 2 * m0 - 2 + r, cb = col0 + 4 * wd;
    const bool valid = gr >= 0 && gr < H && cb >= 0 && cb + 4 <= rowbytes;
    const char* src = valid ? xb + ((size_t)b * H + gr) * rowbytes + cb : xb;
    cp_async4(xdst + r * C::XC * CIN * 2 + 4 * wd, src, valid);
  }
  for (int i = tid; i < COUT / 4; i += kThreads)
    cp_async16(cdst + 16 * i, code + (size_t)b * COUT + 4 * i);
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, 1)
first_dblock_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ code,
                    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                    const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
                    __nv_bfloat16* __restrict__ y, int B, int H, int W) {
  using C = Cfg<CIN, COUT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s_w2 = smem_addr(smem + C::O_W2);
  const uint32_t s_h = smem_addr(smem + C::O_H);
  const uint32_t s_x = smem_addr(smem + C::O_X);
  const uint32_t s_code = smem_addr(smem + C::O_CODE);
  const __nv_bfloat16* w1s = reinterpret_cast<const __nv_bfloat16*>(smem + C::O_W1);
  const float* b1s = reinterpret_cast<const float*>(smem + C::O_B1);
  const float* b23s = reinterpret_cast<const float*>(smem + C::O_B23);
  const float* w3s = reinterpret_cast<const float*>(smem + C::O_W3);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int Ho = H / 2, Wo = W / 2;
  const int nCT = (Wo + C::TC - 1) / C::TC, nRT = (Ho + C::TR - 1) / C::TR;
  const int per_b = nRT * nCT, items = B * per_b;
  int item = blockIdx.x;
  if (item >= items) return;

  // ---- once per block: biases, w3, w1, w2f (all of it, or its first tap)
  {
    float* b1w = reinterpret_cast<float*>(smem + C::O_B1);
    float* b23w = reinterpret_cast<float*>(smem + C::O_B23);
    float* w3w = reinterpret_cast<float*>(smem + C::O_W3);
    for (int i = tid; i < COUT; i += kThreads) {
      b1w[i] = b1[i];
      b23w[i] = b2[i] + b3[i];
    }
    for (int i = tid; i < CIN * COUT; i += kThreads) w3w[i] = __bfloat162float(w3[i]);
    const uint32_t s_w1 = smem_addr(w1s);
    for (int i = tid; i < COUT * C::K1 / 8; i += kThreads) {
      const int n = i / (C::K1 / 8), ch = i % (C::K1 / 8);
      cp_async16(s_w1 + n * C::W1S * 2 + ch * 16, w1 + i * 8);
    }
    if constexpr (C::RESIDENT) {
      for (int t = 0; t < 16; ++t) load_w2_tap<COUT>(s_w2 + t * C::TAPB, w2, t, tid);
    } else {
      load_w2_tap<COUT>(s_w2, w2, 0, tid);
    }
    const int b = item / per_b, rem = item % per_b;
    load_item<CIN, COUT>(s_x, s_code, x, code, b, (rem / nCT) * C::TR, (rem % nCT) * C::TC,
                         H, W, tid);
    cp_async_commit();
  }

  // conv1: x-tile offsets of this thread's 4 k indices per k16 step
  int koff[C::K1 / 16][4];
#pragma unroll
  for (int s = 0; s < C::K1 / 16; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * s + 2 * t4 + (j & 1) + (j >> 1) * 8;
      const int tap = k / CIN;
      koff[s][j] = k < 9 * CIN ? ((tap / 3) * C::XC + tap % 3) * CIN + k % CIN : 0;
    }

  // conv2: warpgroup wg takes 64 rows (m_off) x 64 channels (n_off); each
  // of its warps loads A for 16 of the rows with ldmatrix.
  const int wg = warp >> 2;
  const int m_off = (wg % (C::M / 64)) * 64, n_off = (wg / (C::M / 64)) * 64;
  const int qa = [&] {  // h position of tap (0,0) for this lane's A row
    const int p = m_off + (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    return 2 * (p / C::TC) * C::HC + 2 * (p % C::TC);
  }();
  const int a_hi = lane >> 4;  // k chunk offset of this lane's 8x8 matrix
  constexpr int KS = COUT / 16;  // k16 steps per tap
  // A fragments of one tap: KS ldmatrix.x4 (h rows of the tap, swizzled)
  auto load_a = [&](uint32_t(&a)[KS][4], int tap) {
    const int q = qa + (tap >> 2) * C::HC + (tap & 3);
    const uint32_t row = s_h + q * C::ROWB;
    const int sw = (q >> 1) & 7;
#pragma unroll
    for (int s = 0; s < KS; ++s) ldmatrix_x4(a[s], row + (((2 * s + a_hi) ^ sw) << 4));
  };
  // KS wgmmas of one tap, committed as one group
  auto mma_tap = [&](float(&d)[32], uint32_t(&a)[KS][4], uint32_t s_tap) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s)
      wgmma_64x64x16(d, a[s], sw128_desc(s_tap + (s >> 2) * COUT * 128 + n_off * 128 +
                                         (s & 3) * 32));
    wgmma_commit();
  };

  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  int cur = 0;
  for (; item < items; item += gridDim.x, cur ^= 1) {
    const int b = item / per_b, rem = item % per_b;
    const int m0 = (rem / nCT) * C::TR, n0 = (rem % nCT) * C::TC;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + C::O_X + cur * C::XBYTES);
    const float* cs = reinterpret_cast<const float*>(smem + C::O_CODE + cur * COUT * 4);

    // ---- conv1 on the tensor cores: h tile = relu(x * w1 + b1) * code.
    // A warp keeps one 64-channel half of N, and its b1, code and w1
    // fragments in registers, across its m16 tiles.
    const int nh = warp % C::NH;
    float2 bv[8], cv[8];
    uint32_t wf[C::K1 / 16][8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nh * 64 + nt * 8 + 2 * t4;
      bv[nt] = *reinterpret_cast<const float2*>(b1s + c);
      cv[nt] = *reinterpret_cast<const float2*>(cs + c);
#pragma unroll
      for (int s = 0; s < C::K1 / 16; ++s) {
        const __nv_bfloat16* wr = w1s + (nh * 64 + nt * 8 + g) * C::W1S + 16 * s + 2 * t4;
        wf[s][nt][0] = *reinterpret_cast<const uint32_t*>(wr);
        wf[s][nt][1] = *reinterpret_cast<const uint32_t*>(wr + 8);
      }
    }
    const unsigned short* xr = reinterpret_cast<const unsigned short*>(xs);
    for (int mt = warp / C::NH; mt < C::MT1; mt += kWarps / C::NH) {
      const int q0 = mt * 16 + g;
      int base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = min(q0 + 8 * r, C::HP - 1);
        base[r] = ((q / C::HC) * C::XC + q % C::HC) * CIN;
      }
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int s = 0; s < C::K1 / 16; ++s) {
        uint32_t a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // a[j]: row half j & 1, k pair j >> 1
          const int bb = base[j & 1], kk = (j >> 1) * 2;
          a[j] = (uint32_t)xr[bb + koff[s][kk]] | ((uint32_t)xr[bb + koff[s][kk + 1]] << 16);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[nt], a, wf[s][nt][0], wf[s][nt][1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + 8 * r;
        if (q >= C::HP) continue;
        const int gr = 2 * m0 - 1 + q / C::HC, gc = 2 * n0 - 1 + q % C::HC;
        const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
        const int sw = (q >> 1) & 7;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nh * 64 + nt * 8 + 2 * t4;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(acc[nt][2 * r] + bv[nt].x, 0.f) * cv[nt].x;
            v1 = fmaxf(acc[nt][2 * r + 1] + bv[nt].y, 0.f) * cv[nt].y;
          }
          *reinterpret_cast<__nv_bfloat162*>(smem + C::O_H + q * C::ROWB +
                                             (((c >> 3) ^ sw) << 4) + (c & 7) * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();

    // ---- prefetch the next work item's x halo and code row
    {
      const int nxt = item + gridDim.x;
      if (nxt < items) {
        const int nb = nxt / per_b, nr = nxt % per_b;
        load_item<CIN, COUT>(s_x + (cur ^ 1) * C::XBYTES, s_code + (cur ^ 1) * COUT * 4, x,
                             code, nb, (nr / nCT) * C::TR, (nr % nCT) * C::TC, H, W, tid);
      }
      cp_async_commit();
    }

    // ---- conv2 on the tensor cores (wgmma): 16 taps x C_out deep
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    hold(acc);
    if constexpr (C::RESIDENT) {
      // A of the next tap is loaded while the current tap's wgmmas run
      uint32_t a0[KS][4], a1[KS][4];
      load_a(a0, 0);
      for (int tap = 0; tap < 16; tap += 2) {
        mma_tap(acc, a0, s_w2 + tap * C::TAPB);
        wgmma_wait<1>();  // retires tap - 1, which read a1
        hold(a1);
        load_a(a1, tap + 1);
        mma_tap(acc, a1, s_w2 + (tap + 1) * C::TAPB);
        wgmma_wait<1>();  // retires tap, which read a0
        hold(a0);
        if (tap + 2 < 16) load_a(a0, tap + 2);
      }
    } else {
      uint32_t a[KS][4];
      for (int tap = 0; tap < 16; ++tap) {
        // the previous tap's wgmmas are done with their buffer; this tap is in,
        // and every warp is done with the buffer the next tap goes to
        wgmma_wait<0>();
        hold(a);
        cp_async_wait_all();
        fence_proxy_async();
        __syncthreads();
        load_w2_tap<COUT>(s_w2 + ((tap + 1) & 1) * C::TAPB, w2, (tap + 1) & 15, tid);
        cp_async_commit();
        load_a(a, tap);
        mma_tap(acc, a, s_w2 + (tap & 1) * C::TAPB);
      }
    }
    wgmma_wait<0>();
    hold(acc);

    // ---- epilogue: + b2 + b3 + avgpool2(x) . w3, rounded to bf16 and staged
    // in the h tile's space ([M][C_out], 16-byte chunk c of row p at
    // c ^ (p & 7)), then written out in 16-byte coalesced stores
    __syncthreads();  // every warp is done reading the h tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = m_off + (warp & 3) * 16 + g + 8 * r;
      const int mr = p / C::TC, nc = p % C::TC;
      float pooled[CIN];
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        const int o = ((2 * mr + 2) * C::XC + 2 * nc + 2) * CIN + ci;
        const int o2 = o + C::XC * CIN;
        pooled[ci] = 0.25f * ((bf(xs, o) + bf(xs, o + CIN)) + (bf(xs, o2) + bf(xs, o2 + CIN)));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = n_off + j * 8 + 2 * t4;
        float v0 = acc[4 * j + 2 * r] + b23s[co];
        float v1 = acc[4 * j + 2 * r + 1] + b23s[co + 1];
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          v0 = fmaf(pooled[ci], w3s[ci * COUT + co], v0);
          v1 = fmaf(pooled[ci], w3s[ci * COUT + co + 1], v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(smem + C::O_H + p * C::ROWB +
                                           (((co >> 3) ^ (p & 7)) << 4) + (co & 7) * 2) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();
    for (int i = tid; i < C::M * COUT / 8; i += kThreads) {
      const int p = i / (COUT / 8), ch = i % (COUT / 8);
      const int m = m0 + p / C::TC, n = n0 + p % C::TC;
      if (m >= Ho || n >= Wo) continue;
      *reinterpret_cast<uint4*>(y + (((size_t)b * Ho + m) * Wo + n) * COUT + ch * 8) =
          *reinterpret_cast<const uint4*>(smem + C::O_H + p * C::ROWB + ((ch ^ (p & 7)) << 4));
    }

    // the prefetch has landed, and every warp is done with the staged y
    cp_async_wait_all();
    __syncthreads();
  }
}

template <int CIN, int COUT>
cudaError_t launch(const void* x, const void* code, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3, const void* b3, void* y,
                   int B, int H, int W, cudaStream_t stream) {
  using C = Cfg<CIN, COUT>;
  auto kern = first_dblock_kernel<CIN, COUT>;
  // blocks that fit on the card at once, per device (set up on first use)
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, C::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const long long items = (long long)B * ((H / 2 + C::TR - 1) / C::TR) *
                          ((W / 2 + C::TC - 1) / C::TC);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(items < resident[dev] ? items : resident[dev]);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(code),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const __nv_bfloat16*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(y), B, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mcgm_first_dblock(const void* x, const void* code, const void* w1,
                                 const void* b1, const void* w2, const void* b2,
                                 const void* w3, const void* b3, void* y, int B, int H,
                                 int W, int cin, int cout, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || H % 2 || W % 2)
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
