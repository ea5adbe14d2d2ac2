// Causal 3x3x3 stride-1 convolution for Hopper (sm_90a), as an implicit GEMM.
//
// Replaces the Pallas TPU kernel worldforge_tpu/ops/conv3d.py::_conv_kernel
// (pallas_call at :119, through conv3d_causal_pallas :77). Same contract:
//   x [B, T+2, H, W, Cin] already front-padded in time by the caller; SAME
//   spatial padding; w [3, 3, 3, Cin, Cout]; bias [Cout] fp32;
//   y [B, T, H, W, Cout]. Inputs and weights are rounded to bf16, products
//   accumulate in fp32 over the 27 taps x Cin, then the fp32 bias is added
//   and the sum is cast to the output type.
// As the Pallas wrapper casts x to bf16 before its kernel, the wrapper here
// hands over x as bf16 with Cin zero-padded to CinP, a multiple of 16, and
// the weights as bf16 [27, CinP, CoutP] (CoutP: Cout rounded up to 16).
//
// What bounds it on the H100: operations. The full-resolution 96 -> 96
// decoder conv at 480x832 and 17 frames is 2*27*96*96*H*W*T = 3.4 TFLOP
// against ~4 GB of bf16 input and fp32 output. The design runs the products
// on the tensor cores and reuses each staged input element 9 * BN times:
//   * one block of 8 warps computes an 8-row x 16-pixel output tile of one
//     output frame for a BN-wide slice of Cout (BN up to 128, picked to
//     divide CoutP: Cout = 96 runs as one slice); warp w owns output row w
//     and keeps its 16 x BN fp32 accumulator in mma fragments;
//   * the K loop walks (16-channel chunk of Cin) x (temporal tap); each
//     stage stages the halo'd [10, 18, 16] bf16 input slab (zero outside
//     the image, which also masks a ragged W such as 104) and the
//     [9, 16, BN] bf16 weight slice with cp.async, double-buffered so the
//     next stage loads while this one computes, and issues 9 spatial taps
//     of m16n8k16 bf16 mma.sync per 8 output channels (operands through
//     ldmatrix; the slab's two 16-byte channel halves are swizzled by pixel
//     so the 8 rows of an ldmatrix hit distinct banks);
//   * the epilogue adds the bias and stores from the fragments, masking the
//     ragged W / H / Cout edges.
// Simple and correct first: no TMA and no wgmma (a later change).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBH = 8;        // output rows per block (one per warp)
constexpr int kBW = 16;       // output pixels per row (one mma M tile)
constexpr int kCK = 16;       // Cin chunk (one mma K step)
constexpr int kThreads = kBH * 32;
constexpr int kSlabPix = (kBH + 2) * (kBW + 2);
constexpr int kSlab = kSlabPix * kCK;               // bf16 elements

template <int BN>
struct ConvSmem {
  static constexpr int LDW = BN + 8;      // 16-byte bank shift per row
  static constexpr int stage = kSlab + 9 * kCK * LDW;
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * 2 * stage;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Offset of channel half `half` (8 channels) of slab pixel `pix`.
__device__ __forceinline__ int slab_off(int pix, int half) {
  return pix * kCK + ((half ^ ((pix >> 2) & 1)) << 3);
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool two) {
  if (two) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else p[0] = a;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b,
                                       bool two) {
  if (two) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else p[0] = __float2bfloat16(a);
}

template <typename TOut, int BN>
__global__ void __launch_bounds__(kThreads)
conv3d_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ bias, TOut* __restrict__ y, int Tp,
              int H, int W, int CinP, int Cout, int CoutP) {
  using L = ConvSmem<BN>;
  constexpr int NT = BN / 8;              // 8-wide output channel tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int T = Tp - 2;
  const int ntx = (W + kBW - 1) / kBW;
  const int x0 = (blockIdx.x % ntx) * kBW;
  const int y0 = (blockIdx.x / ntx) * kBH;
  const int b = blockIdx.y / T, t = blockIdx.y % T;
  const int n0 = blockIdx.z * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int nstages = (CinP / kCK) * 3;

  auto load_stage = [&](int s, int buf) {
    const int c0 = (s / 3) * kCK, kt = s % 3;
    __nv_bfloat16* slab = smem + buf * L::stage;
    __nv_bfloat16* wt = slab + kSlab;
    const __nv_bfloat16* xf = x + (long)(b * Tp + t + kt) * H * W * CinP;
    for (int i = threadIdx.x; i < kSlabPix * 2; i += kThreads) {
      const int pix = i >> 1, half = i & 1;
      const int gy = y0 - 1 + pix / (kBW + 2), gx = x0 - 1 + pix % (kBW + 2);
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long src = ok ? ((long)gy * W + gx) * CinP + c0 + half * 8 : 0;
      cp_async16(slab + slab_off(pix, half), xf + src, ok);
    }
    constexpr int VPR = BN / 8;           // 16-byte vectors per weight row
    for (int i = threadIdx.x; i < 9 * kCK * VPR; i += kThreads) {
      const int nv = i % VPR, c = (i / VPR) % kCK, tap = i / (kCK * VPR);
      cp_async16(wt + (tap * kCK + c) * L::LDW + nv * 8,
                 w + ((long)(kt * 9 + tap) * CinP + c0 + c) * CoutP + n0 +
                     nv * 8,
                 true);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      load_stage(s + 1, (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* slab = smem + (s & 1) * L::stage;
    const __nv_bfloat16* wt = slab + kSlab;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        uint32_t a[4];
        const int pix = (warp + kh) * (kBW + 2) + kw + (lane & 15);
        ldmatrix_x4(a, slab + slab_off(pix, lane >> 4));
        const __nv_bfloat16* wtap =
            wt + ((kh * 3 + kw) * kCK + (lane & 7) + ((lane >> 3) & 1) * 8) *
                     L::LDW + (lane >> 4) * 8;
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
          uint32_t bw[4];
          ldmatrix_x4_trans(bw, wtap + n2 * 16);
          mma_bf16(acc[2 * n2], a, bw[0], bw[1]);
          mma_bf16(acc[2 * n2 + 1], a, bw[2], bw[3]);
        }
      }
    }
    __syncthreads();   // the next refill of this buffer waits for all warps
  }

  const int gy = y0 + warp;
  if (gy >= H) return;
  TOut* yrow = y + ((long)(b * T + t) * H + gy) * W * Cout;
  const bool even = (Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int co = n0 + j * 8 + tig * 2;
    if (co >= Cout) continue;
    const bool two = co + 1 < Cout;
    const float b0 = bias[co], b1 = two ? bias[co + 1] : 0.f;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gx = x0 + g + hr * 8;
      if (gx >= W) continue;
      TOut* p = yrow + (long)gx * Cout + co;
      if (two && even) {
        store2(p, acc[j][2 * hr] + b0, acc[j][2 * hr + 1] + b1, true);
      } else {
        store2(p, acc[j][2 * hr] + b0, 0.f, false);
        if (two) store2(p + 1, acc[j][2 * hr + 1] + b1, 0.f, false);
      }
    }
  }
}

template <typename TOut, int BN>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   int B, int Tp, int H, int W, int CinP, int Cout, int CoutP,
                   cudaStream_t stream) {
  const size_t bytes = ConvSmem<BN>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_kernel<TOut, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int T = Tp - 2;
  const int ntiles = ((W + kBW - 1) / kBW) * ((H + kBH - 1) / kBH);
  dim3 grid(ntiles, B * T, CoutP / BN);
  conv3d_kernel<TOut, BN><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<TOut*>(y), Tp, H, W, CinP, Cout, CoutP);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_bn(int BN, const void* x, const void* w, const void* bias,
                      void* y, int B, int Tp, int H, int W, int CinP,
                      int Cout, int CoutP, cudaStream_t s) {
  switch (BN) {
    case 16: return launch<TOut, 16>(x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
    case 32: return launch<TOut, 32>(x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
    case 48: return launch<TOut, 48>(x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
    case 64: return launch<TOut, 64>(x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
    case 96: return launch<TOut, 96>(x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
    case 128: return launch<TOut, 128>(x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: bf16 [B, Tp, H, W, CinP]; w: bf16 [27, CinP, CoutP]; bias fp32 [Cout];
// y [B, Tp-2, H, W, Cout] of out_dtype (0 = float32, 1 = bfloat16). CinP and
// CoutP are multiples of 16 and BN (16, 32, 48, 64, 96 or 128) divides CoutP.
// Returns cudaGetLastError() after the launch.
int wf_conv3d_causal(const void* x, const void* w, const void* bias, void* y,
                     int B, int Tp, int H, int W, int CinP, int Cout,
                     int CoutP, int BN, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tp < 3 || CinP % kCK != 0 || CoutP % 16 != 0 || BN <= 0 ||
      CoutP % BN != 0 || Cout > CoutP)
    return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return launch_bn<float>(BN, x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
  if (out_dtype == 1)
    return launch_bn<__nv_bfloat16>(BN, x, w, bias, y, B, Tp, H, W, CinP, Cout, CoutP, s);
  return (int)cudaErrorInvalidValue;
}

const char* wf_conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
