// Flash attention for Hopper (sm_90a): dense, non-causal, per-batch kv length.
//
// Replaces the Pallas TPU kernel worldforge_tpu/ops/flash_attention.py::
// _fa_kernel (pallas_call at :124, through _flash_attention_bhsd :103 and
// flash_attention :164). Same contract:
//   q [B, Sq, H, D], k/v [B, Sk, H, D] (contiguous), kv_lens [B] int32.
//   Keys at or past kv_lens[b] are masked with a finite -1e30; a kv tile that
//   lies wholly past kv_lens[b] is skipped, so kv_len = 0 gives zeros.
//   Online softmax with fp32 m / l / accumulator. In bf16 the probabilities
//   are rounded to bf16 before the P.V product, as the Pallas kernel casts p
//   to v.dtype. Optional m and l outputs [B, H, Sq] fp32 (return_lse).
//
// What bounds it on the H100: operations. At the Wan2.1-14B 480p shape
// (20,280 tokens, 40 heads of 128) one self-attention is 4*S^2*D*H = 8.4
// TFLOP against 0.83 GB of q/k/v/o, far above the card's ~295 FLOP/byte
// ridge; the SVD UNet's fp32 spatial attention ([110, 6656, 5, 64]) is 3 x
// 6.2 TFLOP of TF32 products against 1.9 GB. So both dtypes run on the
// tensor cores:
//   * bf16 (d = 64, 128): the shared wgmma / TMA main loop of
//     attention_sm90.cuh with the dense tile source: 128 query rows per
//     block, a producer warp keeping two 128-key K/V stages in flight with
//     TMA, S and O += P.V as wgmma from shared memory and registers. The
//     tensor maps are 4D (D, H, S, B), so the ragged last tile of a batch
//     row is zero-filled by TMA instead of reading the next batch row.
//   * bf16 d = 128 at short key runs (the text, CLIP, FLF2V-image and
//     audio cross-attention): attention_short_sm90.cuh, persistent blocks
//     walking (head, query tile) items head by head, Q in 2-4 buffers
//     loaded ahead by TMA, K / V resident for a head where they fit (else
//     streamed through a two-stage ring), key tiles cut to the keys (the
//     last one 16, 32, 64 or 128 wide), O stored by TMA from shared
//     memory while the next items compute. The host (ops/
//     flash_attention.py::_bf16_plan) picks the route by key count, the
//     walk and the grid, and passes them to the entry point, which refuses
//     any it does not compile; the layout follows from the route and the
//     key count (attention_bf16_plan.cuh, which the host reads through
//     flash_plan.cpp).
//   * fp32 keeps fp32 accuracy through 3xTF32: every product is three TF32
//     products hi.hi + hi.lo + lo.hi (hi = the input rounded to TF32 with
//     cvt.rna, lo = the rest rounded again; lo.lo is below fp32 rounding).
//     One TF32 pass keeps about three decimal digits. The bound is the
//     three products at the card's 495 TFLOP/s TF32 rate.
//   * fp32 d = 64, 80, 128 (the SVD UNet, VGGT, CLIP-H, VGGT's camera
//     trunk): attention_f32_sm90.cuh, both products as wgmma m64nNk8 .tf32.
//     A producer warp fills Q once and a ring of two K/V stages (64 keys at
//     d 64, 32 at d 80 and 128) with TMA over the same 4D maps, each stage
//     behind mbarriers. Every operand is split once: three splitter warps
//     split each K tile in place into a TF32 hi plane with a lo plane beside
//     it (the split is elementwise, so TMA's swizzled layout carries over)
//     and V into hi / lo planes of V^T; Q is split once a block, in the
//     consumers' registers at d 64 and 80 (S's A operand from registers,
//     which halves S's shared-memory reads), in shared memory by the
//     splitter at d 128 (its fragments would take 128 registers a thread).
//     TF32 wgmma reads only K-major operands from shared memory, and V
//     [keys, D] is not K-major for P.V: the splitter writes V^T [D, keys]
//     with keys inner, in the 128-byte swizzle, and with the keys of each
//     8-key step in the order 0 2 4 6 1 3 5 7. That order puts P in
//     wgmma's register A layout as it is: S's accumulator holds keys 2t,
//     2t + 1 of a step in a thread where the A fragment reads k-columns t,
//     t + 4, and the softmax and the P.V sum do not depend on key order. So
//     S, P and O stay in registers; P is split in registers. Two consumer
//     warpgroups of 64 query rows (one at d 128) run S = Q.K^T and O +=
//     P.V (A from registers), taking turns to issue S so one's softmax
//     overlaps the other's products. The tensor cores truncate as they add
//     into an fp32 accumulator, a bias that grows with the count of
//     products summed: S is summed in runs of at most 8 k-steps, each run's
//     cross terms first and hi.hi last, the runs added in fp32; each tile's
//     P.V is summed in a fresh accumulator and added to O in fp32. At d 64 a
//     second variant for short rows (at most 64 keys, or a grid of
//     long-variant blocks below one wave) has one consumer warpgroup and
//     32-key tiles in 97 KB, so two blocks share an SM and one's loads and
//     split overlap another's epilogue. The host's plan (ops/
//     flash_attention.py::_fwd_plan) picks the variant and is passed to the
//     entry point, which runs only the plan its instantiation was compiled
//     for. No scratch in device memory: the split planes live in shared
//     memory (193 KB at d 64 and 128, 141 KB at d 80).
//   * fp32 d = 384, 512 (the Wan2.1 and SVD VAEs' single-head mid
//     attention) stay on the mma.sync kernel below (fa_f32_tf32_kernel),
//     chosen by head dim in wf_flash_attention_f32: a 64-row O accumulator
//     of 384 or 512 columns is 192 or 256 fp32 registers a thread in one
//     warpgroup, and Q's hi / lo planes alone are 196 or 262 KB, so the
//     wgmma layout above does not fit them. That kernel runs 3xTF32
//     mma.sync m16n8k8 products: each 16-row group has WPG warps, each
//     owning 1/WPG of O's columns and computing 1/WPG of S's depth; the
//     parts of S meet in shared memory, which also turns S from the
//     accumulator layout into P's A-operand layout. d = 384 runs 64 query
//     rows a block with two warps a group; d = 512 32 rows with four warps a
//     group: 64 rows would need 283 KB of shared memory for Q, K, V and S.
//     Both are 256 threads. K and V tiles of 32 keys are loaded with
//     cp.async, each while the other one is in use. Its products are summed
//     in short runs (a few k-steps of S, one kv tile of O) added in fp32.
//   * Blocks are numbered on gridDim.x alone (x = bh * qtiles + query tile),
//     whose limit is 2^31 - 1: on gridDim.y, B*H would stop at 65,535, and
//     the SVD UNet's temporal attention has B*H = (H/8)(W/8) x 5 rows at its
//     first level (81,920 at 1024 x 1024).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "attention_sm90.cuh"
#include "attention_short_sm90.cuh"
#include "attention_f32_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------- fp32 3xTF32

constexpr int kFK = 32;          // keys per kv tile
constexpr int kFThreads = 256;   // 8 warps: (QB / 16) groups x WPG warps

// The tiling of head dim D: QB query rows per block, WPG warps per 16-row
// group (QB / 16 * WPG = 8 warps).
template <int D>
struct F32Tile {
  static constexpr int QB = D > 384 ? 32 : 64;
  static constexpr int WPG = D > 384 ? 4 : 2;
  static_assert(QB / 16 * WPG * 32 == kFThreads, "8 warps a block");
};

template <int D>
struct F32Smem {
  static constexpr int QB = F32Tile<D>::QB, WPG = F32Tile<D>::WPG;
  // Row strides (floats) chosen so the fragment loads hit 32 distinct banks:
  // Q and K rows are read as (row lane/4, column lane%4), so a stride of 4
  // times an odd number mod 32 (4 for d 64, 128, 384, 512; 20 for d 80); V
  // rows as (row lane%4, column lane/4), so 8 mod 32 (24 for d 80).
  static constexpr int LQ = D + 4, LK = D + 4, LV = D + 8, LS = kFK + 4;
  static constexpr int q = 0, k = QB * LQ, v = k + kFK * LK,
                       s = v + kFK * LV;
  static constexpr size_t bytes = sizeof(float) * (s + WPG * QB * LS);
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows of D floats (global row stride `gs`) into shared memory
// with row stride `ld`; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int rows, int valid, long gs,
                                          int ld) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < rows * VPR; i += kFThreads) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c, src + (long)(ok ? r : 0) * gs + c, ok);
  }
}

// x = hi + lo, both TF32 (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a . b for a 16x8 (row) TF32 A, an 8x8 (col) TF32 B, fp32 C.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in fp32 accuracy: the small cross terms first, lo.lo dropped
// (it is below fp32 rounding).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const float (&b)[2]) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b[0], h0, l0);
  split_tf32(b[1], h1, l1);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, l0, l1);
  mma_tf32(c, ahi, h0, h1);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}

// One block per (QB-query tile, b*h); warp w takes rows 16*(w/WPG) .. +16
// and part w%WPG: O's columns [part*D/WPG, +D/WPG) and S's depth likewise.
// m16n8k8 fragments (g = lane/4, t = lane%4): A holds (g, t), (g+8, t),
// (g, t+4), (g+8, t+4); B holds (k t, n g), (k t+4, n g); C holds
// (g, 2t..2t+1) and (g+8, 2t..2t+1).
template <int D>
__global__ void __launch_bounds__(kFThreads, 1)
fa_f32_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const int* __restrict__ kv_lens, float* __restrict__ o,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int Sq, int Sk, int H, float scale) {
  using L = F32Smem<D>;
  constexpr int QB = L::QB, WPG = L::WPG;
  constexpr int HD = D / WPG;    // O columns / S depth per warp
  constexpr int NO = HD / 8;     // O column blocks per warp
  // The tensor cores add into their fp32 accumulator with truncation, a
  // bias that grows with the number of products summed: so each product
  // is summed over at most KC k-steps (S) or one kv tile (O), NG column
  // blocks at a time, and those partial sums are added in fp32.
  constexpr int KC = HD / 8 < 8 ? HD / 8 : 8;
  constexpr int NG = NO < 8 ? NO : 8;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm + L::q;
  float* Ks = fsm + L::k;
  float* Vs = fsm + L::v;
  float* Ss = fsm + L::s;        // [WPG parts][QB rows][LS]

  const int qtiles = (Sq + QB - 1) / QB;
  const int bh = blockIdx.x / qtiles, b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % qtiles) * QB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp / WPG, part = warp % WPG;
  const int r0 = rg * 16 + g, r1 = r0 + 8;       // this thread's rows
  const long rs = (long)H * D;                   // token stride
  const int kv_len = kv_lens != nullptr ? max(0, min(kv_lens[b], Sk)) : Sk;
  const int ntiles = (kv_len + kFK - 1) / kFK;   // tiles past kv_len skip
  const float* qb = q + ((long)b * Sq + q0) * rs + (long)h * D;
  const float* kb = k + (long)b * Sk * rs + (long)h * D;
  const float* vb = v + (long)b * Sk * rs + (long)h * D;

  if (ntiles > 0) {
    stage_f32<D>(Qs, qb, QB, min(QB, Sq - q0), rs, L::LQ);
    stage_f32<D>(Ks, kb, kFK, min(kFK, Sk), rs, L::LK);
  }
  cp_async_commit();
  if (ntiles > 0) stage_f32<D>(Vs, vb, kFK, min(kFK, Sk), rs, L::LV);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;           // this thread's part of their sums

  for (int t = 0; t < ntiles; ++t) {
    const int key0 = t * kFK;
    cp_async_wait<1>();               // Q and K(t) have landed
    __syncthreads();

    // this warp's part of S's depth: rows r0, r1 x 32 keys x D/WPG, summed
    // in chunks of KC k-steps that are added in fp32
    float sp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sp[j][0] = sp[j][1] = sp[j][2] = sp[j][3] = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < HD / 8; k0 += KC) {
      float tp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tp[j][0] = tp[j][1] = tp[j][2] = tp[j][3] = 0.f;
#pragma unroll
      for (int kk = k0; kk < k0 + KC; ++kk) {
        const int d0 = part * HD + kk * 8 + t4;
        const float a[4] = {Qs[r0 * L::LQ + d0], Qs[r1 * L::LQ + d0],
                            Qs[r0 * L::LQ + d0 + 4], Qs[r1 * L::LQ + d0 + 4]};
        uint32_t ahi[4], alo[4];
        split4(a, ahi, alo);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* kr = Ks + (8 * j + g) * L::LK + d0;
          const float bk[2] = {kr[0], kr[4]};
          mma_3xtf32(tp[j], ahi, alo, bk);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] += tp[j][e];
    }
    float* sh = Ss + part * QB * L::LS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float2*>(sh + r0 * L::LS + 8 * j + 2 * t4) =
          make_float2(sp[j][0], sp[j][1]);
      *reinterpret_cast<float2*>(sh + r1 * L::LS + 8 * j + 2 * t4) =
          make_float2(sp[j][2], sp[j][3]);
    }
    __syncthreads();                  // S parts written; K(t) is free
    if (t + 1 < ntiles)
      stage_f32<D>(Ks, kb + (long)(key0 + kFK) * rs, kFK,
                   min(kFK, Sk - key0 - kFK), rs, L::LK);
    cp_async_commit();

    // S = the sum of the WPG parts, read in P's A-operand layout: k-step kk
    // covers keys 8kk .. 8kk+7, s[kk] = (r0, t4), (r1, t4), (r0, t4+4),
    // (r1, t4+4)
    float s[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? r1 : r0;
        const int col = 8 * kk + t4 + (e >> 1) * 4;
        float sum = Ss[row * L::LS + col];
#pragma unroll
        for (int w = 1; w < WPG; ++w) sum += Ss[(w * QB + row) * L::LS + col];
        s[kk][e] = key0 + col < kv_len ? sum * scale : kNegInf;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mx0 = fmaxf(mx0, fmaxf(s[kk][0], s[kk][2]));
      mx1 = fmaxf(mx1, fmaxf(s[kk][1], s[kk][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      s[kk][0] = expf(s[kk][0] - mn0);
      s[kk][1] = expf(s[kk][1] - mn1);
      s[kk][2] = expf(s[kk][2] - mn0);
      s[kk][3] = expf(s[kk][3] - mn1);
      sum0 += s[kk][0] + s[kk][2];
      sum1 += s[kk][1] + s[kk][3];
    }
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split4(s[kk], phi[kk], plo[kk]);

    cp_async_wait<1>();               // V(t) has landed
    __syncthreads();
    // O = alpha O + P V over this warp's D/WPG columns, NG column blocks at a
    // time: each tile's product is summed apart and added in fp32
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NG) {
      float tp[NG][4];
#pragma unroll
      for (int i = 0; i < NG; ++i)
        tp[i][0] = tp[i][1] = tp[i][2] = tp[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vr = Vs + (8 * kk + t4) * L::LV + part * HD + g;
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const float bv[2] = {vr[8 * (n0 + i)], vr[4 * L::LV + 8 * (n0 + i)]};
          mma_3xtf32(tp[i], phi[kk], plo[kk], bv);
        }
      }
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        float* a = acc[n0 + i];
        a[0] = fmaf(a[0], al0, tp[i][0]);
        a[1] = fmaf(a[1], al0, tp[i][1]);
        a[2] = fmaf(a[2], al1, tp[i][2]);
        a[3] = fmaf(a[3], al1, tp[i][3]);
      }
    }
    __syncthreads();                  // V(t) and the S parts are free
    if (t + 1 < ntiles)
      stage_f32<D>(Vs, vb + (long)(key0 + kFK) * rs, kFK,
                   min(kFK, Sk - key0 - kFK), rs, L::LV);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // epilogue: the row sums are spread over the 4 lanes of a row group
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  const bool ok0 = q0 + r0 < Sq, ok1 = q0 + r1 < Sq;
  float* o0 = o + ((long)b * Sq + q0 + r0) * rs + (long)h * D + part * HD;
  float* o1 = o + ((long)b * Sq + q0 + r1) * rs + (long)h * D + part * HD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t4;
    if (ok0)
      *reinterpret_cast<float2*>(o0 + c) =
          make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (ok1)
      *reinterpret_cast<float2*>(o1 + c) =
          make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (m_out != nullptr && part == 0 && t4 == 0) {
    if (ok0) {
      m_out[(long)bh * Sq + q0 + r0] = m0;
      l_out[(long)bh * Sq + q0 + r0] = l0;
    }
    if (ok1) {
      m_out[(long)bh * Sq + q0 + r1] = m1;
      l_out[(long)bh * Sq + q0 + r1] = l1;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* kv_lens, void* o, float* m, float* l,
                        int B, int Sq, int Sk, int H, float scale,
                        cudaStream_t stream) {
  // 4D maps (D, H, S, B): the ragged end of a batch row is zero-filled
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)(Sk > 0 ? Sk : 1),
                          (uint64_t)B};
  const uint64_t sq[3] = {D * e, H * D * e, (uint64_t)Sq * H * D * e};
  const uint64_t sk[3] = {D * e, H * D * e, (uint64_t)Sk * H * D * e};
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map(&tq, q, 4, dq, sq, 2);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, 4, dk, sk, 2);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, 4, dk, sk, 2);
  if (err != cudaSuccess) return err;
  sm90::Params p{};
  p.kv_lens = kv_lens;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m = m;
  p.l = l;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.scale = scale;
  const long blocks = (long)((Sq + sm90::kRows - 1) / sm90::kRows) * B * H;
  if (blocks < 1 || blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  return sm90::launch<D, sm90::DenseTiles>(tq, tk, tv, p,
                                           dim3((unsigned)blocks), stream);
}

// The long-row loop's layout is the one the host's plan reports for route
// 0 (attention_bf16_plan.cuh::long_plan).
static_assert(sm90::Layout<64>::bytes == sm90short::long_bytes(64) &&
                  sm90::Layout<128>::bytes == sm90short::long_bytes(128) &&
                  sm90::kStages == sm90short::kStages,
              "route 0's layout and long_plan disagree");

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* kv_lens, void* o, float* m, float* l,
                       int B, int Sq, int Sk, int H, float scale,
                       cudaStream_t stream) {
  const size_t bytes = F32Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  constexpr int QB = F32Tile<D>::QB;
  const long blocks = (long)((Sq + QB - 1) / QB) * B * H;
  if (blocks < 1 || blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  fa_f32_tf32_kernel<D><<<(unsigned)blocks, kFThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_lens, static_cast<float*>(o), m, l,
      Sq, Sk, H, scale);
  return cudaGetLastError();
}

// The mma.sync kernel's plan: query rows a block, keys a tile, stages (one
// K and one V tile, each loaded while the other is in use), threads,
// dynamic shared-memory bytes.
template <int D>
void plan_mma_sync(int* out) {
  out[0] = F32Tile<D>::QB;
  out[1] = kFK;
  out[2] = 1;
  out[3] = kFThreads;
  out[4] = (int)F32Smem<D>::bytes;
}

// The compiled plan of fp32 head dim D, variant V into out[5] (query rows a
// block, keys a tile, ring stages, threads, dynamic shared-memory bytes):
// the wgmma kernel at d 64 (variants 0, long rows, and 1, short rows), 80
// and 128 (variant 0), the mma.sync kernel at d 384 and 512 (variant 0).
// False when there is no such instantiation.
bool f32_plan(int D, int V, int* out) {
  if (V == 1 && D == 64) {
    sm90f32::plan_of<64, 1>(out);
    return true;
  }
  if (V != 0) return false;
  switch (D) {
    case 64: sm90f32::plan_of<64, 0>(out); return true;
    case 80: sm90f32::plan_of<80, 0>(out); return true;
    case 128: sm90f32::plan_of<128, 0>(out); return true;
    case 384: plan_mma_sync<384>(out); return true;
    case 512: plan_mma_sync<512>(out); return true;
  }
  return false;
}

}  // namespace

extern "C" {

// bf16 flash attention on the host's route and walk (route 0: the
// long-row loop at head dim 64 or 128, walk 0, `grid` one block per
// 128-query tile and head; 1: the short-key kernel at head dim 128 on
// `grid` persistent blocks, 1 to that many, walk 0 or 1; ops/
// flash_attention.py::_bf16_plan). The layout follows from the route and Sk
// (attention_bf16_plan.cuh). Refused before anything runs:
// cudaErrorInvalidValue for a route and head dim with no instantiation,
// cudaErrorInvalidConfiguration for another walk or grid. kv_lens may be
// null: every batch row then has Sk keys; m / l may be null (no
// return_lse). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a tensor the TMA descriptors refuse.
int wf_flash_attention(const void* q, const void* k, const void* v,
                       const void* kv_lens, void* o, void* m, void* l, int B,
                       int Sq, int Sk, int H, int D, float scale, int route,
                       int walk, int grid, void* stream) {
  const int* kl = static_cast<const int*>(kv_lens);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    sm90short::Plan pl;
    if (D != sm90short::kD || !sm90short::make_plan(Sk, &pl))
      return (int)cudaErrorInvalidValue;
    return sm90short::launch(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, pl,
                             walk, grid, s);
  }
  if (route != 0 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  if (walk != 0 || grid != (long)((Sq + 127) / 128) * B * H)
    return (int)cudaErrorInvalidConfiguration;
  if (D == 64) return launch_bf16<64>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
  return launch_bf16<128>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
}

// fp32 flash attention laid out by the host's plan (variant V, rows,
// key_tile, stages, threads, smem_bytes: ops/flash_attention.py::_fwd_plan),
// run by the instantiation of head dim D and variant V, which must have been
// compiled for exactly that plan. Refused before anything runs:
// cudaErrorInvalidValue for a head dim and variant with no instantiation,
// cudaErrorInvalidConfiguration for another plan. kv_lens may be null:
// every batch row then has Sk keys.
int wf_flash_attention_f32(const void* q, const void* k, const void* v,
                           const void* kv_lens, void* o, void* m, void* l,
                           int B, int Sq, int Sk, int H, int D, float scale,
                           int V, int rows, int key_tile, int stages,
                           int threads, int smem_bytes, void* stream) {
  int own[5];
  if (!f32_plan(D, V, own)) return (int)cudaErrorInvalidValue;
  const int plan[5] = {rows, key_tile, stages, threads, smem_bytes};
  if (!std::equal(own, own + 5, plan))
    return (int)cudaErrorInvalidConfiguration;
  const int* kl = static_cast<const int*>(kv_lens);
  float* op = static_cast<float*>(o);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using sm90f32::launch;
  switch (D) {
    case 64:
      return V ? launch<64, 1>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s)
               : launch<64, 0>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s);
    case 80:
      return launch<80, 0>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s);
    case 128:
      return launch<128, 0>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s);
    case 384:
      return launch_f32<384>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
  }
  return launch_f32<512>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
}

const char* wf_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
