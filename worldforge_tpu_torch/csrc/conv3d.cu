// Causal 3x3x3 stride-1 convolution for Hopper (sm_90a), as an implicit GEMM
// on TMA and wgmma.
//
// Replaces the Pallas TPU kernel worldforge_tpu/ops/conv3d.py::_conv_kernel
// (pallas_call at :119, through conv3d_causal_pallas :77). Same contract:
//   x [B, T+2, H, W, Cin] already front-padded in time by the caller, fp32 or
//   bf16; SAME spatial padding; w [3, 3, 3, Cin, Cout]; bias [Cout] fp32 or
//   none; y [B, T, H, W, Cout] fp32 or bf16. Inputs and weights are rounded
//   to bf16, products accumulate in fp32 over the 27 taps x Cin, then the
//   fp32 bias is added and the sum is cast to the output type.
// The same kernel with one temporal tap (KT = 1, w [1, 3, 3, Cin, Cout], y
// [B, T, ...] from x [B, T, ...]) is the stride-1 3x3 SAME 2-D convolution
// of every frame: the VAE decoder's resample convs after the nearest x2
// upsample, which the JAX package leaves to XLA (bf16 operands and fp32
// sums on its chip) and which cuDNN ran in fp32 here with a 37 GB
// workspace at 480p.
// The wrapper (ops/conv3d.py) hands over x as it is and the weight once per
// weight tensor as bf16 [9 KT, CinP, CoutP] (CinP, CoutP: multiples of 16,
// zero-padded); its conv_plan() picks the tile plan passed in here.
//
// What bounds it on the H100: operations. The full-resolution 96 -> 96
// decoder conv at 480x832 and 17 frames is 2*27*96*96*H*W*T = 3.4 TFLOP
// against ~5.5 GB of fp32 input and output. An implicit GEMM with M output
// pixels per block stages each weight byte from L2 into shared memory for
// every M FLOP, so the block tile sets the L2 traffic:
//   * A block computes 256 output pixels, an 8-row x 32-pixel tile of one
//     output frame, for an N-wide slice of Cout. N is the whole of CoutP up
//     to 128 (96, 32 and 16 whole), else the widest of 128, 96, 32, 16 that
//     divides it (192 as two slices of 96, 384 as three of 128): the
//     accumulator of two 64-row wgmma tiles is N fp32 registers a thread,
//     and at N = 192 that leaves no room for the operands under setmaxnreg.
//     8 x 32 rather than 16 x 16: the widths of the VAE (832, 416, 1280,
//     640, 160) are multiples of 32 and its heights of 8, and one warp's
//     A operand is 16 pixels of one row.
//   * 384 threads: a producer warpgroup and two consumer warpgroups, which
//     trade registers with setmaxnreg (72 / 216). Consumer warpgroup c, warp
//     w owns output row 4c + w; its two wgmma M tiles are that row's pixels
//     0-15 and 16-31.
//   * The K loop walks (CK-channel chunk of Cin) x (temporal tap kt < KT),
//     CK 32 where CinP and shared memory allow it, else 16. Each stage of a ring
//     of 2 to 4 holds the 9 spatial taps of the weight, [9, CK, N] bf16, and
//     the halo'd bf16 input slab [10, 34, CK] of frame t + kt, guarded by a
//     full mbarrier and an empty one (one arrival per consumer warp). One
//     producer thread brings the weights with TMA, one box [9, CK, 64, 32
//     or 16 columns] per column panel, in the 128-, 64- or 32-byte swizzle
//     that wgmma's MN-major B descriptor reads. x comes through a 4D tensor
//     map over (C, W, H, T * B) whose box starts at (x0 - 1, y0 - 1), so TMA
//     zero-fills the halo outside the image and the channels past Cin:
//       - bf16 x lands in the slab itself, in TMA's swizzle;
//       - fp32 x (what the VAE passes) lands in an fp32 staging buffer (two
//         where shared memory allows, so the next copy is in flight), and
//         the producer warpgroup's 128 threads round it to bf16 into the
//         slab, the Pallas contract's cast of x done in shared memory
//         instead of as a pass over x before the launch (rounding in the
//         consumers instead, from an fp32 slab, was slower: it doubles
//         their fragment reads from shared memory);
//       - where TMA cannot read x (a row of Cin elements that is no
//         multiple of 16 bytes, as at Cin = 3), the 128 threads stage the
//         slab with plain loads.
//   * The A operand of spatial tap (kh, kw) is the slab shifted by (kh, kw),
//     which no shared-memory descriptor can address (its rows are not
//     8-row aligned), so each warp loads it with ldmatrix (the slab's
//     16-byte chunks XOR-swizzled by pixel, so the 8 rows of each 8x8
//     matrix hit distinct banks) and issues register-A wgmma m64nNk16; the
//     fragments are double-buffered, one wgmma group in flight while the
//     next loads. Every input element of a slab feeds 9 taps x N columns.
//   * Epilogue: the bias is added in registers, the tile is staged through
//     shared memory (reusing the ring) and stored with 16-byte stores where
//     Cout allows it, masking the ragged H, W and Cout edges.
//   * Blocks are ordered slice-fastest, then frame, then spatial tile, so
//     the blocks in flight share each input frame (3 temporal taps) and
//     each weight slice in L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kTileH = 8;                    // output rows per block
constexpr int kTileW = 32;                   // output pixels per row
constexpr int kSlabH = kTileH + 2, kSlabW = kTileW + 2;
constexpr int kSlabPix = kSlabH * kSlabW;    // 340
constexpr int kThreads = 384;
constexpr int kProducerRegs = 72, kConsumerRegs = 216;
constexpr int kSmemLimit = 232448;           // 227 KB a block may use

// How x reaches the slab.
enum Src : int { kTmaBf16 = 0, kTmaF32 = 1, kManual = 2 };

constexpr uint32_t round1024(uint32_t b) { return (b + 1023u) & ~1023u; }

// Shared-memory plan of one (N, CK, stages, staging buffers);
// ops/conv3d.py::conv_plan computes the same numbers. Layout: the ring of
// stages [weights | bf16 slab], then the fp32 staging buffers, then the
// mbarriers; the epilogue's tile reuses the front.
template <int N, int CK>
struct Plan {
  static constexpr int kSwBytes = N % 64 == 0 ? 128 : (N % 32 == 0 ? 64 : 32);
  static constexpr int kPanelCols = kSwBytes / 2;          // columns / panel
  static constexpr int kPanels = N / kPanelCols;
  static constexpr uint32_t kSwizzle =                     // descriptor code
      kSwBytes == 128 ? 1u : (kSwBytes == 64 ? 2u : 3u);
  static constexpr uint32_t kPanelBytes = 9u * CK * kSwBytes;
  static constexpr uint32_t kWBytes = 9u * CK * N * 2u;    // TMA bytes/stage
  static constexpr int kPixBytes = CK * 2;                 // bf16 slab row
  static constexpr uint32_t kSlabBox = kSlabPix * kPixBytes;
  static constexpr uint32_t kSlabOff = round1024(kWBytes);
  static constexpr uint32_t kStage = kSlabOff + round1024(kSlabBox);
  static constexpr uint32_t kStgBox = kSlabPix * CK * 4u;  // fp32 staging
  static constexpr uint32_t kStg = round1024(kStgBox);
  static constexpr int kLdOut = N + 8;                     // epilogue row
  static constexpr uint32_t kEpilogue = 4u * kTileH * kTileW * kLdOut;
  __host__ __device__ static constexpr uint32_t region(int stages, int nstg) {
    return kStage * stages + kStg * nstg > kEpilogue
               ? kStage * stages + kStg * nstg : kEpilogue;
  }
  __host__ __device__ static constexpr uint32_t bytes(int stages, int nstg) {
    return 1024u + region(stages, nstg) + 8u * (2 * stages + nstg);
  }
};

struct Args {
  const void* x;          // [B, Tp, H, W, Cin] fp32 or bf16
  const float* bias;      // [Cout] or null
  void* y;                // [B, Tp - KT + 1, H, W, Cout] fp32 or bf16
  int B, Tp, KT, H, W, Cin, Cout, CinP;
  int stages, nstg, nslices, tiles_w;
  int src;                // Src
  int in_bf16, out_bf16;  // element types of x and y
  int y_vec;              // 16-byte stores of y allowed
};

// Byte offset of 16-byte chunk q of slab pixel `pix`, rows of ROWB bytes in
// TMA's swizzle of that width (the chunk index XORed with address bits 7..),
// so that 8 consecutive pixels cover all 8 bank groups.
template <int ROWB>
__device__ __forceinline__ uint32_t slab_off(int pix, int q) {
  const int sw = ROWB == 64 ? ((pix >> 1) & 3) : ((pix >> 2) & 1);
  return (uint32_t)(pix * ROWB + ((q ^ sw) << 4));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Eight channels [c, c + 8) of one input pixel as fp32 (zeros past Cin),
// one element at a time: the producer's threads read x only where TMA
// cannot (rows that are no multiple of 16 bytes, or an unaligned x), so
// no 16-byte load is aligned.
__device__ __forceinline__ void load8(const Args& a, long pixel, int c,
                                      float (&v)[8]) {
  if (a.in_bf16) {
    const __nv_bfloat16* p =
        static_cast<const __nv_bfloat16*>(a.x) + pixel * a.Cin + c;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = c + i < a.Cin ? __bfloat162float(p[i]) : 0.f;
  } else {
    const float* p = static_cast<const float*>(a.x) + pixel * a.Cin + c;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = c + i < a.Cin ? __ldg(p + i) : 0.f;
  }
}

// The producer's 128 threads stage the bf16 slab of frame `frame` (in units
// of H rows), channels [c0, c0 + CK), from x with plain loads.
template <int CK>
__device__ __forceinline__ void stage_manual(const Args& a, unsigned char* slab,
                                             long frame, int c0, int x0,
                                             int y0, int tid) {
  constexpr int R8 = CK / 8;                   // 8-channel groups per pixel
  constexpr int kItems = kSlabPix * R8;
  constexpr int kU = 4;                        // items in flight a thread
  for (int i0 = tid; i0 < kItems; i0 += 128 * kU) {
    float v[kU][8];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * 128;
      const int pix = i / R8, q = i % R8;
      const int gy = y0 - 1 + pix / kSlabW, gx = x0 - 1 + pix % kSlabW;
      const int c = c0 + 8 * q;
      if (i < kItems && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W &&
          c < a.Cin) {
        load8(a, (frame + gy) * a.W + gx, c, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * 128;
      if (i < kItems)
        *reinterpret_cast<uint4*>(slab + slab_off<CK * 2>(i / R8, i % R8)) =
            pack8(v[u]);
    }
  }
}

// The producer's 128 threads round an fp32 staging buffer [340, CK] (TMA's
// copy, unswizzled) to bf16 into the slab.
template <int CK>
__device__ __forceinline__ void stage_convert(const unsigned char* stg,
                                              unsigned char* slab, int tid) {
  constexpr int R8 = CK / 8;
  for (int i = tid; i < kSlabPix * R8; i += 128) {
    const float4* p = reinterpret_cast<const float4*>(stg + i * 32);
    const float4 lo = p[0], hi = p[1];
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    *reinterpret_cast<uint4*>(slab + slab_off<CK * 2>(i / R8, i % R8)) =
        pack8(v);
  }
}

// Stores the epilogue's fp32 tile [256 pixels][N (+8)] as rows of NV
// 16-byte vectors (NV * VEC = N columns, all inside Cout).
template <int N, int NV, bool BF16>
__device__ __forceinline__ void store_tile_vec(const Args& a, const float* eo,
                                               long out0, int x0, int y0,
                                               int n0, int ctid) {
  constexpr int kVec = N / NV;
  for (int i = ctid; i < kTileH * kTileW * NV; i += 256) {
    const int p = i / NV, c = (i % NV) * kVec;
    const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
    if (gy >= a.H || gx >= a.W) continue;
    const float* src = eo + p * (N + 8) + c;
    const long dst = ((out0 + gy) * a.W + gx) * a.Cout + n0 + c;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    if constexpr (BF16) {
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.y) + dst) =
          pack8(v);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.y) + dst) = lo;
    }
  }
}

template <int N, int CK>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx, const Args a) {
  using P = Plan<N, CK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t stg0 = base + a.stages * P::kStage;   // fp32 staging
  const uint32_t full0 = base + P::region(a.stages, a.nstg);
  const uint32_t empty0 = full0 + 8 * a.stages;
  const uint32_t xfull0 = empty0 + 8 * a.stages;      // staging filled

  // block -> (N slice, frame bt = b * T + t, spatial tile)
  const int T = a.Tp - a.KT + 1;
  int idx = blockIdx.x;
  const int slice = idx % a.nslices;
  idx /= a.nslices;
  const int bt = idx % (a.B * T);
  const int tile = idx / (a.B * T);
  const int x0 = (tile % a.tiles_w) * kTileW;
  const int y0 = (tile / a.tiles_w) * kTileH;
  const int b = bt / T, t = bt % T;
  const int n0 = slice * N;
  const int nk = a.KT * (a.CinP / CK);         // stages of the K loop
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      // the TMA bytes, and the 128 producer threads where they write the slab
      mbar_init(full0 + 8 * s, a.src == kTmaBf16 ? 1 : 129);
      mbar_init(empty0 + 8 * s, 8);            // one arrival per consumer warp
    }
    for (int i = 0; i < a.nstg; ++i) mbar_init(xfull0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    if (a.src == kTmaBf16 && tid != 0) return;
    // x coordinates of K step k: channel c0, frame b * Tp + t + kt
    auto load_x = [&](int k, uint32_t dst, uint32_t bar) {
      tma_load_4d(dst, &tx, bar, (k / a.KT) * CK, x0 - 1, y0 - 1,
                  b * a.Tp + t + k % a.KT);
    };
    if (a.src == kTmaF32 && tid == 0) {
      for (int k = 0; k < a.nstg && k < nk; ++k) {
        mbar_expect_tx(xfull0 + 8 * k, P::kStgBox);
        load_x(k, stg0 + k * P::kStg, xfull0 + 8 * k);
      }
    }
    for (int k = 0; k < nk; ++k) {
      const int s = k % a.stages;
      mbar_wait(empty0 + 8 * s, ((k / a.stages) & 1) ^ 1);
      const uint32_t stage = base + s * P::kStage;
      const uint32_t bar = full0 + 8 * s;
      if (tid == 0) {
        mbar_expect_tx(bar, P::kWBytes +
                                (a.src == kTmaBf16 ? P::kSlabBox : 0u));
#pragma unroll
        for (int m = 0; m < P::kPanels; ++m)
          tma_load_3d(stage + m * P::kPanelBytes, &tw, bar,
                      n0 + m * P::kPanelCols, (k / a.KT) * CK,
                      9 * (k % a.KT));
        if (a.src == kTmaBf16) load_x(k, stage + P::kSlabOff, bar);
      }
      if (a.src == kTmaBf16) continue;
      unsigned char* slab = gbase + (stage - base) + P::kSlabOff;
      if (a.src == kTmaF32) {
        const int sb = k % a.nstg;
        mbar_wait(xfull0 + 8 * sb, (k / a.nstg) & 1);
        stage_convert<CK>(gbase + (stg0 - base) + sb * P::kStg, slab, tid);
        mbar_arrive(bar);     // release: this thread's slab writes
        named_barrier(2, 128);                 // staging buffer sb is read
        if (tid == 0 && k + a.nstg < nk) {
          mbar_expect_tx(xfull0 + 8 * sb, P::kStgBox);
          load_x(k + a.nstg, stg0 + sb * P::kStg, xfull0 + 8 * sb);
        }
      } else {
        stage_manual<CK>(a, slab, (long)(b * a.Tp + t + k % a.KT) * a.H,
                         (k / a.KT) * CK, x0, y0, tid);
        mbar_arrive(bar);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int ctid = threadIdx.x - 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = 4 * cw + warp;             // output row of this warp
    float acc[2][N / 2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
    uint32_t frag[2][2][4];                    // [buffer][M tile][regs]
#pragma unroll
    for (int bb = 0; bb < 2; ++bb)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) frag[bb][mt][r] = 0u;
    // ldmatrix rows: lanes 0-15 give pixels 0-15 of chunk 2j, lanes 16-31
    // the same pixels of chunk 2j + 1 (the A layout of m16n8k16)
    const int lpix = row * kSlabW + (lane & 15);
    const int lhalf = lane >> 4;

    for (int k = 0; k < nk; ++k) {
      const int s = k % a.stages;
      mbar_wait(full0 + 8 * s, (k / a.stages) & 1);
      const uint32_t wst = base + s * P::kStage;
      const uint32_t slab = wst + P::kSlabOff;
#pragma unroll
      for (int j = 0; j < CK / 16; ++j) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int bb = (j * 9 + tap) & 1;    // wgmma group parity
          const int kh = tap / 3, kw = tap % 3;
          wgmma_wait<1>();                     // group g - 2 has retired
          pin(frag[bb][0]);
          pin(frag[bb][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int pix = lpix + kh * kSlabW + 16 * mt + kw;
            ldmatrix_x4(frag[bb][mt],
                        slab + slab_off<P::kPixBytes>(pix, 2 * j + lhalf));
          }
          const uint64_t db = smem_desc(
              wst + (tap * CK + 16 * j) * P::kSwBytes, P::kPanelBytes,
              8 * P::kSwBytes, P::kSwizzle);
          wgmma_fence();
          wgmma_rs<N>(acc[0], frag[bb][0], db);
          wgmma_rs<N>(acc[1], frag[bb][1], db);
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
      pin(acc[0]);
      pin(acc[1]);
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        pin(frag[bb][0]);
        pin(frag[bb][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // ------------------------------------------------------ epilogue
    // acc[mt] regs 4jj + e: pixel 16mt + lane/4 (+8 for e >= 2) of this
    // warp's row, column 8jj + 2 (lane % 4) + (e & 1)
    named_barrier(1, 256);                     // the ring is free
    float* eo = reinterpret_cast<float*>(gbase);
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj) {
      const int col = 8 * jj + 2 * t4;
      const int co = n0 + col;
      const float b0 = a.bias != nullptr && co < a.Cout ? a.bias[co] : 0.f;
      const float b1 = a.bias != nullptr && co + 1 < a.Cout ? a.bias[co + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = row * kTileW + 16 * mt + g8;
        *reinterpret_cast<float2*>(eo + p * P::kLdOut + col) =
            make_float2(acc[mt][4 * jj] + b0, acc[mt][4 * jj + 1] + b1);
        *reinterpret_cast<float2*>(eo + (p + 8) * P::kLdOut + col) =
            make_float2(acc[mt][4 * jj + 2] + b0, acc[mt][4 * jj + 3] + b1);
      }
    }
    named_barrier(1, 256);
    const int ncols = min(N, a.Cout - n0);
    const long out0 = (long)bt * a.H;
    if (a.y_vec && ncols == N) {
      if (a.out_bf16)
        store_tile_vec<N, N / 8, true>(a, eo, out0, x0, y0, n0, ctid);
      else
        store_tile_vec<N, N / 4, false>(a, eo, out0, x0, y0, n0, ctid);
    } else {
      for (int i = ctid; i < kTileH * kTileW * ncols; i += 256) {
        const int p = i / ncols, c = i % ncols;
        const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
        if (gy >= a.H || gx >= a.W) continue;
        const float v = eo[p * P::kLdOut + c];
        const long dst = ((out0 + gy) * a.W + gx) * a.Cout + n0 + c;
        if (a.out_bf16)
          static_cast<__nv_bfloat16*>(a.y)[dst] = __float2bfloat16(v);
        else
          static_cast<float*>(a.y)[dst] = v;
      }
    }
  }
}

template <int N, int CK>
cudaError_t launch(const void* w, const Args& a, int CoutP, int smem_bytes,
                   cudaStream_t stream) {
  using P = Plan<N, CK>;
  if (a.stages < 2 || (a.src == kTmaF32) != (a.nstg > 0) || a.nstg > 2 ||
      (int)P::bytes(a.stages, a.nstg) != smem_bytes ||
      smem_bytes > kSmemLimit)
    return cudaErrorInvalidValue;
  // the prepared weight [9 KT, CinP, CoutP] bf16, read in boxes of one
  // column panel x CK channels x 9 spatial taps
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t dims[3] = {(uint64_t)CoutP, (uint64_t)a.CinP,
                            (uint64_t)(9 * a.KT)};
  const uint64_t strides[2] = {CoutP * e, (uint64_t)a.CinP * CoutP * e};
  const uint32_t box[3] = {(uint32_t)P::kPanelCols, (uint32_t)CK, 9};
  CUtensorMap tw, tx;
  cudaError_t err = make_map(&tw, w, 3, dims, strides, box, P::kSwBytes);
  if (err != cudaSuccess) return err;
  tx = tw;                                     // unused when staged by hand
  if (a.src != kManual) {
    // x as (C, W, H, T * B): the slab of one frame and chunk is one box,
    // bf16 in the slab's swizzle, fp32 unswizzled into the staging buffer
    const uint64_t xe = a.in_bf16 ? 2 : 4;
    const uint64_t xdims[4] = {(uint64_t)a.Cin, (uint64_t)a.W,
                               (uint64_t)a.H, (uint64_t)a.B * a.Tp};
    const uint64_t xstr[3] = {a.Cin * xe, (uint64_t)a.W * a.Cin * xe,
                              (uint64_t)a.H * a.W * a.Cin * xe};
    const uint32_t xbox[4] = {(uint32_t)CK, (uint32_t)kSlabW,
                              (uint32_t)kSlabH, 1};
    err = a.src == kTmaBf16
              ? make_map(&tx, a.x, 4, xdims, xstr, xbox, P::kPixBytes)
              : make_map(&tx, a.x, 4, xdims, xstr, xbox, 0,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(conv3d_kernel<N, CK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return err;
  const int T = a.Tp - a.KT + 1;
  const long blocks = (long)a.nslices * a.B * T * a.tiles_w *
                      ((a.H + kTileH - 1) / kTileH);
  conv3d_kernel<N, CK><<<(unsigned)blocks, kThreads, smem_bytes, stream>>>(
      tw, tx, a);
  return cudaGetLastError();
}

template <int CK>
cudaError_t launch_n(int N, const void* w, const Args& a, int CoutP,
                     int smem_bytes, cudaStream_t s) {
  switch (N) {
    case 16: return launch<16, CK>(w, a, CoutP, smem_bytes, s);
    case 32: return launch<32, CK>(w, a, CoutP, smem_bytes, s);
    case 96: return launch<96, CK>(w, a, CoutP, smem_bytes, s);
    case 128: return launch<128, CK>(w, a, CoutP, smem_bytes, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: [B, Tp, H, W, Cin] of in_dtype; w: bf16 [9 taps, CinP, CoutP] (16-byte
// aligned); bias fp32 [Cout] or null; y [B, Tp - taps + 1, H, W, Cout] of
// out_dtype (dtypes: 0 = float32, 1 = bfloat16); taps: the temporal taps,
// 3 (the causal 3x3x3 conv) or 1 (a 3x3 conv of every frame). The plan
// comes from ops/conv3d.py::conv_plan: N (16, 32, 96 or 128, dividing
// CoutP), CK (16 or 32, dividing CinP), stages, manual (stage x with the
// producer's threads instead of TMA, which needs rows of Cin elements that
// are a multiple of 16 bytes and a 16-byte aligned x), staging (fp32 staging
// buffers: 1 or 2 for fp32 x read by TMA, else 0) and smem_bytes, which
// must equal this file's own count. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments outside that.
int wf_conv3d_causal(const void* x, const void* w, const void* bias, void* y,
                     int B, int Tp, int taps, int H, int W, int Cin, int CinP,
                     int Cout, int CoutP, int N, int CK, int stages, int manual,
                     int staging, int smem_bytes, int in_dtype, int out_dtype,
                     void* stream) {
  const int xe = in_dtype ? 2 : 4;
  const bool tma_ok = (Cin * xe) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if ((taps != 1 && taps != 3) || Tp < taps || B < 1 || H < 1 || W < 1 ||
      Cin < 1 || Cin > CinP || Cout < 1 || Cout > CoutP || CinP % CK != 0 ||
      N <= 0 ||
      CoutP % N != 0 || (in_dtype != 0 && in_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) || (!manual && !tma_ok) ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.B = B;
  a.Tp = Tp;
  a.KT = taps;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.CinP = CinP;
  a.stages = stages;
  a.nstg = staging;
  a.nslices = CoutP / N;
  a.tiles_w = (W + kTileW - 1) / kTileW;
  a.src = manual ? kManual : (in_dtype ? kTmaBf16 : kTmaF32);
  a.in_bf16 = in_dtype;
  a.out_bf16 = out_dtype;
  a.y_vec = Cout % (out_dtype ? 8 : 4) == 0 &&
            reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CK == 16) return (int)launch_n<16>(N, w, a, CoutP, smem_bytes, s);
  if (CK == 32) return (int)launch_n<32>(N, w, a, CoutP, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

const char* wf_conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
