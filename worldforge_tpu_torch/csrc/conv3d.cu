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
// upsample and every 3x3 conv of the SVD UNet and VAE, which the JAX
// package leaves to XLA (bf16 operands and fp32 sums on its chip).
// The wrapper (ops/conv3d.py) hands over x as it is and the weight once per
// weight tensor in the route's bf16 layout; the launch plan (route, box,
// slice width, channel chunk, ring, grid) is conv3d_plan.cuh's, which the
// host reads through csrc/conv_plan.cpp and this file computes again.
//
// What bounds it on the H100. The 96 -> 96 decoder conv at 480x832 and 17
// frames is 2*27*96*96*H*W*T = 3.4 TFLOP against ~5.5 GB of fp32 input and
// output: operations. An implicit GEMM with M output pixels a block stages
// each weight byte from L2 for every M FLOP and each input byte once per
// N-wide slice, so the block's box, N and the route set the L2 traffic; the
// narrow convs are bound by bytes (conv_in by its 2.6 GB of output, conv_out
// by its 2.9 GB of input) and the SVD UNet's lowest levels by the weight
// stream of too few, long blocks. Three routes (conv3d_plan.cuh):
//
// kTile, the implicit GEMM. A block computes 256 output pixels, a box of F
// frames x R rows x BW columns (M maps to the box's pixels in order; rows
// past F*R*BW are padding), for an N-wide slice of Cout (160 / 128 / 96 /
// 32 / 16). Widths that are multiples of 32, and short K loops (N 16, CinP
// x taps < 128) at W >= 32, keep the 8 x 32 box, a kernel instantiation of
// its own with compile-time geometry; any other takes the box that loads
// the fewest bytes over the launch: at the SVD UNet's 8 x 13 level two
// whole frames (81% of rows real where 8 x 32 had 41%, one wave of 120
// blocks where it had 1.82), at its 64 x 104 level 32 x 8 (100% where
// 8 x 32 had 81%). ldmatrix takes one row address a lane, so an A
// fragment's 16 rows are any 16 pixels: each lane keeps its pixels' slab
// offsets.
//   * 384 threads: a producer warpgroup and two consumer warpgroups, which
//     trade registers with setmaxnreg (72 / 216). Consumer warp w of
//     warpgroup c owns M rows 32 (4c + w) .. + 31, two 16-row fragments of
//     the two m64 wgmma tiles; the accumulator is N fp32 registers a thread.
//   * The K loop walks (CK-channel chunk of Cin) x (temporal tap kt < KT),
//     CK 32 where CinP and shared memory allow it (at three taps for the
//     route's largest slab, as the chunk orders the sums), else 16. Each
//     stage of a ring of 2 to 4 holds the 9 spatial taps of the weight,
//     [9, CK, N] bf16, and the halo'd bf16 input slab [F, R + 2, BW + 2, CK]
//     of frames t + kt, guarded by a full mbarrier and an empty one (one
//     arrival per consumer warp). One producer thread brings the weights
//     with TMA, one box [9, CK, 64, 32 or 16 columns] per column panel, in
//     the 128-, 64- or 32-byte swizzle that wgmma's MN-major B descriptor
//     reads. x comes through a 4D tensor map over (C, W, H, T * B) whose box
//     starts at (x0 - 1, y0 - 1), so TMA zero-fills the halo outside the
//     image and the channels past Cin: bf16 x lands in the slab in TMA's
//     swizzle; fp32 x lands in one or two fp32 staging buffers, and the
//     producer's 128 threads round it to bf16 into the slab; where TMA
//     cannot read x (rows of Cin elements no multiple of 16 bytes) the 128
//     threads stage it with plain loads.
//   * The A operand of spatial tap (kh, kw) is the slab shifted by (kh, kw),
//     which no shared-memory descriptor can address, so each warp loads it
//     with ldmatrix (16-byte chunks XOR-swizzled by pixel) and issues
//     register-A wgmma m64nNk16, fragments double-buffered, one wgmma group
//     in flight while the next loads.
//   * Epilogue: the bias is added in registers, the tile is staged through
//     shared memory (reusing the ring) and stored with 16-byte stores where
//     Cout allows it, masking the ragged T, H, W and Cout edges.
//   * Blocks are ordered slice-fastest, then frames, then spatial box, so
//     the blocks in flight share each input frame and weight slice in L2.
//
// kWalk, Cout <= 8 at three temporal taps (the Wan VAE's conv_out 96 -> 3).
// The tile route stages every input frame three times (once for each
// output frame that reads it) and converts fp32 x as often; here a block
// takes one spatial box over a run of output frames, keeps the whole
// weight [27, CinP, 16] resident (one TMA wait), and walks the input frames
// t0 .. t0 + run + 1, each chunk of each frame staged and converted once.
// Every A fragment feeds three wgmma m64n16k16, one for each temporal tap,
// into three accumulators (output frames i, i - 1, i - 2); after the last
// chunk of input frame i the third is complete, is stored from registers
// and the three rotate. Each output's sum still runs kt 0, 1, 2 in order.
//
// kFold, Cin <= 8 at three temporal taps (the Wan VAE's conv_in 3 -> 96),
// and at one tap Cin <= 4 into one slice of Cout (the SVD VAE's conv_in
// 3 -> 128). Padding Cin to a k16 step made 27 steps (9 at one tap) of 16
// rows of which 3 were real. Here a slab keeps 8 channels a pixel (16
// bytes), and a k16 step takes two taps: lanes 0-15 address tap 2s, lanes
// 16-31 tap 2s + 1 (the last step's second tap has zero weights), so 27
// taps are 14 steps (9 are 5) against the weight [28 or 10, 8, CoutP]
// resident in shared memory. A block walks a run of output frames over
// one spatial box through a ring of 4 to 8 input-frame slabs: the
// producer stages each input frame once (plain loads from offsets it
// computes once a block: x rows of 3 channels are no TMA box) while the
// consumers compute, output frame k reads slabs k .. k + KT - 1 and then
// frees slab k, and the consumers store each frame from registers straight
// to y, so the stores of one frame drain behind the next one's products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "conv3d_plan.cuh"

namespace {

using namespace sm90;
using conv4::Plan;

constexpr int kThreads = conv4::kThreads;
constexpr int kProducerRegs = 72, kConsumerRegs = 216;

struct Args {
  const void* x;          // [B, Tp, H, W, Cin] fp32 or bf16
  const float* bias;      // [Cout] or null
  void* y;                // [B, T, H, W, Cout] fp32 or bf16
  int B, Tp, T, KT, H, W, Cin, Cout;
  int in_bf16, out_bf16;  // element types of x and y
  int y_vec;              // 16-byte stores of y allowed (kTile)
  int y_pair;             // 2-element stores of y allowed (kWalk, kFold)
  Plan p;
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

// One x element (fp32 or bf16) as fp32.
__device__ __forceinline__ float load1(const Args& a, long i) {
  return a.in_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[i])
             : __ldg(static_cast<const float*>(a.x) + i);
}

// Eight channels [c, c + 8) of one input pixel as fp32 (zeros past Cin),
// one element at a time: the producer's threads read x only where TMA
// cannot (rows that are no multiple of 16 bytes, or an unaligned x).
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

// a / b for 0 <= a < 4096 and 0 < b <= 1024, as a float product with
// inv_b = 1 / b: (a + 0.5) / b lies at least 0.5 / b from any integer, well
// beyond the product's rounding there; no integer divide in the hot loops.
__device__ __forceinline__ int idiv(int a, float inv_b) {
  return __float2int_rz((a + 0.5f) * inv_b);
}

// The slab geometry of a box: pixels of a slab row (sw) and of a frame's
// slab (fp = sw * sh), with their reciprocals.
struct Geo {
  int sw, fp;
  float inv_sw, inv_fp;
};
__device__ __forceinline__ Geo slab_geo(const Plan& P) {
  const int sw = P.box_w + 2, fp = sw * (P.box_r + 2);
  return Geo{sw, fp, 1.f / sw, 1.f / fp};
}

// Input pixel (box frame, slab row, slab column) of slab pixel `pix`, the
// box's first frame starting at row `row0` of x seen as [B * Tp * H, W];
// its index in x, or -1 outside the image (the zero halo) or past the last
// frame (`rows`: B * Tp * H). The 8 x 32 box (B32: one frame, which is
// always there; rows of 34) by constants.
template <bool B32>
__device__ __forceinline__ long slab_pixel(const Args& a, int pix, long row0,
                                           long rows, int x0, int y0,
                                           const Geo& g) {
  int f, r, col;
  if (B32) {
    f = 0;
    r = pix / 34;
    col = pix % 34;
  } else {
    f = idiv(pix, g.inv_fp);
    const int rem = pix - f * g.fp;
    r = idiv(rem, g.inv_sw);
    col = rem - r * g.sw;
  }
  const int gy = y0 - 1 + r, gx = x0 - 1 + col;
  if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) return -1;
  const long row = B32 ? row0 : row0 + (long)f * a.H;
  if (!B32 && row >= rows) return -1;
  return (row + gy) * a.W + gx;
}

// The producer's 128 threads stage the bf16 slab of frames frame0 .. (the
// box's), channels [c0, c0 + CK), from x with plain loads.
template <int CK, bool B32>
__device__ __forceinline__ void stage_manual(const Args& a, unsigned char* slab,
                                             long frame0, int c0, int x0,
                                             int y0, int npix, int tid) {
  const Geo g = slab_geo(a.p);
  constexpr int R8 = CK / 8;                   // 8-channel groups per pixel
  const int items = npix * R8;
  const long row0 = frame0 * a.H, rows = (long)a.B * a.Tp * a.H;
  constexpr int kU = 4;                        // items in flight a thread
  for (int i0 = tid; i0 < items; i0 += 128 * kU) {
    float v[kU][8];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * 128;
      const int pix = i / R8, q = i % R8;
      const int c = c0 + 8 * q;
      const long px =
          i < items ? slab_pixel<B32>(a, pix, row0, rows, x0, y0, g) : -1;
      if (px >= 0 && c < a.Cin) {
        load8(a, px, c, v[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * 128;
      if (i < items)
        *reinterpret_cast<uint4*>(slab + slab_off<CK * 2>(i / R8, i % R8)) =
            pack8(v[u]);
    }
  }
}

// The producer's 128 threads round an fp32 staging buffer [npix, CK] (TMA's
// copy, unswizzled) to bf16 into the slab.
template <int CK>
__device__ __forceinline__ void stage_convert(const unsigned char* stg,
                                              unsigned char* slab, int npix,
                                              int tid) {
  constexpr int R8 = CK / 8;
  for (int i = tid; i < npix * R8; i += 128) {
    const float4* p = reinterpret_cast<const float4*>(stg + i * 32);
    const float4 lo = p[0], hi = p[1];
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    *reinterpret_cast<uint4*>(slab + slab_off<CK * 2>(i / R8, i % R8)) =
        pack8(v);
  }
}

// Box frame, row and column of M row (or epilogue pixel) p < 256; the
// 8 x 32 box (B32) by shifts.
template <bool B32>
__device__ __forceinline__ void box_pixel(const Plan& P, int p, int& f,
                                          int& r, int& c) {
  if (B32) {
    f = 0;
    r = p >> 5;
    c = p & 31;
  } else {
    const int plane = P.box_r * P.box_w;
    f = idiv(p, 1.f / plane);
    const int rem = p - f * plane;
    r = idiv(rem, 1.f / P.box_w);
    c = rem - r * P.box_w;
  }
}

// kFold: up to four slab pixels a producer thread stages (pixel tid + 128
// j of one input frame's slab), as offsets within a frame: -1 in the zero
// halo, -2 past the slab. Once a block.
constexpr int kFoldItems = 4;                  // ceil(kBoxSlab / 128)
static_assert(kFoldItems * 128 >= conv4::kBoxSlab, "a fold slab's pixels");
__device__ __forceinline__ void fold_offsets(const Args& a, int x0, int y0,
                                             int tid, int (&off)[kFoldItems]) {
  const int sw = a.p.box_w + 2, npix = a.p.slab_pix;
#pragma unroll
  for (int j = 0; j < kFoldItems; ++j) {
    const int pix = tid + 128 * j;
    const int gy = y0 - 1 + pix / sw, gx = x0 - 1 + pix % sw;
    off[j] = pix >= npix ? -2
             : gy < 0 || gy >= a.H || gx < 0 || gx >= a.W ? -1
                                                          : gy * a.W + gx;
  }
}

// kFold: the 128 threads stage input frame `frame` into one slab, 8
// channels a pixel (16 bytes, zeros past Cin).
__device__ __forceinline__ void stage_fold(const Args& a, unsigned char* slab,
                                           long frame,
                                           const int (&off)[kFoldItems],
                                           int tid) {
  const long base = frame * a.H * a.W;
  const bool live = frame < (long)a.B * a.Tp;
  float v[kFoldItems][8];
#pragma unroll
  for (int j = 0; j < kFoldItems; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[j][e] = live && off[j] >= 0 && e < a.Cin
                    ? load1(a, (base + off[j]) * a.Cin + e)
                    : 0.f;
#pragma unroll
  for (int j = 0; j < kFoldItems; ++j)
    if (off[j] > -2)
      *reinterpret_cast<uint4*>(slab + (tid + 128 * j) * 16) = pack8(v[j]);
}

// Stores the epilogue's fp32 tile [256 pixels][N (+8)] as rows of NV
// 16-byte vectors (NV * VEC = N columns, all inside Cout).
template <int N, int NV, bool BF16, bool B32>
__device__ __forceinline__ void store_tile_vec(const Args& a, const float* eo,
                                               long out0, int x0, int y0,
                                               int nf, int n0, int ctid) {
  constexpr int kVec = N / NV;
  const int m = B32 ? 256 : a.p.box_f * a.p.box_r * a.p.box_w;
  for (int i = ctid; i < m * NV; i += 256) {
    const int p = i / NV, c = (i % NV) * kVec;
    int f, r, cc;
    box_pixel<B32>(a.p, p, f, r, cc);
    const int gy = y0 + r, gx = x0 + cc;
    if (f >= nf || gy >= a.H || gx >= a.W) continue;
    const float* src = eo + p * (N + 8) + c;
    const long dst = (((out0 + f) * a.H + gy) * a.W + gx) * a.Cout + n0 + c;
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

__device__ __forceinline__ void store1(const Args& a, long dst, float v) {
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.y)[dst] = __float2bfloat16(v);
  else
    static_cast<float*>(a.y)[dst] = v;
}

// kWalk / kFold: the offsets within a frame of the 4 output pixels this
// thread holds (M rows 32 row + 16 mt + lane/4 + 8 h of a one-frame box),
// -1 past the box's real rows or the image; once a block.
__device__ __forceinline__ void pixel_offsets(const Args& a, int x0, int y0,
                                              int row, int lane,
                                              int (&off)[2][2]) {
  const int bw = a.p.box_w, m_real = a.p.box_r * bw;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 32 * row + 16 * mt + (lane >> 2) + 8 * h;
      const int gy = y0 + m / bw, gx = x0 + m % bw;
      off[mt][h] = m < m_real && gy < a.H && gx < a.W ? gy * a.W + gx : -1;
    }
}

// kWalk / kFold: one output frame `frame` (b * T + t) of this thread's
// pixels straight from the accumulator, bias added, masked at Cout. acc[mt]
// regs 4jj + 2h + e: pixel off[mt][h], column 8jj + 2 (lane % 4) + e.
template <int N>
__device__ __forceinline__ void store_regs(const Args& a,
                                           const float (&acc)[2][N / 2],
                                           long frame, const int (&off)[2][2],
                                           int n0, int lane) {
  const long base = frame * a.H * a.W;
  const int t4 = lane & 3;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const int co = n0 + 8 * jj + 2 * t4;
    if (co >= a.Cout) continue;
    const bool two = co + 1 < a.Cout;
    const float b0 = a.bias != nullptr ? __ldg(a.bias + co) : 0.f;
    const float b1 = a.bias != nullptr && two ? __ldg(a.bias + co + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (off[mt][h] < 0) continue;
        const float v0 = acc[mt][4 * jj + 2 * h] + b0;
        const float v1 = acc[mt][4 * jj + 2 * h + 1] + b1;
        const long dst = (base + off[mt][h]) * a.Cout + co;
        if (two && a.y_pair) {
          if (a.out_bf16)
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.y) +
                                         dst) = pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.y) + dst) =
                make_float2(v0, v1);
        } else {
          store1(a, dst, v0);
          if (two) store1(a, dst + 1, v1);
        }
      }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[2][N / 2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
}

// ---------------------------------------------------------------- kTile

template <int N, int CK, bool B32>
__device__ __forceinline__ void tile_block(const CUtensorMap& tw,
                                           const CUtensorMap& tx, const Args& a,
                                           uint32_t base, unsigned char* gbase) {
  const Plan& P = a.p;
  constexpr int kSwBytes = N % 64 == 0 ? 128 : (N % 32 == 0 ? 64 : 32);
  constexpr int kPanelCols = kSwBytes / 2;
  constexpr int kPanels = N / kPanelCols;
  constexpr uint32_t kSwizzle = kSwBytes == 128 ? 1u : (kSwBytes == 64 ? 2u : 3u);
  constexpr uint32_t kPanelBytes = 9u * CK * kSwBytes;
  constexpr uint32_t kWBytes = 9u * CK * N * 2u;
  constexpr uint32_t kSlabOff = conv4::round1024(kWBytes);
  constexpr int kPixBytes = CK * 2;
  constexpr int kLdOut = N + 8;                // epilogue row
  const int npix = B32 ? 340 : P.slab_pix;
  const uint32_t slab_box = (uint32_t)P.slab_pix * kPixBytes;
  const uint32_t stg_box = (uint32_t)P.slab_pix * CK * 4u;
  const uint32_t ring = P.stages * P.stage_bytes + P.nstg * P.stg_bytes;
  const uint32_t stg0 = base + P.stages * P.stage_bytes;   // fp32 staging
  const uint32_t full0 = base + (ring > P.epilogue_bytes ? ring : P.epilogue_bytes);
  const uint32_t empty0 = full0 + 8 * P.stages;
  const uint32_t xfull0 = empty0 + 8 * P.stages;          // staging filled

  // block -> (N slice, batch row and frame box, spatial box)
  int idx = blockIdx.x;
  const int slice = idx % P.nslices;
  idx /= P.nslices;
  const int bf = idx % (a.B * P.tiles_f);
  const int tile = idx / (a.B * P.tiles_f);
  const int b = bf / P.tiles_f, t0 = (bf % P.tiles_f) * P.box_f;
  const int x0 = (tile % P.tiles_w) * P.box_w;
  const int y0 = (tile / P.tiles_w) * P.box_r;
  const int n0 = slice * N;
  const int nk = a.KT * (P.cin_p / CK);        // stages of the K loop
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P.stages; ++s) {
      // the TMA bytes, and the 128 producer threads where they write the slab
      mbar_init(full0 + 8 * s, P.src == conv4::kTmaBf16 ? 1 : 129);
      mbar_init(empty0 + 8 * s, 8);            // one arrival per consumer warp
    }
    for (int i = 0; i < P.nstg; ++i) mbar_init(xfull0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    if (P.src == conv4::kTmaBf16 && tid != 0) return;
    // x coordinates of K step k: channel c0, frame b * Tp + t0 + kt
    auto load_x = [&](int k, uint32_t dst, uint32_t bar) {
      tma_load_4d(dst, &tx, bar, (k / a.KT) * CK, x0 - 1, y0 - 1,
                  b * a.Tp + t0 + k % a.KT);
    };
    if (P.src == conv4::kTmaF32 && tid == 0) {
      for (int k = 0; k < P.nstg && k < nk; ++k) {
        mbar_expect_tx(xfull0 + 8 * k, stg_box);
        load_x(k, stg0 + k * P.stg_bytes, xfull0 + 8 * k);
      }
    }
    for (int k = 0; k < nk; ++k) {
      const int s = k % P.stages;
      mbar_wait(empty0 + 8 * s, ((k / P.stages) & 1) ^ 1);
      const uint32_t stage = base + s * P.stage_bytes;
      const uint32_t bar = full0 + 8 * s;
      if (tid == 0) {
        mbar_expect_tx(bar, kWBytes + (P.src == conv4::kTmaBf16 ? slab_box : 0u));
#pragma unroll
        for (int m = 0; m < kPanels; ++m)
          tma_load_3d(stage + m * kPanelBytes, &tw, bar, n0 + m * kPanelCols,
                      (k / a.KT) * CK, 9 * (k % a.KT));
        if (P.src == conv4::kTmaBf16) load_x(k, stage + kSlabOff, bar);
      }
      if (P.src == conv4::kTmaBf16) continue;
      unsigned char* slab = gbase + (stage - base) + kSlabOff;
      if (P.src == conv4::kTmaF32) {
        const int sb = k % P.nstg;
        mbar_wait(xfull0 + 8 * sb, (k / P.nstg) & 1);
        stage_convert<CK>(gbase + (stg0 - base) + sb * P.stg_bytes, slab,
                          npix, tid);
        mbar_arrive(bar);     // release: this thread's slab writes
        named_barrier(2, 128);                 // staging buffer sb is read
        if (tid == 0 && k + P.nstg < nk) {
          mbar_expect_tx(xfull0 + 8 * sb, stg_box);
          load_x(k + P.nstg, stg0 + sb * P.stg_bytes, xfull0 + 8 * sb);
        }
      } else {
        stage_manual<CK, B32>(a, slab, (long)b * a.Tp + t0 + k % a.KT,
                              (k / a.KT) * CK, x0, y0, npix, tid);
        mbar_arrive(bar);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int ctid = threadIdx.x - 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = 4 * cw + warp;             // M rows 32 row .. 32 row + 31
    const int sw = B32 ? 34 : P.box_w + 2;
    const int fp = B32 ? 340 : sw * (P.box_r + 2);
    const int m_real = B32 ? 256 : P.box_f * P.box_r * P.box_w;
    float acc[2][N / 2];
    zero<N>(acc);
    uint32_t frag[2][2][4] = {};               // [buffer][M tile][regs]
    // ldmatrix rows: lanes 0-15 give M rows 0-15 of the fragment at chunk
    // 2j, lanes 16-31 the same rows at chunk 2j + 1 (the A layout of
    // m16n8k16); each lane's slab pixel of tap (0, 0), padding rows at 0
    int lpix[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = 32 * row + 16 * mt + (lane & 15);
      int f, r, c;
      box_pixel<B32>(P, m, f, r, c);
      // the 8 x 32 box: M row 32 row + j reads slab pixel 34 row + j at tap
      // (0, 0)
      lpix[mt] = B32 ? 34 * row + 16 * mt + (lane & 15)
                     : m < m_real ? f * fp + r * sw + c : 0;
    }
    const int lhalf = lane >> 4;

    for (int k = 0; k < nk; ++k) {
      const int s = k % P.stages;
      mbar_wait(full0 + 8 * s, (k / P.stages) & 1);
      const uint32_t wst = base + s * P.stage_bytes;
      const uint32_t slab = wst + kSlabOff;
#pragma unroll
      for (int j = 0; j < CK / 16; ++j) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int bb = (j * 9 + tap) & 1;    // wgmma group parity
          const int shift = (tap / 3) * sw + tap % 3;
          wgmma_wait<1>();                     // group g - 2 has retired
          pin(frag[bb][0]);
          pin(frag[bb][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(frag[bb][mt],
                        slab + slab_off<kPixBytes>(lpix[mt] + shift,
                                                   2 * j + lhalf));
          const uint64_t db = smem_desc(wst + (tap * CK + 16 * j) * kSwBytes,
                                        kPanelBytes, 8 * kSwBytes, kSwizzle);
          wgmma_fence();
          wgmma_rs<N>(acc[0], frag[bb][0], db);
          wgmma_rs<N>(acc[1], frag[bb][1], db);
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
      pin(acc[0]);
      pin(acc[1]);
      pin(frag[0]);
      pin(frag[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // ------------------------------------------------------ epilogue
    // acc[mt] regs 4jj + e: M row 32 row + 16mt + lane/4 (+8 for e >= 2),
    // column 8jj + 2 (lane % 4) + (e & 1)
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
        const int p = 32 * row + 16 * mt + g8;
        *reinterpret_cast<float2*>(eo + p * kLdOut + col) =
            make_float2(acc[mt][4 * jj] + b0, acc[mt][4 * jj + 1] + b1);
        *reinterpret_cast<float2*>(eo + (p + 8) * kLdOut + col) =
            make_float2(acc[mt][4 * jj + 2] + b0, acc[mt][4 * jj + 3] + b1);
      }
    }
    named_barrier(1, 256);
    const int ncols = min(N, a.Cout - n0);
    const int nf = min(P.box_f, a.T - t0);
    const long out0 = (long)b * a.T + t0;
    if (a.y_vec && ncols == N) {
      if (a.out_bf16)
        store_tile_vec<N, N / 8, true, B32>(a, eo, out0, x0, y0, nf, n0,
                                            ctid);
      else
        store_tile_vec<N, N / 4, false, B32>(a, eo, out0, x0, y0, nf, n0,
                                             ctid);
    } else {
      for (int i = ctid; i < m_real * ncols; i += 256) {
        const int p = i / ncols, c = i % ncols;
        int f, r, cc;
        box_pixel<B32>(P, p, f, r, cc);
        const int gy = y0 + r, gx = x0 + cc;
        if (f >= nf || gy >= a.H || gx >= a.W) continue;
        const long dst = (((out0 + f) * a.H + gy) * a.W + gx) * a.Cout + n0 + c;
        store1(a, dst, eo[p * kLdOut + c]);
      }
    }
  }
}

// ---------------------------------------------------------------- kWalk

template <int CK>
__device__ __forceinline__ void walk_block(const CUtensorMap& tw,
                                           const CUtensorMap& tx, const Args& a,
                                           uint32_t base, unsigned char* gbase) {
  constexpr int N = 16;
  constexpr int kPixBytes = CK * 2;
  const Plan& P = a.p;
  const uint32_t wres = base;                  // [27, CinP, 16] bf16
  const uint32_t ring0 = base + conv4::round1024(P.w_bytes);
  const uint32_t stg0 = ring0 + P.stages * P.stage_bytes;
  const uint32_t full0 = stg0 + P.nstg * P.stg_bytes;
  const uint32_t empty0 = full0 + 8 * P.stages;
  const uint32_t xfull0 = empty0 + 8 * P.stages;
  const uint32_t wfull = xfull0 + 8 * P.nstg;
  const uint32_t slab_box = (uint32_t)P.slab_pix * kPixBytes;
  const uint32_t stg_box = (uint32_t)P.slab_pix * CK * 4u;

  // block -> (batch row and run of output frames, spatial box)
  const int bf = blockIdx.x % (a.B * P.tiles_f);
  const int tile = blockIdx.x / (a.B * P.tiles_f);
  const int b = bf / P.tiles_f, t0 = (bf % P.tiles_f) * P.walk;
  const int x0 = (tile % P.tiles_w) * P.box_w;
  const int y0 = (tile / P.tiles_w) * P.box_r;
  const int nout = min(P.walk, a.T - t0);
  const int nchunk = P.cin_p / CK;
  const int nk = (nout + 2) * nchunk;          // (input frame, chunk) stages
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(full0 + 8 * s, P.src == conv4::kTmaBf16 ? 1 : 128);
      mbar_init(empty0 + 8 * s, 8);
    }
    for (int i = 0; i < P.nstg; ++i) mbar_init(xfull0 + 8 * i, 1);
    mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    if (tid == 0) {
      // the whole weight, one box [9, CinP, 16] a temporal tap
      mbar_expect_tx(wfull, P.w_bytes);
      for (int kt = 0; kt < 3; ++kt)
        tma_load_3d(wres + kt * 9u * P.cin_p * 32u, &tw, wfull, 0, 0, 9 * kt);
    }
    if (P.src == conv4::kTmaBf16 && tid != 0) return;
    auto load_x = [&](int k, uint32_t dst, uint32_t bar) {
      tma_load_4d(dst, &tx, bar, (k % nchunk) * CK, x0 - 1, y0 - 1,
                  b * a.Tp + t0 + k / nchunk);
    };
    if (P.src == conv4::kTmaF32 && tid == 0) {
      for (int k = 0; k < P.nstg && k < nk; ++k) {
        mbar_expect_tx(xfull0 + 8 * k, stg_box);
        load_x(k, stg0 + k * P.stg_bytes, xfull0 + 8 * k);
      }
    }
    for (int k = 0; k < nk; ++k) {
      const int s = k % P.stages;
      mbar_wait(empty0 + 8 * s, ((k / P.stages) & 1) ^ 1);
      const uint32_t slab = ring0 + s * P.stage_bytes;
      const uint32_t bar = full0 + 8 * s;
      if (P.src == conv4::kTmaBf16) {
        mbar_expect_tx(bar, slab_box);
        load_x(k, slab, bar);
        continue;
      }
      unsigned char* gslab = gbase + (slab - base);
      if (P.src == conv4::kTmaF32) {
        const int sb = k % P.nstg;
        mbar_wait(xfull0 + 8 * sb, (k / P.nstg) & 1);
        stage_convert<CK>(gbase + (stg0 - base) + sb * P.stg_bytes, gslab,
                          P.slab_pix, tid);
        mbar_arrive(bar);
        named_barrier(2, 128);
        if (tid == 0 && k + P.nstg < nk) {
          mbar_expect_tx(xfull0 + 8 * sb, stg_box);
          load_x(k + P.nstg, stg0 + sb * P.stg_bytes, xfull0 + 8 * sb);
        }
      } else {
        stage_manual<CK, false>(a, gslab, (long)b * a.Tp + t0 + k / nchunk,
                                (k % nchunk) * CK, x0, y0, P.slab_pix, tid);
        mbar_arrive(bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = 4 * cw + warp;
    const int sw = P.box_w + 2, bw = P.box_w, m_real = P.box_r * bw;
    // accumulators of output frames i (kt 0), i - 1 (kt 1), i - 2 (kt 2)
    float acc0[2][N / 2], acc1[2][N / 2], acc2[2][N / 2];
    zero<N>(acc0);
    zero<N>(acc1);
    zero<N>(acc2);
    uint32_t frag[2][2][4] = {};
    int lpix[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = 32 * row + 16 * mt + (lane & 15);
      lpix[mt] = m < m_real ? (m / bw) * sw + m % bw : 0;
    }
    const int lhalf = lane >> 4;
    int off[2][2];
    pixel_offsets(a, x0, y0, row, lane, off);
    mbar_wait(wfull, 0);

    for (int k = 0; k < nk; ++k) {
      const int s = k % P.stages;
      const int c = k % nchunk;
      mbar_wait(full0 + 8 * s, (k / P.stages) & 1);
      const uint32_t slab = ring0 + s * P.stage_bytes;
#pragma unroll
      for (int j = 0; j < CK / 16; ++j) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int bb = (j * 9 + tap) & 1;
          const int shift = (tap / 3) * sw + tap % 3;
          wgmma_wait<1>();
          pin(frag[bb][0]);
          pin(frag[bb][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(frag[bb][mt],
                        slab + slab_off<kPixBytes>(lpix[mt] + shift,
                                                   2 * j + lhalf));
          // weight rows (kt * 9 + tap) * CinP + c * CK + 16 j, 32 bytes each
          const uint32_t w0 =
              wres + ((tap * P.cin_p) + c * CK + 16 * j) * 32u;
          const uint32_t kt_step = 9u * P.cin_p * 32u;
          const uint64_t d0 = smem_desc(w0, 9u * P.cin_p * 32u, 256, 3);
          const uint64_t d1 = smem_desc(w0 + kt_step, 9u * P.cin_p * 32u, 256, 3);
          const uint64_t d2 =
              smem_desc(w0 + 2 * kt_step, 9u * P.cin_p * 32u, 256, 3);
          wgmma_fence();
          wgmma_rs<N>(acc0[0], frag[bb][0], d0);
          wgmma_rs<N>(acc0[1], frag[bb][1], d0);
          wgmma_rs<N>(acc1[0], frag[bb][0], d1);
          wgmma_rs<N>(acc1[1], frag[bb][1], d1);
          wgmma_rs<N>(acc2[0], frag[bb][0], d2);
          wgmma_rs<N>(acc2[1], frag[bb][1], d2);
          wgmma_commit();
        }
      }
      wgmma_wait<0>();
      pin(acc0[0]);
      pin(acc0[1]);
      pin(acc1[0]);
      pin(acc1[1]);
      pin(acc2[0]);
      pin(acc2[1]);
      pin(frag[0]);
      pin(frag[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (c == nchunk - 1) {
        // input frame i = k / nchunk done: output frame t0 + i - 2 is whole
        const int i = k / nchunk;
        if (i >= 2)
          store_regs<N>(a, acc2, (long)b * a.T + t0 + i - 2, off, 0, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < N / 2; ++r) {
            acc2[mt][r] = acc1[mt][r];
            acc1[mt][r] = acc0[mt][r];
            acc0[mt][r] = 0.f;
          }
      }
    }
  }
}

// ---------------------------------------------------------------- kFold

template <int N, int KT>
__device__ __forceinline__ void fold_block(const CUtensorMap& tw, const Args& a,
                                           uint32_t base, unsigned char* gbase) {
  constexpr int kSwBytes = N % 64 == 0 ? 128 : (N % 32 == 0 ? 64 : 32);
  constexpr int kPanelCols = kSwBytes / 2;
  constexpr int kPanels = N / kPanelCols;
  constexpr uint32_t kSwizzle = kSwBytes == 128 ? 1u : (kSwBytes == 64 ? 2u : 3u);
  constexpr int kTaps = 9 * KT;                // real taps; the last step's
  constexpr int kSteps = (kTaps + 1) / 2;      // second half is a zero tap
  constexpr uint32_t kPanelBytes = (kTaps + 1) * 8u * kSwBytes;
  const Plan& P = a.p;
  const int S = P.stages;                      // input-frame slabs
  const uint32_t wres = base;                  // [28, 8, N] bf16
  const uint32_t ring0 = base + conv4::round1024(P.w_bytes);
  const uint32_t full0 = ring0 + S * P.stage_bytes;
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t wfull = empty0 + 8 * S;

  int idx = blockIdx.x;
  const int slice = idx % P.nslices;
  idx /= P.nslices;
  const int bf = idx % (a.B * P.tiles_f);
  const int tile = idx / (a.B * P.tiles_f);
  const int b = bf / P.tiles_f, t0 = (bf % P.tiles_f) * P.walk;
  const int x0 = (tile % P.tiles_w) * P.box_w;
  const int y0 = (tile / P.tiles_w) * P.box_r;
  const int n0 = slice * N;
  const int nout = min(P.walk, a.T - t0);      // output frames t0 ..
  const int nin = nout + KT - 1;               // input frames t0 ..
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 128);           // the producer's threads
      mbar_init(empty0 + 8 * s, 8);
    }
    mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(wfull, P.w_bytes);
#pragma unroll
      for (int m = 0; m < kPanels; ++m)
        tma_load_3d(wres + m * kPanelBytes, &tw, wfull, n0 + m * kPanelCols,
                    0, 0);
    }
    int off[kFoldItems];
    fold_offsets(a, x0, y0, tid, off);
    // each input frame staged once, into slab i % S; output frame k reads
    // slabs k .. k + KT - 1 and then frees slab k
    for (int i = 0; i < nin; ++i) {
      const int s = i % S;
      mbar_wait(empty0 + 8 * s, ((i / S) & 1) ^ 1);
      stage_fold(a, gbase + (ring0 - base) + s * P.stage_bytes,
                 (long)b * a.Tp + t0 + i, off, tid);
      mbar_arrive(full0 + 8 * s);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = 4 * cw + warp;
    const int sw = P.box_w + 2, bw = P.box_w, m_real = P.box_r * bw;
    float acc[2][N / 2];
    zero<N>(acc);
    uint32_t frag[2][2][4] = {};
    int lpix[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = 32 * row + 16 * mt + (lane & 15);
      lpix[mt] = m < m_real ? (m / bw) * sw + m % bw : 0;
    }
    const int lhalf = lane >> 4;
    int off[2][2];
    pixel_offsets(a, x0, y0, row, lane, off);
    mbar_wait(wfull, 0);

    for (int k = 0; k < nout; ++k) {
      uint32_t slab[KT];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const int i = k + kt;
        mbar_wait(full0 + 8 * (i % S), (i / S) & 1);
        slab[kt] = ring0 + (i % S) * P.stage_bytes;
      }
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int bb = st & 1;
        // this lane's tap: 2 st or 2 st + 1; the zero tap reads tap 26's
        int tap = 2 * st + lhalf;
        tap = tap < kTaps ? tap : kTaps - 1;
        const int kt = tap / 9, sp = tap % 9;
        const uint32_t src =
            KT == 1 || kt == 0 ? slab[0] : kt == 1 ? slab[1] : slab[KT - 1];
        const int shift = (sp / 3) * sw + sp % 3;
        wgmma_wait<1>();
        pin(frag[bb][0]);
        pin(frag[bb][1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(frag[bb][mt], src + (lpix[mt] + shift) * 16u);
        const uint64_t db = smem_desc(wres + 16u * st * kSwBytes, kPanelBytes,
                                      8 * kSwBytes, kSwizzle);
        wgmma_fence();
        wgmma_rs<N>(acc[0], frag[bb][0], db);
        wgmma_rs<N>(acc[1], frag[bb][1], db);
        wgmma_commit();
      }
      wgmma_wait<0>();
      pin(acc[0]);
      pin(acc[1]);
      pin(frag[0]);
      pin(frag[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * (k % S));   // input frame k
      store_regs<N>(a, acc, (long)b * a.T + t0 + k, off, n0, lane);
      zero<N>(acc);
    }
  }
}

template <int ROUTE, int N, int CK, bool B32>
__global__ void __launch_bounds__(kThreads, 1)
conv3d_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  if constexpr (ROUTE == conv4::kTile) {
    tile_block<N, CK, B32>(tw, tx, a, base, gbase);
  } else if constexpr (ROUTE == conv4::kWalk) {
    walk_block<CK>(tw, tx, a, base, gbase);
  } else {
    fold_block<N, CK>(tw, a, base, gbase);  // CK: the fold's temporal taps
  }
}

template <int ROUTE, int N, int CK, bool B32 = false>
cudaError_t launch(const void* w, const Args& a, cudaStream_t stream) {
  const Plan& P = a.p;
  const uint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap tw, tx;
  cudaError_t err;
  if (ROUTE == conv4::kFold) {
    // the weight [9 KT + 1, 8, CoutP], one box a column panel
    const uint64_t dims[3] = {(uint64_t)P.cout_p, 8, (uint64_t)P.taps_k};
    const uint64_t strides[2] = {P.cout_p * e, 8 * P.cout_p * e};
    const uint32_t box[3] = {(uint32_t)P.sw_bytes / 2, 8, (uint32_t)P.taps_k};
    err = make_map(&tw, w, 3, dims, strides, box, P.sw_bytes);
  } else {
    // the weight [9 KT, CinP, CoutP], in boxes of one column panel x CK
    // channels x 9 spatial taps (kTile), or 16 columns x CinP x 9 (kWalk)
    const uint64_t dims[3] = {(uint64_t)P.cout_p, (uint64_t)P.cin_p,
                              (uint64_t)P.taps_k};
    const uint64_t strides[2] = {P.cout_p * e, (uint64_t)P.cin_p * P.cout_p * e};
    const uint32_t box[3] = {(uint32_t)P.sw_bytes / 2,
                             (uint32_t)(ROUTE == conv4::kWalk ? P.cin_p : P.ck),
                             9};
    err = make_map(&tw, w, 3, dims, strides, box, P.sw_bytes);
  }
  if (err != cudaSuccess) return err;
  tx = tw;                                     // unused when staged by hand
  if (ROUTE != conv4::kFold && P.src != conv4::kManual) {
    // x as (C, W, H, T * B): the slab of one stage is one box, bf16 in the
    // slab's swizzle, fp32 unswizzled into the staging buffer
    const uint64_t xe = a.in_bf16 ? 2 : 4;
    const uint64_t xdims[4] = {(uint64_t)a.Cin, (uint64_t)a.W,
                               (uint64_t)a.H, (uint64_t)a.B * a.Tp};
    const uint64_t xstr[3] = {a.Cin * xe, (uint64_t)a.W * a.Cin * xe,
                              (uint64_t)a.H * a.W * a.Cin * xe};
    const uint32_t xbox[4] = {(uint32_t)P.ck, (uint32_t)P.box_w + 2,
                              (uint32_t)P.box_r + 2,
                              (uint32_t)(ROUTE == conv4::kTile ? P.box_f : 1)};
    err = P.src == conv4::kTmaBf16
              ? make_map(&tx, a.x, 4, xdims, xstr, xbox, P.ck * 2)
              : make_map(&tx, a.x, 4, xdims, xstr, xbox, 0,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err != cudaSuccess) return err;
  }
  // set on every call: a once-per-device flag would be an ELF unique symbol
  // shared by two libraries built from these sources in one process
  err = cudaFuncSetAttribute(conv3d_kernel<ROUTE, N, CK, B32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P.smem);
  if (err != cudaSuccess) return err;
  conv3d_kernel<ROUTE, N, CK, B32><<<(unsigned)P.blocks, kThreads, P.smem,
                                       stream>>>(tw, tx, a);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* w, const Args& a, cudaStream_t s) {
  const Plan& P = a.p;
  if (P.route == conv4::kWalk) {
    if (P.ck == 16) return launch<conv4::kWalk, 16, 16>(w, a, s);
    if (P.ck == 32) return launch<conv4::kWalk, 16, 32>(w, a, s);
    return cudaErrorInvalidValue;
  }
  if (P.route == conv4::kFold) {
#define WF_FOLD(NN)                                    \
  case NN:                                             \
    return a.KT == 3 ? launch<conv4::kFold, NN, 3>(w, a, s) \
                     : launch<conv4::kFold, NN, 1>(w, a, s);
    switch (P.n) {
      WF_FOLD(16)
      WF_FOLD(32)
      WF_FOLD(96)
      WF_FOLD(128)
      WF_FOLD(160)
    }
#undef WF_FOLD
    return cudaErrorInvalidValue;
  }
  // the 8 x 32 box by its own kernel, its geometry compile-time
  const bool b32 = P.box_w == 32 && P.box_r == 8 && P.box_f == 1;
#define WF_TILE(NN)                                                       \
  case NN:                                                                \
    if (b32)                                                              \
      return P.ck == 32 ? launch<conv4::kTile, NN, 32, true>(w, a, s)     \
                        : launch<conv4::kTile, NN, 16, true>(w, a, s);    \
    return P.ck == 32 ? launch<conv4::kTile, NN, 32, false>(w, a, s)      \
                      : launch<conv4::kTile, NN, 16, false>(w, a, s);
  switch (P.n) {
    WF_TILE(16)
    WF_TILE(32)
    WF_TILE(96)
    WF_TILE(128)
    WF_TILE(160)
  }
#undef WF_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: [B, Tp, H, W, Cin] of in_dtype; w: bf16, the route's layout (16-byte
// aligned): [9 taps, CinP, CoutP] (kTile, kWalk) or [9 taps + 1, 8, CoutP]
// (kFold); bias fp32 [Cout] or null; y [B, Tp - taps + 1, H, W, Cout] of
// out_dtype (dtypes: 0 = float32, 1 = bfloat16); taps: the temporal taps, 3
// (the causal 3x3x3 conv) or 1 (a 3x3 conv of every frame); sms: the card's
// SMs. The plan is conv3d_plan.cuh's for these; route, n and smem_bytes are
// the caller's copy of it (ops/conv3d.py::conv_plan), and a call whose copy
// differs is refused. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments outside that.
int wf_conv3d_causal(const void* x, const void* w, const void* bias, void* y,
                     int B, int Tp, int taps, int H, int W, int Cin, int Cout,
                     int in_dtype, int out_dtype, int sms, int route, int n,
                     int smem_bytes, void* stream) {
  const bool x_tma = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  Plan p;
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1) ||
      Tp < taps ||
      !conv4::make_plan(taps, B, Tp - taps + 1, H, W, Cin, Cout, in_dtype,
                        x_tma, sms, &p) ||
      p.route != route || p.n != n || (int)p.smem != smem_bytes ||
      (int)p.smem > conv4::kSmemLimit ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.B = B;
  a.Tp = Tp;
  a.T = Tp - taps + 1;
  a.KT = taps;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.in_bf16 = in_dtype;
  a.out_bf16 = out_dtype;
  a.y_vec = Cout % (out_dtype ? 8 : 4) == 0 &&
            reinterpret_cast<uintptr_t>(y) % 16 == 0;
  a.y_pair = Cout % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  a.p = p;
  return (int)dispatch(w, a, static_cast<cudaStream_t>(stream));
}

const char* wf_conv3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
