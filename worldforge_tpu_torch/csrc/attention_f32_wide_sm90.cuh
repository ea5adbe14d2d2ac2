// Kernel 1's fp32 path at head dims 384 and 512 on Hopper (sm_90a): the
// Wan2.1 and SVD VAEs' single-head mid attention, as two GEMM passes whose
// products each run as three TF32 wgmma products (hi.hi + hi.lo + lo.hi),
// with the scores kept in a bounded fp32 scratch between them. Used by
// csrc/flash_attention.cu; the design note is at the top of that file. The
// tiles, stages, shared-memory bytes and the scratch's size are
// attention_f32_plan.cuh's, which the host reads too.
//
// A call runs in chunks of `chunk_tiles` 128-row query tiles, numbered flat
// over (b * h, query tile); per chunk:
//   pass 1, fa_f32_scores_kernel<D>: one block per (query tile, 128-key
//     tile) computes S = scale Q.K^T for its 128 x 128 scores, the depth
//     streamed through a ring of 32-float stages, and writes S and each
//     row's max and sum of exp over its 128 keys. Key tiles at or past the
//     batch row's kv_len are skipped; keys past it within a tile are -1e30.
//   pass 2, fa_f32_pv_kernel<D>: one block per (query tile, 128 columns of
//     O) reduces the row's per-tile (max, sum) to m and l, then streams the
//     keys in 32-key stages: the S tile and V arrive by TMA, P = exp(S - m)
//     is computed and split in the consumers' registers, O += P.V, and O / l
//     is stored (m and l too by the first column block).
//
// Both kernels: warpgroup 0's warp 0 issues every TMA copy (one thread),
// its warps 1-3 (96 threads) split each B operand that lands into TF32 hi
// / lo planes (K in place in pass 1; V transposed into V^T planes in pass
// 2, as attention_f32_sm90.cuh does); warpgroups 1 and 2 are the consumers,
// 64 query rows each, taking turns to issue their products (named barriers
// 2 and 3) so one's register work overlaps the other's products. The A
// operands (Q in pass 1, P in pass 2) are split in registers.
//
// Shared memory (offsets from a 1024-byte aligned base; each tile 16 KB):
//   pass 1, per stage s < 4: Q raw [128 rows][32] and K hi, K lo [128
//     keys][32], each in the 128-byte swizzle TMA writes; TMA lands raw K
//     in the hi plane, split in place. Then full[4], kready[4], empty[4].
//   pass 2, per stage s < 3: S [128 rows][32 keys] (128-byte swizzle), V
//     raw [32 keys][128 columns] (unswizzled), V^T hi / lo [128][32 keys]
//     (128-byte swizzle, the keys of each 8-key step in the order 0 2 4 6 1
//     3 5 7). Then full[3], vready[3], empty[3].
// Registers: a pass-1 consumer thread holds 64 fp32 of S's running sum, 64
// of the stage's product and 32 of Q's split fragments; a pass-2 consumer
// 64 of O, 64 of the tile's P.V and 32 of P's split fragments
// (setmaxnreg: 224 a consumer thread, 56 a producer / splitter thread).
//
// Sums: the tensor cores truncate as they add into an fp32 accumulator, so
// S is summed one 32-float stage (4 k-steps) at a time, each stage's cross
// terms first and hi.hi last, the stages added in fp32; each 32-key tile's
// P.V goes into a fresh accumulator added to O in fp32.

#pragma once

#include <algorithm>

#include "attention_f32_plan.cuh"
#include "attention_f32_sm90.cuh"

namespace sm90f32w {

using sm90f32::kNegInf;
using sm90f32::kSplitters;

struct ScoreLayout {
  __host__ __device__ static constexpr uint32_t q(int s) { return 3 * kTile * s; }
  __host__ __device__ static constexpr uint32_t k_hi(int s) { return q(s) + kTile; }
  __host__ __device__ static constexpr uint32_t k_lo(int s) { return q(s) + 2 * kTile; }
  static constexpr uint32_t bars = kScoreBars;
  static constexpr size_t bytes = kScoreSmem;
};
static_assert(ScoreLayout::q(kScoreStages) == ScoreLayout::bars,
              "pass 1's stages end where its mbarriers start");

struct PVLayout {
  __host__ __device__ static constexpr uint32_t s_tile(int s) { return 4 * kTile * s; }
  __host__ __device__ static constexpr uint32_t v_raw(int s) { return s_tile(s) + kTile; }
  __host__ __device__ static constexpr uint32_t vt_hi(int s) { return s_tile(s) + 2 * kTile; }
  __host__ __device__ static constexpr uint32_t vt_lo(int s) { return s_tile(s) + 3 * kTile; }
  static constexpr uint32_t bars = kPVBars;
  static constexpr size_t bytes = kPVSmem;
};
static_assert(PVLayout::s_tile(kStages) == PVLayout::bars,
              "pass 2's stages end where its mbarriers start");

// Where a chunk's row tile `tile` (flat over b * h and query tiles) reads
// and writes: batch b, head h, first query row q0, and its key length.
struct RowTile {
  int bh, b, h, q0, kv_len;
  __device__ RowTile(int tile, int qtiles, int H, int Sk, const int* kv_lens) {
    bh = tile / qtiles;
    b = bh / H;
    h = bh % H;
    q0 = (tile % qtiles) * kRows;
    kv_len = kv_lens != nullptr ? max(0, min(kv_lens[b], Sk)) : Sk;
  }
};

struct Params {
  const int* kv_lens;   // [B] key lengths (null: every row has Sk)
  float* s;             // [chunk_tiles * 128][s_ld] scores of the chunk
  float2* part;         // [chunk_tiles * 128][nkt] (max, sum of exp) a key tile
  float* o;
  float* m;             // optional [BH, Sq] max of the scaled scores
  float* l;             // optional [BH, Sq] softmax normaliser
  int Sq, Sk, H, qtiles, nkt, t0;
  long s_ld;            // floats a row of S: nkt * 128
  float scale;
};

// The consumers' fragment coordinates: warp w of warpgroup cw, lane (g =
// lane / 4, t4 = lane % 4); rows r0 = 64 cw + 16 w + g and r1 = r0 + 8.
struct Frag {
  int cw, warp, lane, g, t4, r0, r1;
  __device__ explicit Frag(int wg) {
    cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    warp = tid / 32;
    lane = tid % 32;
    g = lane / 4;
    t4 = lane % 4;
    r0 = cw * 64 + warp * 16 + g;
    r1 = r0 + 8;
  }
};

// The (max, sum) of two partial softmax sums, in base-2 exponents.
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * sm90::ex2((m - mn) * sm90::kLog2e) +
      l2 * sm90::ex2((m2 - mn) * sm90::kLog2e);
  m = mn;
}

// ------------------------------------------------------------ pass 1

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_f32_scores_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk, const Params p) {
  using L = ScoreLayout;
  constexpr int NS = kScoreStages, NC = D / kDepth;
  const int tile = p.t0 + blockIdx.x / p.nkt, kt = blockIdx.x % p.nkt;
  const RowTile rt(tile, p.qtiles, p.H, p.Sk, p.kv_lens);
  const int k0 = kt * kScoreKeys;
  if (k0 >= rt.kv_len) return;              // wholly past kv_len: skipped
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t full0 = base + L::bars;     // full[s]: Q and K landed
  const uint32_t kready0 = full0 + 8 * NS;   // kready[s]: K's planes written
  const uint32_t empty0 = kready0 + 8 * NS;  // empty[s]: consumers done
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(kready0 + 8 * s, kSplitters);
      sm90::mbar_init(empty0 + 8 * s, 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------- producer + splitter
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0) {
      for (int c = 0; c < NC; ++c) {
        const int s = c % NS;
        sm90::mbar_wait(empty0 + 8 * s, ((c / NS) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        sm90::mbar_expect_tx(bar, 2 * kTile);
        sm90::tma_load_4d(base + L::q(s), &tq, bar, c * kDepth, rt.h, rt.q0, rt.b);
        sm90::tma_load_4d(base + L::k_hi(s), &tk, bar, c * kDepth, rt.h, k0, rt.b);
      }
    } else if (threadIdx.x >= 32) {
      const int st = threadIdx.x - 32;
      for (int c = 0; c < NC; ++c) {
        const int s = c % NS;
        sm90::mbar_wait(full0 + 8 * s, (c / NS) & 1);
        sm90f32::split_rows<128>(sm + L::k_hi(s), sm + L::k_hi(s),
                                 sm + L::k_lo(s), 1, kScoreKeys, kScoreKeys, st);
        sm90f32::fence_async_smem();
        sm90::mbar_arrive(kready0 + 8 * s);
      }
    }
  } else {
    // ------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const Frag f(wg);
    // K's k-step kk: 8 columns (32 bytes) of the stage's one panel
    auto kdesc = [&](uint32_t plane, int kk) {
      return sm90::smem_desc(base + plane + kk * 32, 16, 1024, 1);
    };
    float sc[kScoreKeys / 2];
    if (f.cw == 1) sm90f32::named_arrive(2);   // the first warpgroup goes first
    for (int c = 0; c < NC; ++c) {
      const int s = c % NS;
      const uint32_t ph = (c / NS) & 1;
      // Q's split fragments of this stage (k-step kk: rows r0 (regs 0, 2)
      // and r1 (1, 3) at columns 8 kk + t4 (0, 1) and + 4 (2, 3)), read
      // through the 128-byte swizzle
      uint32_t qh[4][4], ql[4][4];
      sm90::mbar_wait(full0 + 8 * s, ph);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (i & 1) ? f.r1 : f.r0;
          const uint32_t at = (r * 128 + (8 * kk + f.t4 + 4 * (i >> 1)) * 4) ^
                              ((r & 7) << 4);
          sm90f32::split_tf32(*reinterpret_cast<const float*>(sm + L::q(s) + at),
                              qh[kk][i], ql[kk][i]);
        }
      sm90::mbar_wait(kready0 + 8 * s, ph);
      // lo.hi and hi.lo first, hi.hi last (lo.lo is below fp32 rounding)
      float tp[kScoreKeys / 2];
      sm90f32::named_sync(2 + f.cw);
      sm90::wgmma_fence();
      sm90::pin(qh);
      sm90::pin(ql);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90f32::wgmma_tf32_rs<kScoreKeys>(tp, ql[kk], kdesc(L::k_hi(s), kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90f32::wgmma_tf32_rs<kScoreKeys>(tp, qh[kk], kdesc(L::k_lo(s), kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90f32::wgmma_tf32_rs<kScoreKeys>(tp, qh[kk], kdesc(L::k_hi(s), kk), 1);
      sm90::wgmma_commit();
      sm90f32::named_arrive(3 - f.cw);           // the other's turn
      sm90::wgmma_wait_all();
      sm90::pin(tp);
      sm90::pin(qh);
      sm90::pin(ql);
      __syncwarp();
      if (f.lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int e = 0; e < kScoreKeys / 2; ++e) sc[e] = c == 0 ? tp[e] : sc[e] + tp[e];
    }
    if (f.cw == 0) sm90f32::named_sync(2);     // the second's last arrival

    // epilogue: scale, mask keys at or past kv_len, the rows' max and sum
    // of exp over this tile (regs 4j, 4j+1: row r0, keys 8j + 2 t4 + {0,1};
    // 4j+2, 4j+3: row r1), then S and the partials to the scratch
    const int valid = rt.kv_len - k0;
    float m0 = kNegInf, m1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kScoreKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * p.scale;
        if (8 * j + 2 * f.t4 + (e & 1) >= valid) x = kNegInf;
        sc[4 * j + e] = x;
        if (e < 2) m0 = fmaxf(m0, x);
        else m1 = fmaxf(m1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < kScoreKeys / 8; ++j) {
      l0 += sm90::ex2((sc[4 * j] - m0) * sm90::kLog2e) +
            sm90::ex2((sc[4 * j + 1] - m0) * sm90::kLog2e);
      l1 += sm90::ex2((sc[4 * j + 2] - m1) * sm90::kLog2e) +
            sm90::ex2((sc[4 * j + 3] - m1) * sm90::kLog2e);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const long row0 = (long)(tile - p.t0) * kRows + f.r0, row1 = row0 + 8;
    float* s0 = p.s + row0 * p.s_ld + k0 + 2 * f.t4;
    float* s1 = p.s + row1 * p.s_ld + k0 + 2 * f.t4;
#pragma unroll
    for (int j = 0; j < kScoreKeys / 8; ++j) {
      *reinterpret_cast<float2*>(s0 + 8 * j) = make_float2(sc[4 * j], sc[4 * j + 1]);
      *reinterpret_cast<float2*>(s1 + 8 * j) = make_float2(sc[4 * j + 2], sc[4 * j + 3]);
    }
    if (f.t4 == 0) {
      p.part[row0 * p.nkt + kt] = make_float2(m0, l0);
      p.part[row1 * p.nkt + kt] = make_float2(m1, l1);
    }
  }
}

// ------------------------------------------------------------ pass 2

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_f32_pv_kernel(const __grid_constant__ CUtensorMap ts,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = PVLayout;
  constexpr int NS = kStages, NCOL = D / kCols;
  const int tile = p.t0 + blockIdx.x / NCOL, c0 = (blockIdx.x % NCOL) * kCols;
  const RowTile rt(tile, p.qtiles, p.H, p.Sk, p.kv_lens);
  const int srow = (tile - p.t0) * kRows;    // the tile's first row of S
  const int n = (rt.kv_len + kKeys - 1) / kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t full0 = base + L::bars;     // full[s]: S and V landed
  const uint32_t vready0 = full0 + 8 * NS;   // vready[s]: V^T's planes written
  const uint32_t empty0 = vready0 + 8 * NS;  // empty[s]: consumers done
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(vready0 + 8 * s, kSplitters);
      sm90::mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------- producer + splitter
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0) {
      for (int t = 0; t < n; ++t) {
        const int s = t % NS;
        sm90::mbar_wait(empty0 + 8 * s, ((t / NS) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        sm90::mbar_expect_tx(bar, 2 * kTile);
        sm90::tma_load_2d(base + L::s_tile(s), &ts, bar, t * kKeys, srow);
        sm90::tma_load_4d(base + L::v_raw(s), &tv, bar, c0, rt.h, t * kKeys, rt.b);
      }
    } else if (threadIdx.x >= 32) {
      const int st = threadIdx.x - 32;
      for (int t = 0; t < n; ++t) {
        const int s = t % NS;
        sm90::mbar_wait(full0 + 8 * s, (t / NS) & 1);
        sm90f32::split_transpose_v<kCols, kKeys, false>(
            reinterpret_cast<const float*>(sm + L::v_raw(s)), sm + L::vt_hi(s),
            sm + L::vt_lo(s), st);
        sm90f32::fence_async_smem();
        sm90::mbar_arrive(vready0 + 8 * s);
      }
    }
  } else {
    // ------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const Frag f(wg);
    // V^T's k-step j: keys 8j .. 8j + 7 (32 bytes) of each 128-byte row
    auto vdesc = [&](uint32_t plane, int j) {
      return sm90::smem_desc(base + plane + j * 32, 16, 1024, 1);
    };
    // m and l of rows r0, r1 from the (max, sum) of each key tile pass 1
    // wrote: lane t4 takes tiles t4, t4 + 4, ..., then the four merge
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    const int tiles = (rt.kv_len + kScoreKeys - 1) / kScoreKeys;
    const float2* pr0 = p.part + (long)(srow + f.r0) * p.nkt;
    const float2* pr1 = p.part + (long)(srow + f.r1) * p.nkt;
    for (int kt = f.t4; kt < tiles; kt += 4) {
      const float2 a = pr0[kt], c = pr1[kt];
      merge(m0, l0, a.x, a.y);
      merge(m1, l1, c.x, c.y);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      merge(m0, l0, __shfl_xor_sync(0xffffffffu, m0, off),
            __shfl_xor_sync(0xffffffffu, l0, off));
      merge(m1, l1, __shfl_xor_sync(0xffffffffu, m1, off),
            __shfl_xor_sync(0xffffffffu, l1, off));
    }
    float o[kCols / 2];
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
    if (f.cw == 1 && n > 0) sm90f32::named_arrive(2);
    for (int t = 0; t < n; ++t) {
      const int s = t % NS;
      const uint32_t ph = (t / NS) & 1;
      const int valid = rt.kv_len - t * kKeys;
      // P = exp(S - m) of rows r0, r1 at keys 8j + 2 t4 + {0, 1}, read
      // through the 128-byte swizzle; keys at or past kv_len give 0. As
      // the A operand, split once: k-step j's columns t4, t4 + 4 are keys
      // 8j + 2 t4, 8j + 2 t4 + 1 (V^T holds its keys in that order)
      sm90::mbar_wait(full0 + 8 * s, ph);
      uint32_t phi[kKeys / 8][4], plo[kKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const uint32_t c = (8 * j + 2 * f.t4) * 4;
        const float2 a = *reinterpret_cast<const float2*>(
            sm + L::s_tile(s) + ((f.r0 * 128 + c) ^ ((f.r0 & 7) << 4)));
        const float2 b = *reinterpret_cast<const float2*>(
            sm + L::s_tile(s) + ((f.r1 * 128 + c) ^ ((f.r1 & 7) << 4)));
        const bool v0 = 8 * j + 2 * f.t4 < valid, v1 = 8 * j + 2 * f.t4 + 1 < valid;
        const float e00 = v0 ? sm90::ex2((a.x - m0) * sm90::kLog2e) : 0.f;
        const float e01 = v1 ? sm90::ex2((a.y - m0) * sm90::kLog2e) : 0.f;
        const float e10 = v0 ? sm90::ex2((b.x - m1) * sm90::kLog2e) : 0.f;
        const float e11 = v1 ? sm90::ex2((b.y - m1) * sm90::kLog2e) : 0.f;
        sm90f32::split_tf32(e00, phi[j][0], plo[j][0]);
        sm90f32::split_tf32(e10, phi[j][1], plo[j][1]);
        sm90f32::split_tf32(e01, phi[j][2], plo[j][2]);
        sm90f32::split_tf32(e11, phi[j][3], plo[j][3]);
      }
      // this tile's P V, summed apart (a fresh accumulator) and added to O
      // in fp32
      float ot[kCols / 2];
      sm90::mbar_wait(vready0 + 8 * s, ph);
      sm90f32::named_sync(2 + f.cw);
      sm90::wgmma_fence();
      sm90::pin(phi);
      sm90::pin(plo);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        sm90f32::wgmma_tf32_rs<kCols>(ot, plo[j], vdesc(L::vt_hi(s), j), j > 0);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        sm90f32::wgmma_tf32_rs<kCols>(ot, phi[j], vdesc(L::vt_lo(s), j), 1);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        sm90f32::wgmma_tf32_rs<kCols>(ot, phi[j], vdesc(L::vt_hi(s), j), 1);
      sm90::wgmma_commit();
      sm90f32::named_arrive(3 - f.cw);
      sm90::wgmma_wait_all();
      sm90::pin(ot);
      sm90::pin(phi);
      sm90::pin(plo);
      __syncwarp();
      if (f.lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) o[i] += ot[i];
    }
    if (f.cw == 0 && n > 0) sm90f32::named_sync(2);

    // epilogue: O / l (a row with no keys gives zeros), m and l
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const bool ok0 = rt.q0 + f.r0 < p.Sq, ok1 = rt.q0 + f.r1 < p.Sq;
    const long rs = (long)p.H * D;
    float* o0 = p.o + ((long)rt.b * p.Sq + rt.q0 + f.r0) * rs + (long)rt.h * D +
                c0 + 2 * f.t4;
    float* o1 = o0 + 8 * rs;
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j) {
      if (ok0)
        *reinterpret_cast<float2*>(o0 + 8 * j) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (ok1)
        *reinterpret_cast<float2*>(o1 + 8 * j) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (p.m != nullptr && c0 == 0 && f.t4 == 0) {
      const long ml = (long)rt.bh * p.Sq + rt.q0;
      if (ok0) {
        p.m[ml + f.r0] = m0;
        p.l[ml + f.r0] = l0;
      }
      if (ok1) {
        p.m[ml + f.r1] = m1;
        p.l[ml + f.r1] = l1;
      }
    }
  }
}

// ------------------------------------------------------------ host side

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lens, float* o, float* m, float* l, int B,
                   int Sq, int Sk, int H, float scale, int chunk_tiles,
                   void* scratch, long long scratch_size, cudaStream_t stream) {
  static_assert(D % kCols == 0 && D % kDepth == 0, "whole column and depth tiles");
  const long long qtiles = (Sq + kRows - 1) / kRows;
  const long long ntiles = qtiles * B * H;
  const int nkt = score_tiles(Sk);
  if (ntiles < 1 || ntiles > 0x7fffffffLL || chunk_tiles < 1 ||
      scratch == nullptr || scratch_size < scratch_bytes(Sk, chunk_tiles) ||
      (long long)chunk_tiles * nkt > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // 4D maps (D, H, S, B): a ragged last tile of a batch row is zero-filled
  const uint64_t e = sizeof(float);
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)(Sk > 0 ? Sk : 1),
                          (uint64_t)B};
  const uint64_t sq[3] = {D * e, H * D * e, (uint64_t)Sq * H * D * e};
  const uint64_t sk[3] = {D * e, H * D * e, (uint64_t)Sk * H * D * e};
  const uint32_t bqk[4] = {(uint32_t)kDepth, 1, (uint32_t)kRows, 1};
  const uint32_t bv[4] = {(uint32_t)kCols, 1, (uint32_t)kKeys, 1};
  const long s_ld = (long)nkt * kScoreKeys;
  const uint64_t ds[2] = {(uint64_t)s_ld, (uint64_t)chunk_tiles * kRows};
  const uint64_t ss[1] = {(uint64_t)s_ld * e};
  const uint32_t bs[2] = {(uint32_t)kKeys, (uint32_t)kRows};
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv, ts;
  cudaError_t err = sm90::make_map(&tq, q, 4, dq, sq, bqk, 128, f32);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, 4, dk, sk, bqk, 128, f32);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, 4, dk, sk, bv, 0, f32);
  if (err == cudaSuccess) err = sm90::make_map(&ts, scratch, 2, ds, ss, bs, 128, f32);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_f32_scores_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)ScoreLayout::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_f32_pv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)PVLayout::bytes);
  if (err != cudaSuccess) return err;
  Params p{};
  p.kv_lens = kv_lens;
  p.s = static_cast<float*>(scratch);
  p.part = reinterpret_cast<float2*>(p.s + (long)chunk_tiles * kRows * s_ld);
  p.o = o;
  p.m = m;
  p.l = l;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.qtiles = (int)qtiles;
  p.nkt = nkt;
  p.s_ld = s_ld;
  p.scale = scale;
  for (long long t0 = 0; t0 < ntiles; t0 += chunk_tiles) {
    const int tc = (int)std::min<long long>(chunk_tiles, ntiles - t0);
    p.t0 = (int)t0;
    fa_f32_scores_kernel<D><<<(unsigned)(tc * nkt), kThreads, ScoreLayout::bytes,
                              stream>>>(tq, tk, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fa_f32_pv_kernel<D><<<(unsigned)(tc * (D / kCols)), kThreads, PVLayout::bytes,
                          stream>>>(ts, tv, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace sm90f32w
