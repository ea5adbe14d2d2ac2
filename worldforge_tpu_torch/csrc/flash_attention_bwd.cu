// The backward pass of flash attention (kernel 1) for Hopper (sm_90a): bf16,
// head dim 64 or 128, dense, non-causal, per-batch kv length.
//
// The TPU kernel worldforge_tpu/ops/flash_attention.py::_fa_kernel
// (pallas_call at :124) has no backward of its own: the JAX package trains
// through ops/attention.py::attention (:40), whose gradient JAX takes by
// autodiff of the plain softmax attention. This file is that gradient for
// the forward of flash_attention.cu, from what the forward saved:
//   q, k, v [B, Sq|Sk, H, D] bf16, o and dO [B, Sq, H, D] bf16, m and l
//   [B, H, Sq] fp32 (the scaled scores' row max and the sum of exp(s - m)),
//   kv_lens [B] int32. Outputs dq, dk, dv in q's layout, bf16.
//     P  = exp(scale * Q K^T - m) / l              (fp32)
//     D  = rowsum(dO * O)                          (fp32, O as returned)
//     dV = P^T dO                                  (P rounded to bf16)
//     dP = dO V^T,  dS = P * (dP - D)
//     dK = scale * dS^T Q,  dQ = scale * dS K      (dS rounded to bf16)
//   Keys at or past kv_lens[b] get P = 0, so zero dK / dV; a key tile that
//   lies wholly past kv_lens[b] is skipped (its dK / dV written as zeros);
//   a batch row with kv_len = 0 (output zeros) gets zero dQ.
//
// What bounds it on the H100: operations. The least work is five products
// of 2 * Sq * Sk * D * H flops each (S, dP, dV, dK, dQ): 21.06 TFLOP at the
// Wan2.1-14B 480p self-attention (20,280 tokens, 40 heads of 128), 21.29 ms
// at 989 TFLOP/s, against 1.5 GB of q, k, v, o, dO and the three gradients.
// This design computes exactly those five. Each (key tile, query tile) pair
// computes S and dP once, so no block owns a row of dQ: every key tile adds
// its dS K into an fp32 dQ accumulator [B, Sq, H, D], and a cast pass
// writes bf16 dq. Those additions arrive in an order that changes from run
// to run, so dq's last bits do too; dk and dv stay deterministic. The
// additions are 32 KB per (key tile, query tile), 66 GB through L2 at the
// 14B shape. What the kernel pays most for beyond its products is staging
// them in shared memory for the TMA unit: the S, dP and dQ products read
// both operands from shared memory, near its bandwidth, so every other
// store there costs time.
//   * bwd_prep: one warp per query row computes D and lse2 = (m + ln l)
//     log2 e (padded to a multiple of 64 rows: D = 0, lse2 = +inf) and
//     zeroes the row's dQ accumulator.
//   * bwd_main: one block per (128-key tile, b*h, query split), 384
//     threads, the forward's warp-specialised shape (attention_sm90.cuh). A
//     producer warp (setmaxnreg.dec) loads K and V once by TMA and streams
//     64-query tiles of Q and dO (128-byte swizzle) with their lse2 and D
//     (bulk copies) through a ring of kStages stages, full / empty
//     mbarriers. Two consumer warpgroups (setmaxnreg.inc) own 64 keys each
//     and per query tile compute, with wgmma:
//       S^T = K Q^T, dP^T = V dO^T   (shared A and B, both K-major)
//       P^T = exp2(S^T scale log2 e - lse2), dS^T = P^T (dP^T - D)
//       dV += P^T dO, dK += dS^T Q   (P^T / dS^T in bf16 registers as A;
//                                     dO / Q MN-major via the transpose bit)
//     dS^T goes to shared memory in bf16 (double-buffered, one named
//     barrier between the two warpgroups a tile), and each warpgroup
//     computes half of dQ's columns, dQ = dS K over all 128 keys (A = dS^T
//     and B = K, both through the transpose bit). It writes them to an fp32
//     staging tile in shared memory and one thread has the TMA unit add the
//     tile into the accumulator (cp.reduce.async.bulk.tensor, rows past Sq
//     dropped by the tensor map). dK (x scale) and dV stay in registers for
//     the whole walk and are written once.
//   * Short kv: (key tiles x B*H) blocks fill 132 SMs badly (4 x 40 at the
//     text cross-attention's 512 keys: two waves, the second of 28), so the
//     host plan (ops/flash_attention.py::_bwd_plan) splits the query walk
//     where that takes fewer waves per walk; each split writes fp32 dK / dV
//     partials [splits, B, Sk, H, D] and bwd_reduce sums them in a fixed
//     order (deterministic) into bf16 dk / dv.
//   * bwd_cast: dq = bf16(scale * accumulator).
//   Blocks are numbered on gridDim.x alone (limit 2^31 - 1); consecutive
//   blocks are one head's key tiles, so the blocks in flight share its Q,
//   dO and dQ accumulator in L2, and each starts its walk at another query
//   tile (key tile index modulo the split's tiles) so their dQ additions
//   land on different rows.
// Tried on the H100 and slower than this design: dQ added by float2 or
// float4 atomics from registers; each warpgroup adding a dQ partial over
// its own 64 keys (no barrier, twice the additions); a one-tile software
// pipeline (ptxas serialises its wgmma); a third ring stage.

#include "sm90_common.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 128;      // keys per block
constexpr int kQ = 64;          // queries per tile of the walk
constexpr int kStages = 2;      // Q / dO ring depth
constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kPanel = 64;      // bf16 columns per 128-byte swizzled row

// Dynamic shared memory (1024-byte aligned): K and V (D / 64 panels of 128
// rows x 128 bytes), the stages' Q and dO (panels of 64 rows), two dS^T
// buffers (128 keys x 64 queries), each consumer warpgroup's fp32 dQ tile,
// each stage's lse2[64] and D[64], then the mbarriers.
template <int D>
struct Smem {
  static constexpr int panels = D / kPanel;
  static constexpr uint32_t kv_panel = kKeys * 128;
  static constexpr uint32_t q_panel = kQ * 128;
  static constexpr uint32_t kv_tile = panels * kv_panel;
  static constexpr uint32_t q_tile = panels * q_panel;
  static constexpr uint32_t k = 0, v = kv_tile;
  __host__ __device__ static constexpr uint32_t q(int s) {
    return 2 * kv_tile + s * 2 * q_tile;
  }
  __host__ __device__ static constexpr uint32_t dO(int s) {
    return q(s) + q_tile;
  }
  static constexpr uint32_t ds_bytes = kKeys * kQ * 2;
  static constexpr uint32_t ds = 2 * kv_tile + kStages * 2 * q_tile;
  // a consumer warpgroup's fp32 dQ tile, [D / 64] boxes of 64 rows x 32
  // columns (128-byte rows, 128-byte swizzle), the TMA reduce's source
  static constexpr uint32_t dq_box = kQ * 128;
  static constexpr uint32_t dq_wg = (D / 64) * dq_box;
  static constexpr uint32_t dq = ds + 2 * ds_bytes;
  static constexpr uint32_t vec = dq + 2 * dq_wg;
  static constexpr uint32_t bars = vec + kStages * 2 * kQ * 4;
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
};

struct BwdParams {
  const int* kv_lens;
  const float* delta;     // [B*H, Sqp]
  const float* lse2;      // [B*H, Sqp]
  float* dq_acc;          // [B, Sq, H, D] fp32
  __nv_bfloat16* dk;      // splits == 1: bf16 dk / dv
  __nv_bfloat16* dv;
  float* dk_part;         // splits > 1: [splits, B, Sk, H, D] fp32
  float* dv_part;
  int B, Sq, Sqp, Sk, H, ktiles, splits, qper;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// dQ tile += shared memory, by the TMA unit: a 4D box (32 fp32 columns,
// 1 head, 64 rows, 1 batch row) added into global memory, rows past the
// tensor's end dropped.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile"
      ".bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Returns once this thread's bulk operations have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Returns once this thread's bulk operations are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One consumer warpgroup's 128 threads meet (named barrier 2 + cw).
__device__ __forceinline__ void warpgroup_sync(int cw) {
  if (cw == 0)
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
}

// The two consumer warpgroups meet (named barrier 1, 256 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Makes this thread's generic-proxy shared-memory writes visible to wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64 x 64] (+)= A . B from shared memory; TA / TB: the operand is
// MN-major (transpose bit) rather than K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// dQ's product for one warpgroup: N = D / 2 columns, both operands MN-major.
template <int N>
__device__ __forceinline__ void wgmma_dq(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_dq<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64<1, 1>(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_dq<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n32<1, 1>(d, da, db, scale_d);
}

// ------------------------------------------------------------- prep

// One warp per padded query row r = bh * Sqp + i: D = sum(dO * O), lse2 =
// (m + ln l) log2 e, and zeros into the row's dQ accumulator; rows i >= Sq
// get D = 0, lse2 = +inf (their P is 0).
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep(const __nv_bfloat16* __restrict__ o,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ m, const float* __restrict__ l,
         float* __restrict__ delta, float* __restrict__ lse2,
         float* __restrict__ dq_acc, int Sq, int Sqp, int H, long rows) {
  const long r = (long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const long bh = r / Sqp;
  const int i = (int)(r % Sqp);
  if (i >= Sq) {
    if (lane == 0) {
      delta[r] = 0.f;
      lse2[r] = INFINITY;
    }
    return;
  }
  const long b = bh / H, h = bh % H;
  const long off = ((b * Sq + i) * H + h) * D;
  float s = 0.f;
#pragma unroll
  for (int c = lane * 2; c < D; c += 64) {
    const __nv_bfloat162 ov =
        *reinterpret_cast<const __nv_bfloat162*>(o + off + c);
    const __nv_bfloat162 dv =
        *reinterpret_cast<const __nv_bfloat162*>(dout + off + c);
    s += __bfloat162float(ov.x) * __bfloat162float(dv.x) +
         __bfloat162float(ov.y) * __bfloat162float(dv.y);
  }
#pragma unroll
  for (int c = lane * 4; c < D; c += 128)
    *reinterpret_cast<float4*>(dq_acc + off + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const long ml = bh * Sq + i;
    delta[r] = s;
    const float lv = l[ml];
    lse2[r] = lv > 0.f ? (m[ml] + logf(lv)) * kLog2e : INFINITY;
  }
}

// ------------------------------------------------------------- main

// Rows [key0, key0 + 128) of dK / dV, as written by a block that computes
// nothing (a tile past kv_len, or an empty split): zeros.
template <int D>
__device__ void write_zero_tile(const BwdParams& p, int split, int b, int h,
                                int key0) {
  const int rows = min(kKeys, p.Sk - key0);
  const long rs = (long)p.H * D;
  const long first = ((long)b * p.Sk + key0) * rs + (long)h * D;
  if (p.splits == 1) {
    for (int i = threadIdx.x; i < rows * D / 8; i += kThreads) {
      const long at = first + (i / (D / 8)) * rs + (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(p.dk + at) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(p.dv + at) = make_uint4(0, 0, 0, 0);
    }
  } else {
    const long part = (long)split * p.B * p.Sk * rs;
    for (int i = threadIdx.x; i < rows * D / 4; i += kThreads) {
      const long at = part + first + (i / (D / 4)) * rs + (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(p.dk_part + at) =
          make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(p.dv_part + at) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_main(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const __grid_constant__ CUtensorMap tdo,
         const __grid_constant__ CUtensorMap tdq, const BwdParams p) {
  using L = Smem<D>;
  constexpr int NH = D / 2;                 // dQ columns of one warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full0 = base + L::bars;          // full[s] = full0 + 8s
  const uint32_t empty0 = full0 + 8 * kStages;    // empty[s] = empty0 + 8s
  const uint32_t kvbar = empty0 + 8 * kStages;

  const int kt = blockIdx.x % p.ktiles;
  const int rest = blockIdx.x / p.ktiles;
  const int split = rest % p.splits;
  const int bh = rest / p.splits;
  const int b = bh / p.H, h = bh % p.H;
  const int key0 = kt * kKeys;
  const int kv_len = max(0, min(p.kv_lens[b], p.Sk));
  const int qtiles = (p.Sq + kQ - 1) / kQ;
  const int t0 = split * p.qper;
  const int nt = max(0, min(qtiles, t0 + p.qper) - t0);
  if (key0 >= kv_len || nt == 0) {
    write_zero_tile<D>(p, split, b, h, key0);
    return;
  }
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * L::kv_tile);
#pragma unroll
      for (int c = 0; c < L::panels; ++c) {
        tma_load_4d(base + L::k + c * L::kv_panel, &tk, kvbar, c * kPanel, h,
                    key0, b);
        tma_load_4d(base + L::v + c * L::kv_panel, &tv, kvbar, c * kPanel, h,
                    key0, b);
      }
      const float* lrow = p.lse2 + (long)bh * p.Sqp;
      const float* drow = p.delta + (long)bh * p.Sqp;
      for (int i = 0; i < nt; ++i) {
        const int s = i % kStages;
        mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
        const int q0 = (t0 + (i + kt) % nt) * kQ;
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * L::q_tile + 2 * kQ * 4);
#pragma unroll
        for (int c = 0; c < L::panels; ++c) {
          tma_load_4d(base + L::q(s) + c * L::q_panel, &tq, bar, c * kPanel,
                      h, q0, b);
          tma_load_4d(base + L::dO(s) + c * L::q_panel, &tdo, bar,
                      c * kPanel, h, q0, b);
        }
        const uint32_t vec = base + L::vec + s * 2 * kQ * 4;
        bulk_load(vec, lrow + q0, kQ * 4, bar);
        bulk_load(vec + kQ * 4, drow + q0, kQ * 4, bar);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                     // keys 64cw .. 64cw + 63
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float c2 = p.scale * kLog2e;
    const int r0 = 64 * cw + 16 * warp + g;    // this thread's key rows
    const bool kok0 = key0 + r0 < kv_len;
    const bool kok1 = key0 + r0 + 8 < kv_len;
    const long rs = (long)p.H * D;
    // this warpgroup's dQ columns: a 64-column panel of K at d = 128, half
    // of the one panel at d = 64
    const uint32_t kcol = D == 128 ? cw * L::kv_panel : cw * NH * 2;

    float dv[D / 2], dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int i = 0; i < nt; ++i) {
      const int s = i % kStages;
      const int q0 = (t0 + (i + kt) % nt) * kQ;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      const uint32_t qs = base + L::q(s), os = base + L::dO(s);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, D / 16 steps
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * L::kv_panel + cw * 64 * 128 +
                           (kk % 4) * 32;
        const uint32_t bq = (kk / 4) * L::q_panel + (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(st, smem_desc(base + L::k + a, 16, 1024),
                           smem_desc(qs + bq, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * L::kv_panel + cw * 64 * 128 +
                           (kk % 4) * 32;
        const uint32_t bq = (kk / 4) * L::q_panel + (kk % 4) * 32;
        wgmma_ss_n64<0, 0>(dpt, smem_desc(base + L::v + a, 16, 1024),
                           smem_desc(os + bq, 16, 1024), kk > 0);
      }
      wgmma_commit();

      // element (j, e): key row r0 (+8 for e >= 2), query 8j + 2 t4 + (e&1)
      const float* vec =
          reinterpret_cast<const float*>(gbase + L::vec + s * 2 * kQ * 4);
      wgmma_wait<1>();
      pin(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 ls =
            *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t4);
        st[4 * j] = kok0 ? ex2(fmaf(st[4 * j], c2, -ls.x)) : 0.f;
        st[4 * j + 1] = kok0 ? ex2(fmaf(st[4 * j + 1], c2, -ls.y)) : 0.f;
        st[4 * j + 2] = kok1 ? ex2(fmaf(st[4 * j + 2], c2, -ls.x)) : 0.f;
        st[4 * j + 3] = kok1 ? ex2(fmaf(st[4 * j + 3], c2, -ls.y)) : 0.f;
      }
      wgmma_wait<0>();
      pin(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(vec + kQ + 8 * j + 2 * t4);
        dpt[4 * j] = st[4 * j] * (dpt[4 * j] - dl.x);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - dl.y);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - dl.x);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - dl.y);
      }
      // P^T and dS^T in bf16 as wgmma A operands: k-step kk covers queries
      // 16kk .. 16kk + 15
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
          sa[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        }
      // dS^T to shared memory: row = key (128 bytes of 64 queries), the
      // 16-byte chunk j of a row at j ^ (row % 8) (the 128-byte swizzle)
      const uint32_t dsb = L::ds + (i & 1) * L::ds_bytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t cj = ((j ^ g) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(gbase + dsb + r0 * 128 + cj) =
            sa[j / 2][(j % 2) * 2];
        *reinterpret_cast<uint32_t*>(gbase + dsb + (r0 + 8) * 128 + cj) =
            sa[j / 2][(j % 2) * 2 + 1];
      }

      // dV += P^T dO, dK += dS^T Q: B [64 queries, D] MN-major; a k-step is
      // 16 query rows (2048 bytes), the next 64 columns the next panel
      pin(dv);
      pin(dk);
      pin(pa);
      pin(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dv, pa[kk],
                    smem_desc(os + kk * 2048, L::q_panel, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(dk, sa[kk],
                    smem_desc(qs + kk * 2048, L::q_panel, 1024));
      wgmma_commit();

      // dQ[:, this warpgroup's columns] = dS K over the block's 128 keys:
      // A = dS^T [keys][queries] MN-major, B = K [keys][D] MN-major
      fence_async_shared();
      if (tid == 0) bulk_wait_read();   // the previous dQ tile has been read
      consumers_sync();
      float dq[NH / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_dq<NH>(dq, smem_desc(base + dsb + kk * 2048, L::ds_bytes, 1024),
                     smem_desc(base + L::k + kcol + kk * 2048, L::kv_panel,
                               1024),
                     kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      pin(pa);
      pin(sa);
      pin(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);

      // dQ into the staging tile (box j / 4 holds columns 8j .. 8j + 7 of
      // 32; the 16-byte chunk c of row r at c ^ (r % 8)), then one thread
      // has the TMA unit add it into the fp32 accumulator
      const uint32_t dqt = L::dq + cw * L::dq_wg;
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const uint32_t chunk = 2 * (j % 4) + t4 / 2;
        const uint32_t at = dqt + (j / 4) * L::dq_box + ((chunk ^ g) << 4) +
                            8 * (t4 & 1);
        *reinterpret_cast<float2*>(gbase + at + (16 * warp + g) * 128) =
            make_float2(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(gbase + at + (16 * warp + g + 8) * 128) =
            make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
      fence_async_shared();
      warpgroup_sync(cw);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < NH / 32; ++bx)
          tma_reduce_add_4d(&tdq, base + dqt + bx * L::dq_box,
                            NH * cw + 32 * bx, h, q0, b);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait();

    // dK (x scale) and dV, written once: key rows key0 + r0 (+8)
    const int ka = key0 + r0, kb = ka + 8;
    const long at = ((long)b * p.Sk + ka) * rs + (long)h * D + 2 * t4;
    if (p.splits == 1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (ka < p.Sk) {
          *reinterpret_cast<__nv_bfloat162*>(p.dk + at + 8 * j) =
              __floats2bfloat162_rn(dk[4 * j] * p.scale,
                                    dk[4 * j + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(p.dv + at + 8 * j) =
              __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
        }
        if (kb < p.Sk) {
          *reinterpret_cast<__nv_bfloat162*>(p.dk + at + 8 * rs + 8 * j) =
              __floats2bfloat162_rn(dk[4 * j + 2] * p.scale,
                                    dk[4 * j + 3] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(p.dv + at + 8 * rs + 8 * j) =
              __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
        }
      }
    } else {
      const long pa0 = (long)split * p.B * p.Sk * rs + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (ka < p.Sk) {
          *reinterpret_cast<float2*>(p.dk_part + pa0 + 8 * j) =
              make_float2(dk[4 * j], dk[4 * j + 1]);
          *reinterpret_cast<float2*>(p.dv_part + pa0 + 8 * j) =
              make_float2(dv[4 * j], dv[4 * j + 1]);
        }
        if (kb < p.Sk) {
          *reinterpret_cast<float2*>(p.dk_part + pa0 + 8 * rs + 8 * j) =
              make_float2(dk[4 * j + 2], dk[4 * j + 3]);
          *reinterpret_cast<float2*>(p.dv_part + pa0 + 8 * rs + 8 * j) =
              make_float2(dv[4 * j + 2], dv[4 * j + 3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- finish

// dq = bf16(scale * accumulator), four values a thread-step.
__global__ void __launch_bounds__(256)
bwd_cast(const float4* __restrict__ acc, uint2* __restrict__ dq, long n4,
         float scale) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const float4 a = acc[i];
    dq[i] = make_uint2(pack_bf16(a.x * scale, a.y * scale),
                       pack_bf16(a.z * scale, a.w * scale));
  }
}

// dk = bf16(scale * sum of the splits' partials), dv = bf16(sum), the
// splits added in order.
__global__ void __launch_bounds__(256)
bwd_reduce(const float4* __restrict__ pk, const float4* __restrict__ pv,
           uint2* __restrict__ dk, uint2* __restrict__ dv, long n4,
           int splits, float scale) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 a = pk[i], c = pv[i];
    for (int s = 1; s < splits; ++s) {
      const float4 x = pk[s * n4 + i], y = pv[s * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
    }
    dk[i] = make_uint2(pack_bf16(a.x * scale, a.y * scale),
                       pack_bf16(a.z * scale, a.w * scale));
    dv[i] = make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
}

unsigned grid_for(long n4) {
  const long blocks = (n4 + 255) / 256;
  return (unsigned)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* m, const float* l,
                   const int* kv_lens, void* dq, void* dk, void* dv,
                   float* delta, float* lse2, float* dq_acc, float* dk_part,
                   float* dv_part, int B, int Sq, int Sk, int H, int splits,
                   int qper, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int Sqp = (Sq + kQ - 1) / kQ * kQ;
  const int qtiles = Sqp / kQ;
  const int ktiles = (Sk + kKeys - 1) / kKeys;
  const long rows = (long)B * H * Sqp;
  const long blocks = (long)ktiles * B * H * splits;
  if (splits < 1 || qper < 1 || (long)splits * qper < qtiles ||
      (qtiles > 0 && (long)(splits - 1) * qper >= qtiles) ||
      (splits > 1 && (dk_part == nullptr || dv_part == nullptr)) ||
      (rows + 7) / 8 > 0x7fffffffL || blocks > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (rows > 0) {
    bwd_prep<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), m, l, delta,
        lse2, dq_acc, Sq, Sqp, H, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (blocks > 0) {
    // 4D maps (D, H, S, B): a ragged tile's rows past S are zero-filled
    const uint64_t e = sizeof(bf);
    const uint64_t dims_q[4] = {(uint64_t)D, (uint64_t)H,
                                (uint64_t)(Sq > 0 ? Sq : 1), (uint64_t)B};
    const uint64_t dims_k[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Sk,
                                (uint64_t)B};
    const uint64_t st_q[3] = {D * e, H * D * e, (uint64_t)Sq * H * D * e};
    const uint64_t st_k[3] = {D * e, H * D * e, (uint64_t)Sk * H * D * e};
    const uint32_t box_q[4] = {kPanel, 1, kQ, 1};
    const uint32_t box_k[4] = {kPanel, 1, kKeys, 1};
    const uint64_t st_acc[3] = {D * 4ull, H * D * 4ull,
                                (uint64_t)Sq * H * D * 4};
    const uint32_t box_acc[4] = {32, 1, kQ, 1};
    CUtensorMap tq, tk, tv, tdo, tdq;
    err = make_map(&tq, q, 4, dims_q, st_q, box_q, 128);
    if (err == cudaSuccess)
      err = make_map(&tdq, dq_acc, 4, dims_q, st_acc, box_acc, 128,
                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (err == cudaSuccess)
      err = make_map(&tdo, dout, 4, dims_q, st_q, box_q, 128);
    if (err == cudaSuccess)
      err = make_map(&tk, k, 4, dims_k, st_k, box_k, 128);
    if (err == cudaSuccess)
      err = make_map(&tv, v, 4, dims_k, st_k, box_k, 128);
    if (err != cudaSuccess) return err;
    BwdParams p{};
    p.kv_lens = kv_lens;
    p.delta = delta;
    p.lse2 = lse2;
    p.dq_acc = dq_acc;
    p.dk = static_cast<bf*>(dk);
    p.dv = static_cast<bf*>(dv);
    p.dk_part = dk_part;
    p.dv_part = dv_part;
    p.B = B;
    p.Sq = Sq;
    p.Sqp = Sqp;
    p.Sk = Sk;
    p.H = H;
    p.ktiles = ktiles;
    p.splits = splits;
    p.qper = qper;
    p.scale = scale;
    const size_t bytes = Smem<D>::bytes;
    err = cudaFuncSetAttribute(bwd_main<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    bwd_main<D><<<(unsigned)blocks, kThreads, bytes, stream>>>(tq, tk, tv,
                                                                tdo, tdq, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long nq4 = (long)B * Sq * H * D / 4;
  if (nq4 > 0) {
    bwd_cast<<<grid_for(nq4), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), nq4,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long nk4 = (long)B * Sk * H * D / 4;
  if (splits > 1 && nk4 > 0) {
    bwd_reduce<<<grid_for(nk4), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(dk_part),
        reinterpret_cast<const float4*>(dv_part), static_cast<uint2*>(dk),
        static_cast<uint2*>(dv), nk4, splits, scale);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// bf16 only; D = 64 or 128. delta and lse2 are [B, H, Sqp] fp32 scratch
// (Sqp = Sq rounded up to 64), dq_acc [B, Sq, H, D] fp32 scratch; with
// splits > 1, dk_part and dv_part are [splits, B, Sk, H, D] fp32 scratch
// (null otherwise). The query walk of split s is tiles [s qper, (s + 1)
// qper) of 64 queries. Returns cudaGetLastError() after the last launch;
// cudaErrorInvalidValue for a head dim that has no instantiation, a split
// plan that does not cover the query tiles once, or a grid past 2^31 - 1
// blocks.
int wf_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* m,
                           const void* l, const void* kv_lens, void* dq,
                           void* dk, void* dv, void* delta, void* lse2,
                           void* dq_acc, void* dk_part, void* dv_part, int B,
                           int Sq, int Sk, int H, int D, int splits, int qper,
                           float scale, void* stream) {
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const int* kl = static_cast<const int*>(kv_lens);
  float* dp = static_cast<float*>(delta);
  float* lsp = static_cast<float*>(lse2);
  float* acc = static_cast<float*>(dq_acc);
  float* pk = static_cast<float*>(dk_part);
  float* pv = static_cast<float*>(dv_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, mp, lp, kl, dq, dk, dv, dp, lsp, acc,
                      pk, pv, B, Sq, Sk, H, splits, qper, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, mp, lp, kl, dq, dk, dv, dp, lsp, acc,
                       pk, pv, B, Sq, Sk, H, splits, qper, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tiles the plan must be cut to: kKeys keys per block, kQ queries per
// tile of the walk (ops/flash_attention.py checks its plan against them).
void wf_flash_attention_bwd_tiles(int* key_tile, int* q_tile) {
  *key_tile = kKeys;
  *q_tile = kQ;
}

const char* wf_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
