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
// Wan2.1-14B 480p self-attention (20,280 tokens, 40 heads of 128), 21.3 ms
// at 989 TFLOP/s, against 1.5 GB of q, k, v, o, dO and the three gradients.
// This first design is plain and deterministic, with no atomics:
//   * bwd_prep: one warp per query row computes D and lse = m + log(l).
//   * bwd_dkdv: one block per (64-key tile, b*h), four warps of 16 keys
//     each. K and V stay in shared memory; the block walks every 32-query
//     tile (Q, dO, lse and D double-buffered with cp.async), computes
//     S^T = K Q^T and dP^T = V dO^T, and accumulates dV and dK in fp32
//     registers (16 keys x D per warp).
//   * bwd_dq: one block per (64-query tile, b*h), four warps of 16 queries;
//     it walks the key tiles below kv_len (K and V double-buffered) and
//     recomputes S, P, dP and dS to accumulate dQ in registers.
//   S and dP are computed in both kernels: seven products, not five, which
//   is the price of writing dQ once from one block instead of adding it
//   from every key tile with fp32 atomics (whose order, and so whose last
//   bits, change from run to run). All products are mma.sync m16n8k16 bf16
//   with fp32 sums, operands loaded with ldmatrix (.trans where the tile is
//   stored k-major: dO and Q for dV / dK, K for dQ); rows are padded by 16
//   bytes so the eight row addresses of an ldmatrix hit distinct banks.
//   Blocks are numbered on gridDim.x alone (limit 2^31 - 1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;   // four warps
constexpr int kKT = 64;         // keys per tile (dK/dV block and dQ loop)
constexpr int kQT = 32;         // queries per tile of the dK/dV loop
constexpr int kQB = 64;         // queries per dQ block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Shared tiles: rows of D bf16 padded by 8 (16 bytes).
template <int D>
struct Tile {
  static constexpr int LD = D + 8;
};

// Stage `rows` rows of D bf16 (global row stride `gs` elements) into shared
// memory; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int rows,
                                      int valid, long gs) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * Tile<D>::LD + c, src + (long)(ok ? r : 0) * gs + c,
               ok);
  }
}

// The 16-row A fragment at (row r0, column k0) of a row-major tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int r0, int k0,
                                       int lane) {
  ldsm_x4(a, t + (r0 + (lane % 16)) * Tile<D>::LD + k0 + (lane / 16) * 8);
}

// B fragments of n-blocks n0 and n0 + 8 at k-step k0 from a tile stored
// [n][k] (b[0], b[1] for n0; b[2], b[3] for n0 + 8).
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int n0,
                                          int k0, int lane) {
  ldsm_x4(b, t + (n0 + (lane % 8) + (lane / 16) * 8) * Tile<D>::LD + k0 +
                 ((lane / 8) % 2) * 8);
}

// The same from a tile stored [k][n], through the transposing load.
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* t, int k0,
                                          int n0, int lane) {
  ldsm_x4_t(b, t + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * Tile<D>::LD +
                   n0 + (lane / 16) * 8);
}

// ------------------------------------------------------------- prep

// One warp per query row (bh, i): D = sum(dO * O), lse2 = (m + ln l) log2 e.
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep(const __nv_bfloat16* __restrict__ o,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ m, const float* __restrict__ l,
         float* __restrict__ delta, float* __restrict__ lse2, int Sq, int H,
         long rows) {
  const long r = (long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const long bh = r / Sq;
  const int i = (int)(r % Sq);
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
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    delta[r] = s;
    const float lv = l[r];
    lse2[r] = lv > 0.f ? (m[r] + logf(lv)) * kLog2e : INFINITY;
  }
}

// ------------------------------------------------------------- dK / dV

template <int D>
struct DkdvSmem {
  static constexpr int LD = Tile<D>::LD;
  static constexpr int k = 0, v = kKT * LD, q = 2 * kKT * LD;
  static constexpr int dO = q + 2 * kQT * LD;          // 2 stages each
  static constexpr int elems = dO + 2 * kQT * LD;
  static constexpr size_t vec_off = sizeof(__nv_bfloat16) * elems;
  static constexpr size_t bytes = vec_off + sizeof(float) * 4 * kQT;
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ delta, const float* __restrict__ lse2,
         const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dk,
         __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float scale) {
  using L = DkdvSmem<D>;
  constexpr int NB = D / 8;       // n-blocks of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* vec = reinterpret_cast<float*>(smem_raw + L::vec_off);  // [2][2][QT]

  const int ktiles = (Sk + kKT - 1) / kKT;
  const long bh = blockIdx.x / ktiles;
  const int key0 = (blockIdx.x % ktiles) * kKT;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long rs = (long)H * D;
  const int kv_len = max(0, min(kv_lens[b], Sk));
  const int krows = min(kKT, Sk - key0);

  __nv_bfloat16* dk0 = dk + ((long)b * Sk + key0) * rs + (long)h * D;
  __nv_bfloat16* dv0 = dv + ((long)b * Sk + key0) * rs + (long)h * D;
  if (key0 >= kv_len) {   // every key of the tile is masked: zeros
    for (int i = threadIdx.x; i < krows * D / 2; i += kThreads) {
      const int r = i / (D / 2), c = (i % (D / 2)) * 2;
      const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(dk0 + r * rs + c) = z;
      *reinterpret_cast<__nv_bfloat162*>(dv0 + r * rs + c) = z;
    }
    return;
  }

  const __nv_bfloat16* qb = q + (long)b * Sq * rs + (long)h * D;
  const __nv_bfloat16* ob = dout + (long)b * Sq * rs + (long)h * D;
  const float* db = delta + bh * Sq;
  const float* lb = lse2 + bh * Sq;
  const int qtiles = (Sq + kQT - 1) / kQT;

  auto load_q_tile = [&](int t, int s) {
    const int q0 = t * kQT, valid = min(kQT, Sq - q0);
    stage<D>(sm + L::q + s * kQT * L::LD, qb + (long)q0 * rs, kQT, valid, rs);
    stage<D>(sm + L::dO + s * kQT * L::LD, ob + (long)q0 * rs, kQT, valid,
             rs);
    if (threadIdx.x < kQT) {
      const int i = threadIdx.x;
      float* dst = vec + s * 2 * kQT;
      dst[i] = i < valid ? db[q0 + i] : 0.f;
      dst[kQT + i] = i < valid ? lb[q0 + i] : INFINITY;
    }
  };

  stage<D>(sm + L::k, k + ((long)b * Sk + key0) * rs + (long)h * D, kKT,
           krows, rs);
  stage<D>(sm + L::v, v + ((long)b * Sk + key0) * rs + (long)h * D, kKT,
           krows, rs);
  load_q_tile(0, 0);
  cp_async_commit();

  float dka[NB][4], dva[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const float c2 = scale * kLog2e;
  const int kr = warp * 16;                 // this warp's keys in the tile
  const bool kok0 = key0 + kr + g < kv_len;
  const bool kok1 = key0 + kr + g + 8 < kv_len;

  for (int t = 0; t < qtiles; ++t) {
    const int s = t & 1;
    __syncthreads();                        // stage s^1 is free
    if (t + 1 < qtiles) load_q_tile(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                     // tile t (and K, V) landed
    __syncthreads();

    const __nv_bfloat16* Qs = sm + L::q + s * kQT * L::LD;
    const __nv_bfloat16* Os = sm + L::dO + s * kQT * L::LD;
    const float* dl = vec + s * 2 * kQT;    // [D | lse2] of the tile

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries (4 n-blocks)
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bq[4];
      load_a<D>(a, sm + L::k, kr, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        load_b_nk<D>(bq, Qs, j * 8, kk * 16, lane);
        mma(st[j], a, bq[0], bq[1]);
        mma(st[j + 1], a, bq[2], bq[3]);
      }
      load_a<D>(a, sm + L::v, kr, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        load_b_nk<D>(bq, Os, j * 8, kk * 16, lane);
        mma(dpt[j], a, bq[0], bq[1]);
        mma(dpt[j + 1], a, bq[2], bq[3]);
      }
    }
    // P^T and dS^T; element e of block j: key row g (+8 for e >= 2), query
    // column 8j + 2 t4 + (e & 1)
    uint32_t pa[2][4], sa[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const bool ok = e < 2 ? kok0 : kok1;
        p[e] = ok ? exp2f(fmaf(st[j][e], c2, -dl[kQT + col])) : 0.f;
        ds[e] = p[e] * (dpt[j][e] - dl[col]);
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      sa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dV += P^T dO, dK += dS^T Q: k = 32 queries (two steps), n = D
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bo[4];
        load_b_kn<D>(bo, Os, kk * 16, n * 8, lane);
        mma(dva[n], pa[kk], bo[0], bo[1]);
        mma(dva[n + 1], pa[kk], bo[2], bo[3]);
        load_b_kn<D>(bo, Qs, kk * 16, n * 8, lane);
        mma(dka[n], sa[kk], bo[0], bo[1]);
        mma(dka[n + 1], sa[kk], bo[2], bo[3]);
      }
    }
  }
  cp_async_wait<0>();

  const int r0 = kr + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int c = 8 * n + 2 * t4;
    if (r0 < krows) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + r0 * rs + c) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + r0 * rs + c) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (r1 < krows) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + r1 * rs + c) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + r1 * rs + c) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// ------------------------------------------------------------- dQ

template <int D>
struct DqSmem {
  static constexpr int LD = Tile<D>::LD;
  static constexpr int q = 0, dO = kQB * LD, k = 2 * kQB * LD;
  static constexpr int v = k + 2 * kKT * LD;            // 2 stages each
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (v + 2 * kKT * LD);
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const __nv_bfloat16* __restrict__ q,
       const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v,
       const __nv_bfloat16* __restrict__ dout,
       const float* __restrict__ delta, const float* __restrict__ lse2,
       const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ dq,
       int Sq, int Sk, int H, float scale) {
  using L = DqSmem<D>;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int qtiles = (Sq + kQB - 1) / kQB;
  const long bh = blockIdx.x / qtiles;
  const int q0 = (blockIdx.x % qtiles) * kQB;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long rs = (long)H * D;
  const int kv_len = max(0, min(kv_lens[b], Sk));
  const int ntiles = (kv_len + kKT - 1) / kKT;
  const int qrows = min(kQB, Sq - q0);
  const __nv_bfloat16* kb = k + (long)b * Sk * rs + (long)h * D;
  const __nv_bfloat16* vb = v + (long)b * Sk * rs + (long)h * D;

  auto load_kv_tile = [&](int t, int s) {
    const int k0 = t * kKT, valid = min(kKT, Sk - k0);
    stage<D>(sm + L::k + s * kKT * L::LD, kb + (long)k0 * rs, kKT, valid,
             rs);
    stage<D>(sm + L::v + s * kKT * L::LD, vb + (long)k0 * rs, kKT, valid,
             rs);
  };

  if (ntiles > 0) {
    const long qoff = ((long)b * Sq + q0) * rs + (long)h * D;
    stage<D>(sm + L::q, q + qoff, kQB, qrows, rs);
    stage<D>(sm + L::dO, dout + qoff, kQB, qrows, rs);
    load_kv_tile(0, 0);
  }
  cp_async_commit();

  const int qr = warp * 16;
  const int i0 = q0 + qr + g, i1 = i0 + 8;
  const float c2 = scale * kLog2e;
  const float d0 = i0 < Sq ? delta[bh * Sq + i0] : 0.f;
  const float d1 = i1 < Sq ? delta[bh * Sq + i1] : 0.f;
  const float l0 = i0 < Sq ? lse2[bh * Sq + i0] : INFINITY;
  const float l1 = i1 < Sq ? lse2[bh * Sq + i1] : INFINITY;

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    __syncthreads();                        // stage s^1 is free
    if (t + 1 < ntiles) load_kv_tile(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Ks = sm + L::k + s * kKT * L::LD;
    const __nv_bfloat16* Vs = sm + L::v + s * kKT * L::LD;

    // S = Q K^T, dP = dO V^T: 16 queries x 64 keys (8 n-blocks)
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      load_a<D>(a, sm + L::q, qr, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        load_b_nk<D>(bk, Ks, j * 8, kk * 16, lane);
        mma(sc[j], a, bk[0], bk[1]);
        mma(sc[j + 1], a, bk[2], bk[3]);
      }
      load_a<D>(a, sm + L::dO, qr, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        load_b_nk<D>(bk, Vs, j * 8, kk * 16, lane);
        mma(dp[j], a, bk[0], bk[1]);
        mma(dp[j + 1], a, bk[2], bk[3]);
      }
    }
    // dS in the A-operand layout: k-step kk covers keys 16kk .. 16kk + 15
    const int key0 = t * kKT;
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + 8 * j + 2 * t4 + (e & 1) < kv_len;
        const float p =
            ok ? exp2f(fmaf(sc[j][e], c2, -(e < 2 ? l0 : l1))) : 0.f;
        ds[e] = p * (dp[j][e] - (e < 2 ? d0 : d1));
      }
      sa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K: k = 64 keys (four steps), n = D
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bk[4];
        load_b_kn<D>(bk, Ks, kk * 16, n * 8, lane);
        mma(acc[n], sa[kk], bk[0], bk[1]);
        mma(acc[n + 1], sa[kk], bk[2], bk[3]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* o0 = dq + ((long)b * Sq + i0) * rs + (long)h * D;
  __nv_bfloat16* o1 = dq + ((long)b * Sq + i1) * rs + (long)h * D;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int c = 8 * n + 2 * t4;
    if (i0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (i1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + c) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* m, const float* l,
                   const int* kv_lens, void* dq, void* dk, void* dv,
                   float* delta, float* lse2, int B, int Sq, int Sk, int H,
                   float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const long rows = (long)B * H * Sq;
  const long kblocks = (long)((Sk + kKT - 1) / kKT) * B * H;
  const long qblocks = (long)((Sq + kQB - 1) / kQB) * B * H;
  if ((rows + 7) / 8 > 0x7fffffffL || kblocks > 0x7fffffffL ||
      qblocks > 0x7fffffffL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DkdvSmem<D>::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DqSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  if (rows > 0) {
    bwd_prep<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), m, l, delta,
        lse2, Sq, H, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (kblocks > 0) {
    bwd_dkdv<D><<<(unsigned)kblocks, kThreads, DkdvSmem<D>::bytes, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), delta, lse2,
        kv_lens, static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, H,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (qblocks > 0) {
    bwd_dq<D><<<(unsigned)qblocks, kThreads, DqSmem<D>::bytes, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), delta, lse2,
        kv_lens, static_cast<bf*>(dq), Sq, Sk, H, scale);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// bf16 only; D = 64 or 128. delta and lse2 are [B, H, Sq] fp32 scratch.
// Returns cudaGetLastError() after the last launch; cudaErrorInvalidValue
// for a head dim that has no instantiation or a grid past 2^31 - 1 blocks.
int wf_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* m,
                           const void* l, const void* kv_lens, void* dq,
                           void* dk, void* dv, void* delta, void* lse2,
                           int B, int Sq, int Sk, int H, int D, float scale,
                           void* stream) {
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  const int* kl = static_cast<const int*>(kv_lens);
  float* dp = static_cast<float*>(delta);
  float* lsp = static_cast<float*>(lse2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, mp, lp, kl, dq, dk, dv, dp, lsp, B,
                      Sq, Sk, H, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, mp, lp, kl, dq, dk, dv, dp, lsp, B,
                       Sq, Sk, H, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* wf_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
