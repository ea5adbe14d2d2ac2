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
// ridge. The design keeps S, P and the output accumulator on chip and feeds
// the bf16 products to the tensor cores:
//   * bf16 (d = 64, 128): one block of 4 warps per (b*h, 64-query tile); each
//     warp owns 16 query rows. K and V tiles of 64 keys are double-buffered
//     in shared memory with cp.async; Q.K^T and P.V run as m16n8k16 bf16
//     mma.sync products (operands through ldmatrix) with fp32 accumulation,
//     and the scores, probabilities and output accumulator never leave the
//     registers (the mma accumulator layout of S is the A-operand layout of
//     P), so a kv tile needs no shared-memory round trip besides K and V.
//   * fp32 (d = 64, 128, 384; the VAE's single-head attention is d = 384):
//     full fp32 FMA arithmetic, no tensor cores (TF32 would round the inputs
//     to 10 mantissa bits). One block of 128 threads per 16-query tile, 8
//     threads per query row with the q slice in registers; kv tiles of 16
//     keys in shared memory (48 KB at d = 384, so the launch raises the
//     dynamic shared-memory limit), read by broadcast.
// Simple and correct first: no TMA and no wgmma (Hopper's full tensor-core
// rate needs both; a later change).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ----------------------------------------------------------- bf16 mma.sync

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per kv tile
constexpr int kWarps = 4;

template <int D>
struct Bf16Smem {
  // Row stride of the Q/K/V tiles: D + 8 bf16 shifts each row by 16 bytes
  // of bank, so the 8 row addresses of an ldmatrix hit 8 distinct banks.
  static constexpr int LD = D + 8;
  static constexpr int tile = kBK * LD;                 // one K or V stage
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (kBQ * LD + 4 * tile);    // Q, 2 K, 2 V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global->shared copy that bypasses the registers; zero-fills the
// destination when !valid (src-size 0 reads nothing).
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

// c += a . b for a 16x16 (row) bf16 A, a 16x8 (col) bf16 B, fp32 C.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage a [rows, D] bf16 tile (global row stride `gs` elements) into shared
// memory with row stride LD; rows at or past `valid` are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int rows,
                                           int valid, long gs) {
  constexpr int VPR = D / 8;                  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (long)(ok ? r : 0) * gs + c, ok);
  }
}

// One block per (b*h, 64-query tile), 4 warps of 16 query rows. The
// accumulator, the scores and the probabilities live in registers in the
// mma fragment layouts: a thread owns rows g and g+8 of its warp's 16
// (g = lane / 4) and, in every 8-wide column tile, columns 2*(lane%4) and
// 2*(lane%4)+1. K and V tiles are double-buffered with cp.async, so the
// next tile loads while this one computes.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out,
               int Sq, int Sk, int H, float scale) {
  using L = Bf16Smem<D>;
  constexpr int NS = kBK / 8;                 // score column tiles
  constexpr int NO = D / 8;                   // output column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * L::LD;       // stages at 0 and L::tile
  __nv_bfloat16* Vs = Ks + 2 * L::tile;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const long rs = (long)H * D;                       // token stride
  const int kv_len = max(0, min(kv_lens[b], Sk));
  const int ntiles = (kv_len + kBK - 1) / kBK;       // tiles past kv_len skip
  const __nv_bfloat16* qb = q + ((long)b * Sq + q0) * rs + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Sk * rs + (long)h * D;
  const __nv_bfloat16* vb = v + (long)b * Sk * rs + (long)h * D;

  stage_tile<D, L::LD>(Qs, qb, kBQ, min(kBQ, Sq - q0), rs);
  if (ntiles > 0) {
    stage_tile<D, L::LD>(Ks, kb, kBK, min(kBK, Sk), rs);
    stage_tile<D, L::LD>(Vs, vb, kBK, min(kBK, Sk), rs);
  }
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows g and g+8
  float l0 = 0.f, l1 = 0.f;           // this thread's part of their sums

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = (t + 1) * kBK;
      stage_tile<D, L::LD>(Ks + (st ^ 1) * L::tile, kb + (long)k1 * rs, kBK,
                           min(kBK, Sk - k1), rs);
      stage_tile<D, L::LD>(Vs + (st ^ 1) * L::tile, vb + (long)k1 * rs, kBK,
                           min(kBK, Sk - k1), rs);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * L::LD + kk * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + st * L::tile;
    const __nv_bfloat16* Vt = Vs + st * L::tile;

    // S = Q K^T: 16 rows x 64 keys per warp
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 L::LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * j2], qf[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * j2 + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // online softmax on rows g (elements 0, 1) and g+8 (elements 2, 3)
    const int kbase = t * kBK + tig * 2;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = sc[j][e] * scale;
        if (kbase + j * 8 + (e & 1) >= kv_len) val = kNegInf;
        sc[j][e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[j][0] = __expf(sc[j][0] - mn0);
      sc[j][1] = __expf(sc[j][1] - mn0);
      sc[j][2] = __expf(sc[j][2] - mn1);
      sc[j][3] = __expf(sc[j][3] - mn1);
      s0 += sc[j][0] + sc[j][1];
      s1 += sc[j][2] + sc[j][3];
    }
    l0 = al0 * l0 + s0;
    l1 = al1 * l1 + s1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V, with P rounded to bf16 (the Pallas kernel's p.astype(v))
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * L::LD +
                                  n2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * n2], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before refill
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
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((long)b * Sq + r0) * rs +
                                         (long)h * D + c) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((long)b * Sq + r1) * rs +
                                         (long)h * D + c) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (m_out != nullptr && tig == 0) {
    if (r0 < Sq) {
      m_out[(long)bh * Sq + r0] = m0;
      l_out[(long)bh * Sq + r0] = l0;
    }
    if (r1 < Sq) {
      m_out[(long)bh * Sq + r1] = m1;
      l_out[(long)bh * Sq + r1] = l1;
    }
  }
}

// ----------------------------------------------------------------- fp32 FMA

constexpr int kFQ = 16;         // query rows per block
constexpr int kFK = 16;         // keys per kv tile
constexpr int kFThreads = 128;  // 8 threads per query row

template <int D>
struct F32Smem {
  static constexpr size_t bytes = sizeof(float) * 2 * kFK * D;   // K, V
};

// Eight threads share a query row; thread `sub` owns the dims
// d = 32*j + 4*sub + {0..3}, holds its q slice in registers for the whole
// kv loop and reads K and V as float4. The four rows of a warp read the
// same K / V addresses, which shared memory broadcasts, so each 128-byte
// wavefront feeds 128 FMAs. Each score is reduced over the 8 threads with
// three xor-shuffles, which leaves it in all 8; the softmax state is kept
// redundantly in all 8.
template <int D>
__global__ void __launch_bounds__(kFThreads, 3)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ kv_lens,
              float* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ l_out, int Sq, int Sk, int H, float scale) {
  constexpr int NJ = D / 32;            // float4 slices per thread
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* Ks = reinterpret_cast<float*>(smem_f);
  float* Vs = Ks + kFK * D;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row = threadIdx.x / 8, sub = threadIdx.x % 8;
  const int qi = blockIdx.x * kFQ + row;
  const long rs = (long)H * D;
  const int kv_len = max(0, min(kv_lens[b], Sk));
  const float* kb = k + (long)b * Sk * rs + (long)h * D;
  const float* vb = v + (long)b * Sk * rs + (long)h * D;

  float4 qv[NJ], acc[NJ];
  const float* qrow = q + ((long)b * Sq + min(qi, Sq - 1)) * rs + (long)h * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    qv[j] = *reinterpret_cast<const float4*>(qrow + 32 * j + 4 * sub);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m_i = kNegInf, l_i = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kFK) {
    __syncthreads();   // every thread is done with the previous tiles
    const int kvalid = min(kFK, Sk - k0);
    for (int i = threadIdx.x; i < kFK * D / 4; i += kFThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kz = make_float4(0.f, 0.f, 0.f, 0.f), vz = kz;
      if (r < kvalid) {
        kz = *reinterpret_cast<const float4*>(kb + (long)(k0 + r) * rs + c);
        vz = *reinterpret_cast<const float4*>(vb + (long)(k0 + r) * rs + c);
      }
      *reinterpret_cast<float4*>(Ks + r * D + c) = kz;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vz;
    }
    __syncthreads();

    float s[kFK];
    float mx = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float* krow = Ks + kk * D + 4 * sub;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kf = *reinterpret_cast<const float4*>(krow + 32 * j);
        part = fmaf(qv[j].x, kf.x, part);
        part = fmaf(qv[j].y, kf.y, part);
        part = fmaf(qv[j].z, kf.z, part);
        part = fmaf(qv[j].w, kf.w, part);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[kk] = k0 + kk < kv_len ? part * scale : kNegInf;
      mx = fmaxf(mx, s[kk]);
    }
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      s[kk] = expf(s[kk] - m_new);
      sum += s[kk];
    }
    l_i = alpha * l_i + sum;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j].x *= alpha; acc[j].y *= alpha;
      acc[j].z *= alpha; acc[j].w *= alpha;
    }
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float p = s[kk];
      const float* vrow = Vs + kk * D + 4 * sub;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vf = *reinterpret_cast<const float4*>(vrow + 32 * j);
        acc[j].x = fmaf(p, vf.x, acc[j].x);
        acc[j].y = fmaf(p, vf.y, acc[j].y);
        acc[j].z = fmaf(p, vf.z, acc[j].z);
        acc[j].w = fmaf(p, vf.w, acc[j].w);
      }
    }
  }

  if (qi < Sq) {
    const float inv = l_i == 0.f ? 0.f : 1.f / l_i;
    float* orow = o + ((long)b * Sq + qi) * rs + (long)h * D + 4 * sub;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(orow + 32 * j) =
          make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv,
                      acc[j].w * inv);
    if (m_out != nullptr && sub == 0) {
      m_out[(long)bh * Sq + qi] = m_i;
      l_out[(long)bh * Sq + qi] = l_i;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* kv_lens, void* o, float* m, float* l,
                        int B, int Sq, int Sk, int H, float scale,
                        cudaStream_t stream) {
  const size_t bytes = Bf16Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  fa_bf16_kernel<D><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_lens,
      static_cast<__nv_bfloat16*>(o), m, l, Sq, Sk, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* kv_lens, void* o, float* m, float* l,
                       int B, int Sq, int Sk, int H, float scale,
                       cudaStream_t stream) {
  const size_t bytes = F32Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kFQ - 1) / kFQ, B * H);
  fa_f32_kernel<D><<<grid, kFThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_lens, static_cast<float*>(o), m, l,
      Sq, Sk, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. m/l may be null (no return_lse).
// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// (dtype, head_dim) pair that has no instantiation.
int wf_flash_attention(const void* q, const void* k, const void* v,
                       const void* kv_lens, void* o, void* m, void* l, int B,
                       int Sq, int Sk, int H, int D, float scale, int dtype,
                       void* stream) {
  const int* kl = static_cast<const int*>(kv_lens);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 64) return launch_bf16<64>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
    if (D == 128) return launch_bf16<128>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
  } else if (dtype == 0) {
    if (D == 64) return launch_f32<64>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
    if (D == 128) return launch_f32<128>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
    if (D == 384) return launch_f32<384>(q, k, v, kl, o, mp, lp, B, Sq, Sk, H, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* wf_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
