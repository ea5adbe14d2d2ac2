// Block-sparse attention for Hopper (sm_90a), bf16, head dim 64 or 128.
//
// Replaces the Pallas TPU kernel worldforge_tpu/ops/bsa.py::_bsa_kernel
// (pallas_call at :209, through _bsa_bhsd :174, _bsa_bhsd_grouped :295,
// _bsa_dispatch :321 and bsa_attention_3d :374). Same contract:
//   q [BH, Sq, D], k/v [BH, Sk, D] (contiguous, chunk-rearranged: every 128
//   consecutive tokens are one (4,4,8) t/h/w chunk), indices [BH, Nq, Kmax]
//   int32 and counts [BH, Nq] int32 with Nq = Sq / 128. Query chunk n of
//   head bh attends to the key chunks indices[bh, n, 0 .. counts[bh, n]);
//   slots at or past the count are ignored. Online softmax with fp32 m / l /
//   accumulator; the probabilities are rounded to bf16 before the P.V
//   product (the Pallas kernel's p.astype(v.dtype)). A count of 0 gives
//   zeros (m = -1e30, l = 0). Optional m and l outputs [BH, Sq] fp32
//   (return_lse, for the context-parallel merge).
//
// What bounds it on the H100: operations. At the LongCat refine shape (32
// heads, 56,320 tokens = 440 chunks, 55 selected chunks each, d 128) one call
// is 4 * 56,320 * (55 * 128) * 128 * 32 = 6.50 TFLOP, 6.57 ms at 989 TFLOP/s,
// against 1.84 GB of q, k, v and o (0.55 ms at 3.35 TB/s). The design is the
// bf16 tile loop of csrc/flash_attention.cu, with the loop running over the
// selected key chunks instead of all keys:
//   * One block of 4 warps per (bh, 64-row half of a 128-row query chunk);
//     each warp owns 16 query rows. The block reads its count and its index
//     row from device memory (the TPU's scalar prefetch).
//   * Each selected 128-key chunk is two 64-key tiles. K and V tiles are
//     double-buffered in shared memory with cp.async; Q.K^T and P.V run as
//     m16n8k16 bf16 mma.sync products with fp32 accumulation, and S, P and
//     the output accumulator stay in registers (the accumulator layout of S
//     is the A-operand layout of P). The epilogue divides once by l.
//   * No gather of blocks into one wide tile and no padding of Kmax (the
//     TPU's 8-block gather fed its 128x128 matrix unit), and no grouping of
//     heads (the TPU's scalar memory limit): the whole index table is read
//     where it lies.
//   * Grid order: query tiles on blockIdx.x, heads on blockIdx.y, so the
//     blocks in flight share one head, whose K and V (28.8 MB at the refine
//     shape) stay in the 50 MB L2 while its selected chunks are read again
//     and again.
// Simple and correct first: no TMA and no wgmma (a later change).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 128;   // tokens per chunk (query and key)
constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per kv tile (half a chunk)
constexpr int kWarps = 4;

template <int D>
struct Smem {
  // Row stride D + 8 bf16: the 8 row addresses of an ldmatrix land in 8
  // distinct 16-byte bank groups.
  static constexpr int LD = D + 8;
  static constexpr int tile = kBK * LD;
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (kBQ * LD + 4 * tile);    // Q, 2 K, 2 V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_u32(dst)), "l"(src));
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

// Stage 64 rows of D bf16 (global row stride D) into shared memory with row
// stride LD. Every row is in range: Sq and Sk are multiples of 128.
template <int D, int LD>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  constexpr int VPR = D / 8;                  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kBK * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(dst + r * LD + c, src + (long)r * D + c);
  }
}

// The key offset of kv tile t of a query chunk: half t & 1 of its selected
// chunk t >> 1 (an index out of [0, Nk) is clamped, never read out of range).
__device__ __forceinline__ long tile_key0(const int* idx, int t, int nk) {
  const int blk = min(max(idx[t >> 1], 0), nk - 1);
  return (long)blk * kChunk + (t & 1) * kBK;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
bsa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int* __restrict__ indices,
                const int* __restrict__ counts,
                __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                float* __restrict__ l_out, int Sq, int Sk, int Kmax,
                float scale) {
  using L = Smem<D>;
  constexpr int NS = kBK / 8;                 // score column tiles
  constexpr int NO = D / 8;                   // output column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * L::LD;       // stages at 0 and L::tile
  __nv_bfloat16* Vs = Ks + 2 * L::tile;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int nq = Sq / kChunk, nk = Sk / kChunk;
  const long row = (long)bh * nq + q0 / kChunk;
  const int* idx = indices + row * Kmax;
  const int ntiles = 2 * min(max(counts[row], 0), Kmax);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qb = q + ((long)bh * Sq + q0) * D;
  const __nv_bfloat16* kb = k + (long)bh * Sk * D;
  const __nv_bfloat16* vb = v + (long)bh * Sk * D;

  stage_tile<D, L::LD>(Qs, qb);
  if (ntiles > 0) {
    const long k0 = tile_key0(idx, 0, nk);
    stage_tile<D, L::LD>(Ks, kb + k0 * D);
    stage_tile<D, L::LD>(Vs, vb + k0 * D);
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
      const long k1 = tile_key0(idx, t + 1, nk);
      stage_tile<D, L::LD>(Ks + (st ^ 1) * L::tile, kb + k1 * D);
      stage_tile<D, L::LD>(Vs + (st ^ 1) * L::tile, vb + k1 * D);
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
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
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

    // O += P V, with P rounded to bf16
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
  __nv_bfloat16* ob = o + (long)bh * Sq * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(ob + (long)r0 * D + c) =
        __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(ob + (long)r1 * D + c) =
        __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (m_out != nullptr && tig == 0) {
    m_out[(long)bh * Sq + r0] = m0;
    l_out[(long)bh * Sq + r0] = l0;
    m_out[(long)bh * Sq + r1] = m1;
    l_out[(long)bh * Sq + r1] = l1;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* indices, const int* counts, void* o, float* m,
                   float* l, int BH, int Sq, int Sk, int Kmax, float scale,
                   cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bsa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / kBQ, BH);
  bsa_bf16_kernel<D><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), indices, counts,
      static_cast<__nv_bfloat16*>(o), m, l, Sq, Sk, Kmax, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only. m/l may be null (no return_lse). Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for a head dim other than 64 or
// 128, or sequence lengths that are no multiples of 128.
int wf_bsa(const void* q, const void* k, const void* v, const void* indices,
           const void* counts, void* o, void* m, void* l, int BH, int Sq,
           int Sk, int D, int Kmax, float scale, void* stream) {
  const int* ip = static_cast<const int*>(indices);
  const int* cp = static_cast<const int*>(counts);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq % kChunk || Sk % kChunk || Sk == 0 || Kmax < 1)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return launch<64>(q, k, v, ip, cp, o, mp, lp, BH, Sq, Sk, Kmax, scale, s);
  if (D == 128) return launch<128>(q, k, v, ip, cp, o, mp, lp, BH, Sq, Sk, Kmax, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* wf_bsa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
