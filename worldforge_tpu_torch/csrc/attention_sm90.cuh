// The Hopper (sm_90a) attention main loop shared by kernel 1's bf16 path
// (csrc/flash_attention.cu) and kernel 5 (csrc/bsa.cu).
//
// Both TPU kernels (worldforge_tpu/ops/flash_attention.py::_fa_kernel and
// worldforge_tpu/ops/bsa.py::_bsa_kernel) run one algorithm: an online
// softmax over 128-key tiles, fp32 m / l / accumulator, the probabilities
// rounded to bf16 before P.V, one division by l at the end. They differ only
// in where kv tile t comes from, so this loop is templated on a tile-source
// policy (DenseTiles below, BsaTiles in bsa.cu).
//
// What bounds them on the H100 is the tensor-core rate (8.4 TFLOP for one
// Wan self-attention against 0.83 GB of q/k/v/o). Reaching it needs wgmma,
// whose operands come from shared memory in the layout TMA writes, and
// enough query rows per block that each K/V tile read serves many of them:
//   * One block per (128-row query tile, head), consecutive blocks on one
//     head's query tiles, so the blocks in flight share that head's K and V
//     in L2. (Kernel 1 numbers its blocks on gridDim.x alone, whose limit
//     is 2^31 - 1: gridDim.y stops at 65,535, fewer than the B*H rows of
//     the SVD UNet's temporal attention at 1024 x 1024.) 384 threads: a
//     producer warpgroup (one thread issues every copy; setmaxnreg gives
//     its registers away) and two consumer warpgroups of 64 query rows
//     each.
//   * The producer fills Q once and a ring of kStages K/V stages of 128 keys
//     with TMA (cp.async.bulk.tensor, 128-byte swizzle), each stage guarded
//     by a full mbarrier (arrive.expect_tx, completed by the copy's bytes)
//     and an empty mbarrier (one arrival per consumer warp). Rows past the
//     tensor's end are zero-filled by the copy itself; the tensor maps keep
//     batch and head as their own dimensions, so a ragged tile never reads
//     another batch row.
//   * Each consumer computes S = Q.K^T with wgmma m64n128k16 (Q and K both
//     K-major in shared memory), the online softmax in fp32 registers, then
//     converts P to bf16 in registers as wgmma's A operand for O += P.V,
//     with V [keys, D] read MN-major through the descriptor's transpose bit.
//     S, P and O never leave the registers.
// Shared memory at d = 128: Q 32 KB + 2 stages x (K + V) 128 KB.
// The mbarrier, TMA and wgmma primitives are in sm90_common.cuh, which
// kernel 4 (conv3d.cu) shares.

#pragma once

#include "sm90_common.cuh"

namespace sm90 {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;             // query rows per block
constexpr int kKeys = 128;             // keys per kv tile
constexpr int kStages = 2;             // K/V ring depth
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kPanel = 64;             // bf16 columns per 128-byte swizzle row
constexpr int kPanelBytes = 128 * 128; // 128 rows of one panel

// Dynamic shared memory: Q, then K and V of each stage, each tile D / 64
// panels of [128 rows][64 columns] (1024-byte aligned, as the swizzle and
// the wgmma descriptors need), then the mbarriers.
template <int D>
struct Layout {
  static constexpr int panels = D / kPanel;
  static constexpr uint32_t tile = panels * kPanelBytes;
  __host__ __device__ static constexpr uint32_t k(int s) { return tile * (1 + 2 * s); }
  __host__ __device__ static constexpr uint32_t v(int s) { return tile * (2 + 2 * s); }
  static constexpr uint32_t bars = tile * (1 + 2 * kStages);
  static constexpr size_t bytes = bars + 8 * (2 * kStages + 1) + 1024;
};

struct Params {
  const int* kv_lens;   // dense: [B] key lengths (null: every row has Sk)
  const int* indices;   // block-sparse: [BH, Sq / 128, Kmax] chunk indices
  const int* counts;    // block-sparse: [BH, Sq / 128] selected chunks
  __nv_bfloat16* o;
  float* m;             // optional [BH, Sq] running max (null: none)
  float* l;             // optional [BH, Sq] softmax normaliser
  int Sq, Sk, H, Kmax;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ tile sources

// Kernel 1: block x = bh * qtiles + i (bh = b * H + h, qtiles query tiles
// per head) takes query rows [128i, 128i + 128) of batch b, head h; kv tile
// t is keys [128t, 128t + 128), for t < the tile count of kv_lens[b].
// Tensor maps are 4D (D, H, S, B).
struct DenseTiles {
  int bh, b, h, q0, n, kv_len;
  __device__ explicit DenseTiles(const Params& p) {
    const int qtiles = (p.Sq + kRows - 1) / kRows;
    bh = blockIdx.x / qtiles;
    b = bh / p.H;
    h = bh % p.H;
    q0 = (blockIdx.x % qtiles) * kRows;
    kv_len = p.kv_lens != nullptr ? max(0, min(p.kv_lens[b], p.Sk)) : p.Sk;
    n = (kv_len + kKeys - 1) / kKeys;
  }
  __device__ int key0(int t) const { return t * kKeys; }
  __device__ int valid(int t) const { return kv_len - t * kKeys; }
  __device__ void load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                       int col, int row) const {
    tma_load_4d(dst, map, bar, col, h, row, b);
  }
  __device__ long out_row(const Params& p, int r, int d) const {
    return ((long)(b * p.Sq + q0 + r) * p.H + h) * d;
  }
};

// ------------------------------------------------------------ the kernel

template <int D, class Tiles>
__global__ void __launch_bounds__(kThreads, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + L::bars;        // full[s] = full0 + 8s
  const uint32_t empty0 = full0 + 8 * kStages;  // empty[s] = empty0 + 8s
  const uint32_t qbar = empty0 + 8 * kStages;
  const Tiles tiles(p);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0 && tiles.n > 0) {
      mbar_expect_tx(qbar, L::tile);
#pragma unroll
      for (int c = 0; c < L::panels; ++c)
        tiles.load(&tq, base + c * kPanelBytes, qbar, c * kPanel, tiles.q0);
      for (int t = 0; t < tiles.n; ++t) {
        const int s = t % kStages;
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * L::tile);
        const int row = tiles.key0(t);
#pragma unroll
        for (int c = 0; c < L::panels; ++c) {
          tiles.load(&tk, base + L::k(s) + c * kPanelBytes, bar, c * kPanel,
                     row);
          tiles.load(&tv, base + L::v(s) + c * kPanelBytes, bar, c * kPanel,
                     row);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                       // query rows 64cw ..
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const float scale_log2 = p.scale * kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;   // running max of rows g, g + 8
    float l0 = 0.f, l1 = 0.f;           // this thread's part of their sums
    if (tiles.n > 0) mbar_wait(qbar, 0);

    for (int t = 0; t < tiles.n; ++t) {
      const int s = t % kStages;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      // S = Q K^T: 64 rows x 128 keys, D / 16 k-steps of 16 columns
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(base + cw * 64 * 128 + off, 16, 1024),
                      smem_desc(base + L::k(s) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // online softmax on rows g (regs 4j, 4j+1) and g + 8 (4j+2, 4j+3)
      const int valid = tiles.valid(t);
      if (valid < kKeys) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t4 + (e & 1) >= valid) sc[4 * j + e] = kNegInf;
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * p.scale);
      const float mn1 = fmaxf(m1, mx1 * p.scale);
      const float al0 = ex2((m0 - mn0) * kLog2e);
      const float al1 = ex2((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      const float b0 = mn0 * kLog2e, b1 = mn1 * kLog2e;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -b0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -b0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -b1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -b1));
        s0 += sc[4 * j] + sc[4 * j + 1];
        s1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = al0 * l0 + s0;
      l1 = al1 * l1 + s1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // P in bf16 (the Pallas kernel's p.astype(v.dtype)), in the A-operand
      // layout: k-step kk covers keys 16kk .. 16kk + 15
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: V [128 keys, D] MN-major; a k-step is 16 key rows (2048
      // bytes), the next 64 columns are the next panel (LBO)
      pin(o);
      pin(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<D>(o, pa[kk],
                    smem_desc(base + L::v(s) + kk * 2048, kPanelBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: the row sums are spread over the 4 lanes of a row group
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const int r0 = cw * 64 + warp * 16 + g, r1 = r0 + 8;
    const bool ok0 = tiles.q0 + r0 < p.Sq, ok1 = tiles.q0 + r1 < p.Sq;
    __nv_bfloat16* o0 = p.o + tiles.out_row(p, r0, D) + 2 * t4;
    __nv_bfloat16* o1 = p.o + tiles.out_row(p, r1, D) + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (ok0)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (ok1)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (p.m != nullptr && t4 == 0) {
      const long ml = (long)tiles.bh * p.Sq + tiles.q0;
      if (ok0) {
        p.m[ml + r0] = m0;
        p.l[ml + r0] = l0;
      }
      if (ok1) {
        p.m[ml + r1] = m1;
        p.l[ml + r1] = l1;
      }
    }
  }
}

// ------------------------------------------------------------ host side

// The tensor map of q, k or v: `rank` dimensions (innermost first: the head
// dim), strides in bytes for dimensions 1.., a box of 64 columns x 128 rows
// along dimension `row_dim` (1 elsewhere), 128-byte swizzle.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint64_t* strides,
                            int row_dim) {
  uint32_t box[5];
  for (int i = 0; i < rank; ++i)
    box[i] = i == 0 ? kPanel : (i == row_dim ? kRows : 1);
  return make_map(map, base, rank, dims, strides, box, 128);
}

template <int D, class Tiles>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, dim3 grid,
                   cudaStream_t stream) {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attn_sm90_kernel<D, Tiles>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  attn_sm90_kernel<D, Tiles><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace sm90
