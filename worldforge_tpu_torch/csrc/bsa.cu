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
// against 1.84 GB of q, k, v and o (0.55 ms at 3.35 TB/s). It runs the
// shared wgmma / TMA main loop of attention_sm90.cuh (which says how that
// loop reaches the tensor-core rate) with a block-sparse tile source:
//   * One block per (128-row query chunk, head): the block's query tile is
//     exactly one chunk, and kv tile t is the selected key chunk
//     indices[bh, n, t], for t < counts[bh, n]. The producer thread reads
//     the count and the index row from device memory (the TPU's scalar
//     prefetch) and points each TMA copy at the selected chunk; no gather of
//     blocks into a wide tile and no padding of Kmax (the TPU's 8-block
//     gather fed its 128x128 matrix unit), and no grouping of heads.
//   * The tensor maps are 3D (D, S, BH); S is a multiple of 128, so no
//     tile is ragged.
//   * Grid order: query chunks on blockIdx.x, heads on blockIdx.y, so the
//     blocks in flight share one head, whose K and V (28.8 MB at the refine
//     shape) stay in the 50 MB L2 while its selected chunks are read again
//     and again.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

// Block (x = query chunk n, y = bh); kv tile t is key chunk indices[bh, n,
// t] (an index out of [0, Nk) is clamped, never read out of range).
struct BsaTiles {
  int bh, q0, n, nk;
  const int* idx;
  __device__ explicit BsaTiles(const sm90::Params& p) {
    bh = blockIdx.y;
    q0 = blockIdx.x * sm90::kRows;
    const long row = (long)bh * (p.Sq / sm90::kRows) + blockIdx.x;
    idx = p.indices + row * p.Kmax;
    n = min(max(p.counts[row], 0), p.Kmax);
    nk = p.Sk / sm90::kKeys;
  }
  __device__ int key0(int t) const {
    return min(max(idx[t], 0), nk - 1) * sm90::kKeys;
  }
  __device__ int valid(int) const { return sm90::kKeys; }
  __device__ void load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                       int col, int row) const {
    sm90::tma_load_3d(dst, map, bar, col, row, bh);
  }
  __device__ long out_row(const sm90::Params& p, int r, int d) const {
    return ((long)bh * p.Sq + q0 + r) * d;
  }
};

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* indices, const int* counts, void* o, float* m,
                   float* l, int BH, int Sq, int Sk, int Kmax, float scale,
                   cudaStream_t stream) {
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t dq[3] = {(uint64_t)D, (uint64_t)Sq, (uint64_t)BH};
  const uint64_t dk[3] = {(uint64_t)D, (uint64_t)Sk, (uint64_t)BH};
  const uint64_t sq[2] = {D * e, (uint64_t)Sq * D * e};
  const uint64_t sk[2] = {D * e, (uint64_t)Sk * D * e};
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map(&tq, q, 3, dq, sq, 1);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, 3, dk, sk, 1);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, 3, dk, sk, 1);
  if (err != cudaSuccess) return err;
  sm90::Params p{};
  p.indices = indices;
  p.counts = counts;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m = m;
  p.l = l;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Kmax = Kmax;
  p.scale = scale;
  dim3 grid(Sq / sm90::kRows, BH);
  return sm90::launch<D, BsaTiles>(tq, tk, tv, p, grid, stream);
}

}  // namespace

extern "C" {

// bf16 only. m/l may be null (no return_lse). Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for a head dim other than 64 or
// 128, sequence lengths that are no multiples of 128, or a tensor the TMA
// descriptors refuse.
int wf_bsa(const void* q, const void* k, const void* v, const void* indices,
           const void* counts, void* o, void* m, void* l, int BH, int Sq,
           int Sk, int D, int Kmax, float scale, void* stream) {
  const int* ip = static_cast<const int*>(indices);
  const int* cp = static_cast<const int*>(counts);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq % sm90::kRows || Sk % sm90::kKeys || Sk == 0 || Kmax < 1)
    return (int)cudaErrorInvalidValue;
  if (D == 64) return launch<64>(q, k, v, ip, cp, o, mp, lp, BH, Sq, Sk, Kmax, scale, s);
  if (D == 128) return launch<128>(q, k, v, ip, cp, o, mp, lp, BH, Sq, Sk, Kmax, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* wf_bsa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
