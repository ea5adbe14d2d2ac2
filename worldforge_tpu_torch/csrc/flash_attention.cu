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
//     flash_attention.py::_fwd_plan) picks the variant and passes it to the
//     entry point, which refuses one it does not compile; the layout
//     follows from the head dim and variant (attention_f32_plan.cuh, which
//     the host reads through flash_plan.cpp). No scratch in device memory: the split planes live in shared
//     memory (193 KB at d 64 and 128, 141 KB at d 80).
//   * fp32 d = 384, 512 (the Wan2.1 and SVD VAEs' single-head mid
//     attention): attention_f32_wide_sm90.cuh, two passes, each a GEMM of
//     3xTF32 wgmma m64n128k8 products fed by a TMA ring, with the scores in
//     a device scratch between them. A 64-row O of 384 / 512 columns would
//     be 192 / 256 fp32 registers a thread in one warpgroup (twice that with
//     the fresh accumulator each key tile needs), and Q's hi / lo planes at
//     64 rows 196 / 262 KB, so the one-pass layout above does not fit. Pass
//     1 (fa_f32_scores_kernel) computes a 128 x 128 tile of S = scale
//     Q.K^T a block, the depth streamed in 32-float stages (a 4-stage ring
//     of Q raw and K hi / lo, 48 KB a stage, 193 KB), and writes S and
//     each row's (max, sum of exp) over its 128 keys. Pass 2
//     (fa_f32_pv_kernel) takes 128 rows x 128 columns of O a block: it
//     merges the row's partials into the exact m and l (so O is never
//     rescaled), then streams 32-key stages of S and V (a 3-stage ring of S,
//     V raw and V^T hi / lo, 64 KB a stage, 193 KB), P = exp(S - m) split
//     in registers as the A operand, O / l stored at the end. Both: one
//     producer thread, 96 splitter threads, two consumer warpgroups of 64
//     rows taking turns; a consumer thread holds 64 + 64 accumulator and
//     32 fragment registers (setmaxnreg 224 / 56). The host (ops/
//     flash_attention.py::_fwd_plan) cuts a call into chunks of 128-row
//     query tiles, flat over (b * h, tile), so the scratch (S of the chunk
//     and its partials, sized by attention_f32_plan.cuh) stays within 256
//     MiB, and picks the chunk that gives the fewest waves of both passes
//     on the card's SMs; the entry point takes the chunk and the scratch and
//     launches the two passes chunk by chunk on the caller's stream
//     (2 launches a chunk, no host synchronisation, scratch from the
//     caller, so CUDA graphs capture it).
//   * Blocks are numbered on gridDim.x alone (x = bh * qtiles + query tile),
//     whose limit is 2^31 - 1: on gridDim.y, B*H would stop at 65,535, and
//     the SVD UNet's temporal attention has B*H = (H/8)(W/8) x 5 rows at its
//     first level (81,920 at 1024 x 1024).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "attention_short_sm90.cuh"
#include "attention_f32_sm90.cuh"
#include "attention_f32_wide_sm90.cuh"

namespace {

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

// The one-pass kernels' layout is the one the host's plan reports
// (attention_f32_plan.cuh::one_pass_plan).
template <int D, int V>
constexpr bool same_plan() {
  using L = sm90f32::Plan<D, V>;
  constexpr f32plan::Plan p = f32plan::one_pass_plan(D, V);
  return L::Rows == p.rows && L::KT == p.key_tile && L::NS == p.stages &&
         L::Threads == p.threads && L::bytes == (size_t)p.smem;
}
static_assert(same_plan<64, 0>() && same_plan<64, 1>() && same_plan<80, 0>() &&
                  same_plan<128, 0>(),
              "the one-pass kernels and one_pass_plan disagree");

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

// fp32 flash attention on the instantiation of head dim D and variant V
// (ops/flash_attention.py::_fwd_plan; the layout follows from them,
// attention_f32_plan.cuh). At d 384 and 512 the host also picks the chunk
// (`chunk_tiles` 128-row query tiles a chunk) and passes the scratch, at
// least sm90f32w::scratch_bytes(Sk, chunk_tiles) bytes; the one-pass
// kernels take chunk_tiles 0 and no scratch. Refused before anything runs:
// cudaErrorInvalidValue for a head dim and variant with no instantiation,
// a chunk below one tile or a scratch too small; cudaErrorInvalidConfiguration
// for a chunk at a one-pass head dim. kv_lens may be null: every batch row
// then has Sk keys.
int wf_flash_attention_f32(const void* q, const void* k, const void* v,
                           const void* kv_lens, void* o, void* m, void* l,
                           int B, int Sq, int Sk, int H, int D, float scale,
                           int V, int chunk_tiles, void* scratch,
                           long long scratch_bytes, void* stream) {
  const int* kl = static_cast<const int*>(kv_lens);
  float* op = static_cast<float*>(o);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32plan::two_pass(D, V)) {
    if (D == 384)
      return sm90f32w::launch<384>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale,
                                   chunk_tiles, scratch, scratch_bytes, s);
    return sm90f32w::launch<512>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale,
                                 chunk_tiles, scratch, scratch_bytes, s);
  }
  if (!f32plan::one_pass(D, V)) return (int)cudaErrorInvalidValue;
  if (chunk_tiles != 0) return (int)cudaErrorInvalidConfiguration;
  using sm90f32::launch;
  switch (D) {
    case 64:
      return V ? launch<64, 1>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s)
               : launch<64, 0>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s);
    case 80:
      return launch<80, 0>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s);
  }
  return launch<128, 0>(q, k, v, kl, op, mp, lp, B, Sq, Sk, H, scale, s);
}

const char* wf_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
