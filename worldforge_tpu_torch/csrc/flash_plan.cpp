// Kernel 1's layouts for the host: the plans that csrc/flash_attention.cu
// compiles for a route, head dim and key count in bf16
// (attention_bf16_plan.cuh, read by ops/flash_attention.py::_bf16_plan) and
// for a head dim, variant, key count and chunk in fp32
// (attention_f32_plan.cuh, read by _fwd_plan). Plain C++, built by the
// host's compiler (ops/_build.py), so the CPU tests read it as well.

#include "attention_bf16_plan.cuh"
#include "attention_f32_plan.cuh"

extern "C" {

// Route 0 (the long-row loop, head dim 64 or 128) or 1 (the short-key
// kernel, head dim 128) at Sk keys, into out[7]: 128-key tiles, the last
// tile's width (0: none), resident K / V (0 / 1), K / V buffers or ring
// stages, Q buffers, bytes of a K / V buffer or stage, dynamic shared
// memory. 0 where there is no such instantiation, else 1.
int wf_flash_bf16_plan(int route, int D, int Sk, int* out) {
  sm90short::Plan pl;
  const bool ok = route == 0   ? sm90short::long_plan(D, Sk, &pl)
                  : route == 1 ? D == sm90short::kD &&
                                     sm90short::make_plan(Sk, &pl)
                               : false;
  if (!ok) return 0;
  const int fields[7] = {pl.nfull,   pl.tail,         pl.resident,
                         pl.kv_bufs, pl.q_bufs,       (int)pl.kv_unit,
                         (int)pl.smem};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return 1;
}

// fp32 at head dim D, variant V and Sk keys, in chunks of `chunk_tiles`
// 128-row query tiles at d 384 / 512 (0 for the one-pass kernels), into
// out[11]: query rows a block, keys a ring stage, ring stages, threads,
// dynamic shared memory (pass 2's at d 384 / 512), then pass 1's keys a
// block, its depth stages and its shared memory, pass 2's columns of O a
// block, pass 1's key tiles and the scratch bytes of a chunk (all 0 for
// the one-pass kernels). 0 where there is no such instantiation or chunk,
// else 1.
int wf_flash_f32_plan(int D, int V, int Sk, int chunk_tiles, long long* out) {
  f32plan::Plan pl;
  if (!f32plan::make_plan(D, V, Sk, chunk_tiles, &pl)) return 0;
  const long long fields[11] = {
      pl.rows,       pl.key_tile,     pl.stages,          pl.threads,
      pl.smem,       pl.score_tile,   pl.score_stages,    pl.score_smem,
      pl.cols,       pl.score_key_tiles, pl.scratch};
  for (int i = 0; i < 11; ++i) out[i] = fields[i];
  return 1;
}

}  // extern "C"
