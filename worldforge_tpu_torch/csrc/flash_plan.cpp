// Kernel 1's bf16 layout for the host: the plan that csrc/flash_attention.cu
// compiles for a route, head dim and key count (attention_bf16_plan.cuh),
// read by ops/flash_attention.py::_bf16_plan. Plain C++, built by the
// host's compiler (ops/_build.py), so the CPU tests read it as well.

#include "attention_bf16_plan.cuh"

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

}  // extern "C"
