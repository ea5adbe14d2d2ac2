// The shared-memory plan of kernel 1's bf16 forward, in plain C++ with no
// CUDA header: csrc/flash_attention.cu lays its kernels out by it, and
// csrc/flash_plan.cpp, built by the host's C++ compiler, exports it to the
// wrapper (ops/flash_attention.py::_bf16_plan) and to the CPU tests. Route
// 0 is the long-row loop of attention_sm90.cuh (its Layout<D>::bytes is
// held to long_plan's by a static_assert in flash_attention.cu); route 1
// the short-key kernel of attention_short_sm90.cuh, head dim 128.

#pragma once

#include <cstdint>

namespace sm90short {

constexpr int kD = 128;                          // head dim
constexpr int kRowBytes = kD * 2;                // one bf16 row
constexpr int kQRows = 128;                      // query rows of an item
constexpr uint32_t kQBytes = kQRows * kRowBytes; // 32 KB
constexpr uint32_t kQPanel = kQRows * 128;       // 64 columns of 128 rows
constexpr int kFull = 128;                       // keys of a full tile
constexpr uint32_t kStageBytes = 2 * kFull * kRowBytes;   // ring: K + V
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr uint32_t kSmemLimit = 232448;

// Key tiles, K / V buffers, Q buffers and shared memory of one call.
struct Plan {
  int nfull;      // 128-key tiles
  int tail;       // width of the last tile (16, 32, 64, 128) or 0
  int resident;   // K / V kept for a head (1) or streamed by tile (0)
  int kv_bufs;    // resident buffers (1, 2) or ring stages (2)
  int q_bufs;     // Q buffers (2 to 4); O is staged in its item's buffer
  uint32_t kv_unit;   // bytes of one resident buffer or ring stage
  uint32_t smem;      // dynamic shared memory
};

// Route 1's bytes: 1 KB to align the base to the 128-byte swizzle's
// 1024-byte atom, the Q buffers, the K / V buffers or stages, and 8 bytes
// of mbarrier for each of q_full, o_ready (per Q buffer), kv_full,
// kv_empty (per K / V buffer).
constexpr uint32_t plan_bytes(int q_bufs, int kv_bufs, uint32_t kv_unit) {
  return 1024u + q_bufs * kQBytes + kv_bufs * kv_unit +
         8u * (2 * q_bufs + 2 * kv_bufs);
}

// Route 1 at Sk keys: 128-key tiles and a last one cut to the narrowest of
// 16, 32, 64, 128 at or above the rest; K and V of every tile resident for
// a head where they fit beside the Q buffers, in two buffers where those
// fit too, else a ring of two 128-key stages; as many Q buffers (4 to 2)
// as fit, preferred to a second K / V buffer.
inline bool make_plan(int Sk, Plan* pl) {
  if (Sk < 1) return false;
  const int rem = Sk % kFull;
  pl->nfull = Sk / kFull;
  pl->tail = rem == 0 ? 0 : rem <= 16 ? 16 : rem <= 32 ? 32 : rem <= 64 ? 64
                                                                          : 128;
  const uint32_t padded = pl->nfull * kFull + pl->tail;
  pl->resident = 1;
  pl->kv_unit = 2 * padded * kRowBytes;
  for (int q = 4; q >= 2; --q)
    for (int kb = 2; kb >= 1; --kb)
      if (plan_bytes(q, kb, pl->kv_unit) <= kSmemLimit) {
        pl->q_bufs = q;
        pl->kv_bufs = kb;
        pl->smem = plan_bytes(q, kb, pl->kv_unit);
        return true;
      }
  pl->resident = 0;
  pl->kv_unit = kStageBytes;
  pl->kv_bufs = kStages;
  for (int q = 4; q >= 2; --q)
    if (plan_bytes(q, kStages, kStageBytes) <= kSmemLimit) {
      pl->q_bufs = q;
      pl->smem = plan_bytes(q, kStages, kStageBytes);
      return true;
    }
  return false;
}

// Route 0 (head dim 64 or 128): one Q tile of 128 rows, two ring stages of
// K and V of 128 keys, 8 bytes of mbarrier for each of Q's and the
// stages' full and empty, 1 KB of alignment.
constexpr uint32_t long_bytes(int D) {
  return 5u * kQRows * 2 * D + 8u * (2 * kStages + 1) + 1024u;
}

inline bool long_plan(int D, int Sk, Plan* pl) {
  if ((D != 64 && D != 128) || Sk < 0) return false;
  *pl = Plan{(Sk + kFull - 1) / kFull, 0, 0, kStages, 1,
             (uint32_t)(2 * kFull * 2 * D), long_bytes(D)};
  return true;
}

}  // namespace sm90short
