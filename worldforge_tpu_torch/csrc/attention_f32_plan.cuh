// The launch plan of kernel 1's fp32 forward, in plain C++ with no CUDA
// header: attention_f32_wide_sm90.cuh lays its two passes out by it,
// csrc/flash_attention.cu holds the one-pass kernels of
// attention_f32_sm90.cuh to it (static_asserts) and runs only the
// instantiations it names, and csrc/flash_plan.cpp, built by the host's C++
// compiler, exports it to the wrapper (ops/flash_attention.py::_fwd_plan)
// and to the CPU tests.

#pragma once

#include <cstdint>

// The two-pass kernels of head dims 384 and 512 (attention_f32_wide_sm90.cuh)
namespace sm90f32w {

constexpr int kRows = 128;        // query rows a block, both passes
constexpr int kScoreKeys = 128;   // pass 1: keys a block (S tile width)
constexpr int kDepth = 32;        // pass 1: depth a stage (one swizzle panel)
constexpr int kScoreStages = 4;
constexpr int kKeys = 32;         // pass 2: keys a stage
constexpr int kCols = 128;        // pass 2: columns of O a block
constexpr int kStages = 3;
constexpr int kThreads = 384;     // producer / splitter + 2 consumer warpgroups
constexpr uint32_t kTile = 16384; // bytes of each shared-memory tile
constexpr uint32_t kSmemLimit = 232448;

// Pass 1 a stage: Q raw, K hi, K lo; pass 2 a stage: S, V raw, V^T hi, V^T
// lo. Then 3 mbarriers a stage (full, planes ready, empty) and 1 KB to
// align the base to the 128-byte swizzle's 1024-byte atom.
constexpr uint32_t kScoreBars = 3 * kTile * kScoreStages;
constexpr uint32_t kScoreSmem = kScoreBars + 8 * 3 * kScoreStages + 1024;
constexpr uint32_t kPVBars = 4 * kTile * kStages;
constexpr uint32_t kPVSmem = kPVBars + 8 * 3 * kStages + 1024;
static_assert(kRows * kDepth * 4 == kTile && kScoreKeys * kDepth * 4 == kTile,
              "one 16 KB tile of Q and of K a pass-1 stage");
static_assert(kRows * kKeys * 4 == kTile && kKeys * kCols * 4 == kTile,
              "one 16 KB tile of S and of V a pass-2 stage");
static_assert(kScoreSmem <= kSmemLimit && kPVSmem <= kSmemLimit,
              "227 KB of shared memory a block");

// Key tiles of pass 1 (at least one, so the scratch's layout is never
// empty) and the scratch bytes a chunk of `chunk_tiles` row tiles needs: S
// [chunk_tiles * 128][nkt * 128] and the partials [chunk_tiles * 128][nkt]
// (max, sum), both fp32.
constexpr int score_tiles(int Sk) {
  return Sk > 0 ? (Sk + kScoreKeys - 1) / kScoreKeys : 1;
}
constexpr long long scratch_bytes(int Sk, int chunk_tiles) {
  return (long long)chunk_tiles * kRows * score_tiles(Sk) * (kScoreKeys * 4 + 8);
}

}  // namespace sm90f32w

namespace f32plan {

// How the fp32 forward cuts a call; the pass-1 fields, `cols`,
// `score_key_tiles` and `scratch` are 0 for the one-pass kernels.
struct Plan {
  int rows;             // query rows a block (both passes)
  int key_tile;         // keys a ring stage (pass 2's)
  int stages;           // ring stages (pass 2's)
  int threads;          // a block
  int smem;             // dynamic shared memory (pass 2's)
  int score_tile;       // pass 1: keys a block
  int score_stages;     // pass 1: depth stages
  int score_smem;       // pass 1: dynamic shared memory
  int cols;             // pass 2: columns of O a block
  int score_key_tiles;  // pass 1: key tiles of the call
  long long scratch;    // bytes of scratch a chunk
};

// The one-pass kernels (attention_f32_sm90.cuh): head dim 64 in variants 0
// (long rows) and 1 (short rows), 80 and 128 in variant 0.
constexpr bool one_pass(int D, int V) {
  return (V == 0 && (D == 64 || D == 80 || D == 128)) || (V == 1 && D == 64);
}
constexpr bool two_pass(int D, int V) { return V == 0 && (D == 384 || D == 512); }

// One-pass: two consumer warpgroups of 64 query rows (one at d 128 and in
// the short variant) and a producer / splitter warpgroup; ring stages of 64
// keys at d 64 variant 0, else 32. Shared memory: Q raw (Q's fragments in
// the consumers' registers at d <= 80 with two consumer warpgroups) or Q hi
// / lo, then per stage K hi / lo and V^T hi / lo, then with two consumer
// warpgroups raw V of each stage (with one, V lands in the V^T lo plane),
// 4 mbarriers a stage and 2 for Q, and 1 KB of alignment.
constexpr Plan one_pass_plan(int D, int V) {
  const int c = D == 128 || V == 1 ? 1 : 2;
  const int rows = 64 * c, kt = D == 64 && V == 0 ? 64 : 32, ns = 2;
  const int qplane = rows * D * 4, kplane = kt * D * 4;
  const int q_planes = D <= 80 && c == 2 ? 1 : 2, planes = c == 2 ? 5 : 4;
  return Plan{rows, kt, ns, 128 * (c + 1),
              q_planes * qplane + ns * planes * kplane + 8 * (4 * ns + 2) + 1024,
              0, 0, 0, 0, 0, 0};
}

// The plan of head dim D, variant V at Sk keys, in chunks of `chunk_tiles`
// 128-row query tiles at d 384 / 512 (at least one; 0 for the one-pass
// kernels). False where there is no such instantiation or chunk.
inline bool make_plan(int D, int V, int Sk, int chunk_tiles, Plan* pl) {
  if (one_pass(D, V)) {
    if (chunk_tiles != 0) return false;
    *pl = one_pass_plan(D, V);
    return true;
  }
  if (!two_pass(D, V) || chunk_tiles < 1) return false;
  using namespace sm90f32w;
  *pl = Plan{kRows, kKeys, kStages, kThreads, (int)kPVSmem,
             kScoreKeys, kScoreStages, (int)kScoreSmem, kCols,
             score_tiles(Sk), scratch_bytes(Sk, chunk_tiles)};
  return true;
}

}  // namespace f32plan
