// The launch plan of kernel 4 (csrc/conv3d.cu), in plain C++ with no CUDA
// header: the kernel lays out its shared memory and its grid by it and
// launches only the plan it computes itself, and csrc/conv_plan.cpp, built
// by the host's C++ compiler, exports it to the wrapper
// (ops/conv3d.py::conv_plan) and to the CPU tests.
//
// A plan has one of three routes, a function of (taps, W, Cin, Cout, x's
// type) alone, so that the order of every output's sums is too:
//   kTile  the implicit GEMM: a block computes a box of output pixels (F
//          frames x R rows x BW columns, at most 256) for an N-wide slice of
//          Cout, its K loop walking (channel chunk) x (temporal tap);
//   kWalk  Cout <= 8 at 3 temporal taps (Cin <= 112, so that the whole
//          weight stays in shared memory): a block walks the input frames of
//          a run of output frames over one spatial box, each input frame
//          staged once and each of its fragments fed to the three output
//          frames that read it (three accumulators, rotated);
//   kFold  Cin <= 8 at 3 temporal taps, or Cin <= 4 into one Cout slice at
//          one: (tap, channel) folded into K, two taps of 8 channels a k16
//          step (14 steps for 27 taps, 5 for 9), a block walking a run of
//          output frames over one spatial box.
// The box, the run of frames, the stages and the grid may follow H and T;
// none of them changes the order of the sums.

#pragma once

// The kernel's device code calls round1024 too
#ifdef __CUDACC__
#define CONV4_HD __host__ __device__
#else
#define CONV4_HD
#endif

namespace conv4 {

constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kRows = 256;           // output pixels (M rows) a block
constexpr int kSmemLimit = 232448;   // 227 KB a block may use
constexpr int kMaxStages = 4;
constexpr int kTileSlab = 340;       // the 8 x 32 box's slab, 10 x 34
constexpr int kBoxSlab = 432;        // the most pixels another box's slab has
constexpr int kWalkMaxCinP = 112;    // the walk keeps 27 x CinP x 16 weights
constexpr int kSlabOverhead = 80;    // a slice's restaging, in columns (N)
constexpr int kFoldSlabs = 8;        // the fold's ring of input-frame slabs

enum Route : int { kTile = 0, kWalk = 1, kFold = 2 };
enum Src : int { kTmaBf16 = 0, kTmaF32 = 1, kManual = 2 };

CONV4_HD constexpr unsigned round1024(unsigned b) { return (b + 1023u) & ~1023u; }
constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
constexpr int round16(int n) { return (n + 15) / 16 * 16; }

struct Box {
  int f, r, w;       // output frames, rows, columns
};

struct Plan {
  int route;          // Route
  int n, nslices;     // Cout slice a block, and slices
  int ck;             // channels a stage (kTile, kWalk); 8 (kFold)
  int cin_p, cout_p;  // the prepared weight's padded Cin and Cout
  int taps_k;         // its leading dimension: 9 x taps (27 + 1 or 9 + 1 in kFold)
  int src;            // Src: how x reaches shared memory
  int stages, nstg;   // ring stages (kFold: input-frame slabs), fp32 staging
  int box_f, box_r, box_w;        // output box a block
  int slab_pix;       // input pixels of one frame's slab (times box_f in kTile)
  int tiles_f, tiles_h, tiles_w;  // boxes over T (per batch row), H and W
  int walk;           // output frames a block (kWalk, kFold; else box_f)
  int ksteps;         // k16 steps of one stage: CK / 16 x 9 (kFold: taps_k / 2)
  int sw_bytes;       // swizzle of the weight panels (and their row bytes)
  unsigned w_bytes;   // weights a stage (kTile) or resident (kWalk, kFold)
  unsigned stage_bytes, stg_bytes, epilogue_bytes, smem;
  long long blocks;
};

// N of a Cout padded to cout_p: the widest of 160, 128, 96, 32, 16 that
// divides it; where that is 160 and Cout is a multiple of 128 too, 128
// where the launch's blocks of one slice fill fewer waves of N + 80
// columns (each slice restages x and reloads every fragment). Both stage
// the same channels a step, so the sums keep their order.
inline int widest_slice(int cout_p) {
  const int widths[5] = {160, 128, 96, 32, 16};
  for (int i = 0; i < 5; ++i)
    if (widths[i] <= cout_p && cout_p % widths[i] == 0) return widths[i];
  return 0;
}

inline int slice_width(int cout_p, long long blocks, int sms) {
  const int n = widest_slice(cout_p);
  if (n != 160 || blocks <= 0 || cout_p % 128) return n;
  const long long c160 = cdiv(cout_p / 160 * blocks, sms) * (160 + kSlabOverhead);
  const long long c128 = cdiv(cout_p / 128 * blocks, sms) * (128 + kSlabOverhead);
  return c128 < c160 ? 128 : 160;
}

// The output box of a block. A width that is a multiple of 32 keeps the
// 8 x 32 box the kernel was first built around. Any other width takes, of
// the boxes of at most 256 pixels (any width ceil(W / k) of at least 4
// columns, any rows, and where a box holds whole frames up to max_f
// frames) whose slab has at most kBoxSlab pixels, the one that loads the
// fewest bytes over the launch: boxes x (row_cost + x_cost x slab pixels),
// row_cost the weights a box streams for each input channel (18 N bytes in
// kTile, none where they are resident), x_cost the bytes of one input
// element as staged. A tie goes to fewer boxes.
inline Box choose_box(int T, int H, int W, int max_f, long long row_cost,
                      long long x_cost) {
  if (W % 32 == 0) return Box{1, 8, 32};
  Box best{1, 1, 1};
  long long best_cost = -1, best_tiles = 0;
  for (int k = 1; k <= 16; ++k) {
    const int bw = (int)cdiv(W, k);
    if (k > 1 && bw == (int)cdiv(W, k - 1)) continue;
    if (bw < (W < 4 ? W : 4) || bw + 2 > 256 || bw > kRows) continue;
    const int rmax = kRows / bw < H ? kRows / bw : H;
    for (int r = rmax; r >= 1; --r) {
      if (r + 2 > 256) continue;
      int fmax = r == H ? kRows / (H * bw) : 1;
      if (fmax > max_f) fmax = max_f;
      for (int f = fmax > 0 ? fmax : 1; f >= 1; --f) {
        const long long slab = (long long)f * (r + 2) * (bw + 2);
        if (slab > kBoxSlab) continue;
        const long long tiles = cdiv(T, f) * cdiv(H, r) * cdiv(W, bw);
        const long long cost = tiles * (row_cost + x_cost * slab);
        if (best_cost < 0 || cost < best_cost ||
            (cost == best_cost && tiles < best_tiles)) {
          best = Box{f, r, bw};
          best_cost = cost;
          best_tiles = tiles;
        }
      }
    }
  }
  return best;
}

// Output frames a walking block covers: all T of its batch row, cut into
// the fewest equal runs that give the launch two waves of blocks.
inline int walk_frames(int B, int T, long long spatial, long long slices,
                       int sms) {
  for (int k = 1; k <= T; ++k)
    if ((long long)B * k * spatial * slices >= 2LL * sms || k == T)
      return (int)cdiv(T, k);
  return T;
}

// The plan of a causal conv with `taps` temporal taps (3, or 1: a 3x3 conv
// of every frame) over x [B, T + taps - 1, H, W, Cin] of bf16 (x_bf16) or
// fp32, read by TMA where x_tma (rows of Cin elements a multiple of 16
// bytes, x 16-byte aligned), for a card of `sms` SMs. False where no route
// takes the shape.
inline bool make_plan(int taps, int B, int T, int H, int W, int Cin, int Cout,
                      int x_bf16, int x_tma, int sms, Plan* p) {
  if ((taps != 1 && taps != 3) || B < 1 || T < 1 || H < 1 || W < 1 ||
      Cin < 1 || Cout < 1 || sms < 1)
    return false;
  Plan q{};
  q.cout_p = round16(Cout);
  if (Cin <= 8 && (taps == 3 || (Cin <= 4 && q.cout_p <= 128))) {
    q.route = kFold;
  } else if (Cout <= 8 && taps == 3 && round16(Cin) <= kWalkMaxCinP) {
    q.route = kWalk;
  } else {
    q.route = kTile;
  }
  const int elem = x_bf16 ? 2 : 4;
  // the widest N that divides CoutP, before the wave model's 160 / 128
  const int n_wide = widest_slice(q.cout_p);
  // where a block's time is its slab's, not its K loop's (N = 16: the
  // weights stream little; CinP x taps < 128: a few stages a block) the
  // 8 x 32 box, whose slab rows are long TMA segments and whose index
  // arithmetic is compile-time, measured faster at W >= 32 than boxes of
  // fewer bytes (the SVD UNet's and VAE's Cout 4 / 8 and Cin 4 / 8 at
  // 64 x 104)
  const bool short_k = n_wide == 16 || round16(Cin) * taps < 128;
  const Box box =
      q.route == kTile && short_k && W >= 32 ? Box{1, 8, 32}
      : q.route == kTile ? choose_box(T, H, W, T, 18LL * n_wide, elem)
      : q.route == kWalk ? choose_box(T, H, W, 1, 0, elem)
                         : choose_box(T, H, W, 1, kRows, 1);
  q.box_f = box.f;
  q.box_r = box.r;
  q.box_w = box.w;
  q.tiles_f = (int)cdiv(T, box.f);
  q.tiles_h = (int)cdiv(H, box.r);
  q.tiles_w = (int)cdiv(W, box.w);
  const int frame_pix = (box.r + 2) * (box.w + 2);
  q.slab_pix = box.f * frame_pix;
  const long long spatial = (long long)q.tiles_h * q.tiles_w;

  if (q.route == kFold) {
    q.n = slice_width(q.cout_p, 0, sms);
    q.nslices = q.cout_p / q.n;
    q.ck = 8;
    q.cin_p = 8;
    q.taps_k = 9 * taps + 1;
    q.ksteps = q.taps_k / 2;
    q.src = kManual;
    q.nstg = 0;
    q.sw_bytes = q.n % 64 == 0 ? 128 : (q.n % 32 == 0 ? 64 : 32);
    q.w_bytes = (unsigned)q.taps_k * 8u * q.n * 2u;
    q.stage_bytes = round1024((unsigned)frame_pix * 16u);   // one frame
    q.stg_bytes = 0;
    q.epilogue_bytes = 0;
    q.walk = walk_frames(B, T, spatial, q.nslices, sms);
    q.tiles_f = (int)cdiv(T, q.walk);
    // a ring of input-frame slabs: the KT read by the output frame in hand
    // and the producer's, 4 to kFoldSlabs
    const unsigned fixed = round1024(q.w_bytes);
    q.stages = 0;
    for (int st = kFoldSlabs; st >= 4; --st)
      if (1024u + fixed + st * q.stage_bytes + 8u * (2 * st + 1) <=
          (unsigned)kSmemLimit) {
        q.stages = st;
        break;
      }
    if (q.stages == 0) return false;
    q.smem = 1024u + fixed + q.stages * q.stage_bytes + 8u * (2 * q.stages + 1);
  } else {
    q.cin_p = round16(Cin);
    q.taps_k = 9 * taps;
    const bool tma = x_tma && (Cin * elem) % 16 == 0;
    q.src = !tma ? kManual : (x_bf16 ? kTmaBf16 : kTmaF32);
    const int opts2[2] = {2, 1}, opts0[1] = {0};
    const int* opts = q.src == kTmaF32 ? opts2 : opts0;
    const int nopts = q.src == kTmaF32 ? 2 : 1;
    if (q.route == kWalk) {
      q.n = 16;
      q.nslices = q.cout_p / 16;
      q.ck = q.cin_p % 32 == 0 ? 32 : 16;
      q.sw_bytes = 32;
      q.w_bytes = (unsigned)q.taps_k * q.cin_p * q.n * 2u;
      q.stage_bytes = round1024((unsigned)frame_pix * q.ck * 2u);
      q.stg_bytes = round1024((unsigned)frame_pix * q.ck * 4u);
      q.epilogue_bytes = 0;
      q.walk = walk_frames(B, T, spatial, q.nslices, sms);
      q.tiles_f = (int)cdiv(T, q.walk);
      const unsigned fixed = round1024(q.w_bytes);
      q.stages = 0;
      for (int o = 0; o < nopts && q.stages == 0; ++o)
        for (int st = kMaxStages; st >= 2; --st) {
          const unsigned total = 1024u + fixed + st * q.stage_bytes +
                                 opts[o] * q.stg_bytes +
                                 8u * (2 * st + opts[o] + 1);
          if (total <= (unsigned)kSmemLimit) {
            q.stages = st;
            q.nstg = opts[o];
            break;
          }
        }
      if (q.stages == 0) return false;
      q.smem = 1024u + fixed + q.stages * q.stage_bytes + q.nstg * q.stg_bytes +
               8u * (2 * q.stages + q.nstg + 1);
    } else {
      q.walk = box.f;
      auto total = [&](int n, int ck, int slab, int st, int nstg) {
        const unsigned stage = round1024(9u * ck * n * 2u) +
                               round1024((unsigned)slab * ck * 2u);
        const unsigned stg = round1024((unsigned)slab * ck * 4u);
        const unsigned ring = st * stage + nstg * stg;
        const unsigned epi = 4u * kRows * (n + 8);
        return 1024u + (ring > epi ? ring : epi) + 8u * (2 * st + nstg);
      };
      // the channel chunk: 32 where it divides CinP and two stages fit,
      // else 16. At three taps the chunk sets the order of the sums (the K
      // loop interleaves chunks and temporal taps), so it is taken at the
      // widest N and the route's largest slab and follows the route alone;
      // at one tap the order is the same for either chunk (each 16-channel
      // block's nine taps in turn), and it is taken at the launch's own N
      // and slab.
      q.n = slice_width(q.cout_p, (long long)B * q.tiles_f * spatial, sms);
      const int ck_n = taps == 3 ? n_wide : q.n;
      const int ck_slab = taps == 1 ? q.slab_pix
                          : W % 32 == 0 ? kTileSlab : kBoxSlab;
      q.ck = 16;
      if (q.cin_p % 32 == 0)
        for (int o = 0; o < nopts; ++o)
          if (total(ck_n, 32, ck_slab, 2, opts[o]) <= (unsigned)kSmemLimit)
            q.ck = 32;
      q.nslices = q.cout_p / q.n;
      q.sw_bytes = q.n % 64 == 0 ? 128 : (q.n % 32 == 0 ? 64 : 32);
      q.epilogue_bytes = 4u * kRows * (q.n + 8);
      q.stages = 0;
      for (int o = 0; o < nopts && q.stages == 0; ++o)
        for (int st = kMaxStages; st >= 2; --st)
          if (total(q.n, q.ck, q.slab_pix, st, opts[o]) <= (unsigned)kSmemLimit) {
            q.stages = st;
            q.nstg = opts[o];
            break;
          }
      if (q.stages == 0) {
        q.stages = 2;
        q.nstg = opts[nopts - 1];
      }
      q.w_bytes = 9u * q.ck * q.n * 2u;
      q.stage_bytes = round1024(q.w_bytes) +
                      round1024((unsigned)q.slab_pix * q.ck * 2u);
      q.stg_bytes = round1024((unsigned)q.slab_pix * q.ck * 4u);
      q.smem = total(q.n, q.ck, q.slab_pix, q.stages, q.nstg);
      if (q.smem > (unsigned)kSmemLimit) return false;
    }
    q.ksteps = q.ck / 16 * 9;
  }
  q.blocks = (long long)q.nslices * B * q.tiles_f * spatial;
  *p = q;
  return true;
}

}  // namespace conv4
