// Kernel 1's bf16 forward at short key runs on Hopper (sm_90a), head dim 128
// and up to 2,048 keys: the text, CLIP, FLF2V-image and avatar-audio
// cross-attention (32 to 514 keys) and LongCat's 1,560-token conditioning
// attention. Launched by csrc/flash_attention.cu when the host's plan
// (ops/flash_attention.py::_bf16_plan) takes the short route; long rows and
// kernel 5 stay on the loop of attention_sm90.cuh. Same function: an online
// softmax over key tiles, fp32 m / l / accumulator, P rounded to bf16
// before P.V, one division by l at the end, keys at or past kv_lens[b]
// masked, a kv_len = 0 row exactly zero with m = -1e30 and l = 0.
//
// What bounds it: at 257-514 keys the products (0.08-0.21 ms of tensor-core
// time at 989 TFLOP/s for 20,280 queries x 40 heads) and Q / O's bytes
// (0.12 ms at 3.35 TB/s) are close; at 32 keys Q / O's bytes alone. The
// long-row loop runs one block per (128-query tile, head) and pays, in
// every block, Q's load before its first product and its epilogue's stores
// after the last, behind only 1-5 key tiles; it pads every tile to 128 keys
// and streams the head's K / V again for every block. Here:
//   * Persistent blocks, one an SM (the consumers hold 232 registers a
//     thread), each walking a share of the (b * H + h, query tile) items
//     (Walk below).
//   * Warpgroup 0 feeds: its warp 0 (one thread) brings K / V, its warp 1
//     (one thread) brings Q and stores O, both with TMA over 4D maps (D, H,
//     S, B). Q has QB = 2-4 buffers of 128 rows: the loads of the next
//     items are in flight while this one computes.
//   * K / V are resident where the head's padded keys fit beside the Q
//     buffers (up to 320 keys at 2 Q buffers): loaded once per head, in one
//     or two buffers (the next head's load in flight), released after the
//     block's last item of that head. Otherwise they stream through a ring
//     of two stages of 128 keys, as the long loop does, without draining it
//     between items.
//   * Key tiles are cut to the keys: 128 keys each, the last one 16, 32, 64
//     or 128 wide (the narrowest at or above the rest), run as wgmma N =
//     that width for S and that many 16-key k-steps of P.V. 257 keys are
//     128 + 128 + 16 and 32 keys one 32-key tile.
//   * Two consumer warpgroups of 64 query rows each, S = Q.K^T and O += P.V
//     as in the long loop but with Q's fragments loaded into registers once
//     an item (ldmatrix from the swizzled buffer), taking turns to issue S,
//     each issuing a tile's S behind the previous tile's P.V. The
//     epilogue writes each warpgroup's normalised O rows, bf16, into
//     its own half of the item's Q buffer in the 128-byte swizzle, and the
//     Q warp stores them with TMA (rows past Sq are clipped by the map)
//     before it loads a later item's Q into that buffer, so the stores
//     overlap the next items' products.
// Shared memory (offsets from a 1024-byte aligned base): Q buffers [QB]
// of 2 panels x [128 rows][64 columns]; then resident K and V buffers
// [KB] each [tiles][2 panels][tile width][64 columns] (K, then V), or ring
// stages [2] each K, V of 2 panels x [128 rows][64 columns]; then the
// mbarriers q_full[QB], o_ready[QB], kv_full[KB], kv_empty[KB].

#pragma once

#include "attention_sm90.cuh"
#include "attention_bf16_plan.cuh"

namespace sm90short {

using sm90::kLog2e;
using sm90::kNegInf;

struct Params {
  const int* kv_lens;   // [B] key lengths (null: every row has Sk)
  float* m;             // optional [BH, Sq] running max (null: none)
  float* l;             // optional [BH, Sq] softmax normaliser
  int Sq, Sk, H;
  float scale;
  int qtiles, items;    // query tiles a head, B * H * qtiles
  int nfull, tail, q_bufs, kv_bufs;
  uint32_t kv_unit;
  int walk;             // 0: a block's items head by head; 1: heads fastest
};

__device__ __forceinline__ int tile_width(const Params& p, int t) {
  return t < p.nfull ? kFull : p.tail;
}
__device__ __forceinline__ int kv_len_of(const Params& p, int b) {
  return p.kv_lens != nullptr ? max(0, min(p.kv_lens[b], p.Sk)) : p.Sk;
}
// The tiles that hold keys below kv_len; tiles wholly past it are skipped.
__device__ __forceinline__ int tiles_of(int kv_len) {
  return (kv_len + kFull - 1) / kFull;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// S = Q.K^T for consumer warpgroup cw's 64 rows over a key tile of width W
// into sc, issued as one wgmma group. qf: Q's A fragments of this
// warpgroup's rows (S's A operand from registers halves S's shared-memory
// reads); kt: the tile's K, panels `ps` bytes apart. The two consumer
// warpgroups take turns issuing S (named barriers 2 + cw: one waits, the
// other arrives once its S is issued), so one's softmax runs beside the
// other's products.
template <int W>
__device__ __forceinline__ void issue_s(float (&sc)[W / 2],
                                        uint32_t (&qf)[8][4], uint32_t kt,
                                        uint32_t ps, int cw) {
  using namespace sm90;
  named_sync(2 + cw);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_rk<W>(sc, qf[kk],
                smem_desc(kt + (kk / 4) * ps + (kk % 4) * 32, 16, 1024),
                kk > 0);
  wgmma_commit();
  named_arrive(3 - cw);
}

// The online softmax update of a tile of width W whose S is in sc (`valid`
// of its keys below kv_len): O rescaled, P rounded to bf16 into pa in the
// A-operand layout (k-step kk covers keys 16kk .. +15).
template <int W>
__device__ __forceinline__ void softmax_p(float (&o)[64], float (&sc)[W / 2],
                                          uint32_t (&pa)[W / 16][4],
                                          float& m0, float& m1, float& l0,
                                          float& l1, int valid, float scale,
                                          int t4) {
  using namespace sm90;
  if (valid < W) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * t4 + (e & 1) >= valid) sc[4 * j + e] = kNegInf;
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * scale);
  const float mn1 = fmaxf(m1, mx1 * scale);
  const float al0 = ex2((m0 - mn0) * kLog2e);
  const float al1 = ex2((m1 - mn1) * kLog2e);
  m0 = mn0;
  m1 = mn1;
  const float scale_log2 = scale * kLog2e;
  const float b0 = mn0 * kLog2e, b1 = mn1 * kLog2e;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
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
  for (int j = 0; j < kD / 8; ++j) {
    o[4 * j] *= al0;
    o[4 * j + 1] *= al0;
    o[4 * j + 2] *= al1;
    o[4 * j + 3] *= al1;
  }
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// O += P.V issued as one wgmma group: V [W keys, 128] MN-major, a k-step
// is 16 key rows (2048 bytes), the next 64 columns the next panel (LBO =
// ps); o and pa stay in use until it retires.
template <int W>
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         uint32_t (&pa)[W / 16][4],
                                         uint32_t vt, uint32_t ps) {
  using namespace sm90;
  pin(o);
  pin(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    wgmma_rs<kD>(o, pa[kk], smem_desc(vt + kk * 2048, ps, 1024));
  wgmma_commit();
}

// A last tile of width W, each product retired before the next step.
template <int W>
__device__ __forceinline__ void run_tile(float (&o)[64], float& m0, float& m1,
                                         float& l0, float& l1,
                                         uint32_t (&qf)[8][4], uint32_t kt,
                                         uint32_t vt, uint32_t ps, int valid,
                                         float scale, int t4, int cw) {
  using namespace sm90;
  float sc[W / 2];
  uint32_t pa[W / 16][4];
  issue_s<W>(sc, qf, kt, ps, cw);
  wgmma_wait_all();
  pin(sc);
  pin(qf);
  softmax_p<W>(o, sc, pa, m0, m1, l0, l1, valid, scale, t4);
  issue_pv<W>(o, pa, vt, ps);
  wgmma_wait_all();
  pin(o);
  pin(pa);
}

// The items of this block: its j-th of `count` is batch row b, head h,
// first query q0 (bh = b * H + h). Walk 0: the items numbered (bh, query
// tile), block x taking the run [x * items / grid, (x + 1) * items /
// grid), so resident K / V serve a run of one head's items. Walk 1:
// numbered (b, query tile, h), block x taking every grid-th from x, so the
// blocks in flight read every head of the same tokens.
struct Walk {
  int first, count;
  __device__ explicit Walk(const Params& p) {
    const int x = blockIdx.x, grid = gridDim.x;
    if (p.walk == 1) {
      first = x;
      count = (p.items - x + grid - 1) / grid;
    } else {
      first = (int)((long)x * p.items / grid);
      count = (int)((long)(x + 1) * p.items / grid) - first;
    }
  }
};

struct Item {
  int bh, b, h, q0;
  __device__ Item(const Params& p, const Walk& w, int j) {
    if (p.walk == 1) {
      const int it = w.first + j * (int)gridDim.x;
      h = it % p.H;
      const int r = it / p.H;
      q0 = (r % p.qtiles) * kQRows;
      b = r / p.qtiles;
      bh = b * p.H + h;
    } else {
      const int it = w.first + j;
      bh = it / p.qtiles;
      q0 = (it % p.qtiles) * kQRows;
      b = bh / p.H;
      h = bh % p.H;
    }
  }
};

template <bool Resident>
__global__ void __launch_bounds__(kThreads, 1)
attn_short_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap to,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tk16,
                  const __grid_constant__ CUtensorMap tv16, const Params p) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv0 = base + p.q_bufs * kQBytes;
  const uint32_t qfull0 = kv0 + p.kv_bufs * p.kv_unit;
  const uint32_t oready0 = qfull0 + 8 * p.q_bufs;
  const uint32_t kvfull0 = oready0 + 8 * p.q_bufs;
  const uint32_t kvempty0 = kvfull0 + 8 * p.kv_bufs;
  const Walk w(p);
  const int cnt = w.count;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.q_bufs; ++i) {
      mbar_init(qfull0 + 8 * i, 1);
      mbar_init(oready0 + 8 * i, 8);   // one arrival per consumer warp
    }
    for (int i = 0; i < p.kv_bufs; ++i) {
      mbar_init(kvfull0 + 8 * i, 1);
      mbar_init(kvempty0 + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      // K / V: tile t of a head is keys [128t, 128t + width), loaded as
      // 128-row boxes, or 16-row boxes for a narrower last tile
      auto load_tile = [&](uint32_t kd, uint32_t vd, uint32_t ps, int t,
                           const Item& x, uint32_t bar) {
        const int wd = tile_width(p, t), key0 = t * kFull;
        const bool big = wd == kFull;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          for (int r = 0; r < (big ? 1 : wd / 16); ++r) {
            const uint32_t off = c * ps + r * 2048;
            tma_load_4d(kd + off, big ? &tk : &tk16, bar, c * 64, x.h,
                        key0 + 16 * r, x.b);
            tma_load_4d(vd + off, big ? &tv : &tv16, bar, c * 64, x.h,
                        key0 + 16 * r, x.b);
          }
      };
      int loads = 0, prev = -1;
      for (int j = 0; j < cnt; ++j) {
        const Item x(p, w, j);
        if (Resident && x.bh == prev) continue;
        prev = x.bh;
        const int n = tiles_of(kv_len_of(p, x.b));
        if (Resident) {
          if (n == 0) continue;
          const int kb = loads % p.kv_bufs;
          mbar_wait(kvempty0 + 8 * kb, ((loads / p.kv_bufs) & 1) ^ 1);
          uint32_t bytes = 0;
          for (int t = 0; t < n; ++t) bytes += 2u * tile_width(p, t) * kRowBytes;
          const uint32_t bar = kvfull0 + 8 * kb;
          mbar_expect_tx(bar, bytes);
          const uint32_t kd = kv0 + kb * p.kv_unit, vd = kd + p.kv_unit / 2;
          for (int t = 0; t < n; ++t)
            load_tile(kd + t * kFull * kRowBytes, vd + t * kFull * kRowBytes,
                      tile_width(p, t) * 128u, t, x, bar);
          ++loads;
        } else {
          for (int t = 0; t < n; ++t, ++loads) {
            const int s = loads % kStages;
            mbar_wait(kvempty0 + 8 * s, ((loads / kStages) & 1) ^ 1);
            const uint32_t bar = kvfull0 + 8 * s;
            mbar_expect_tx(bar, 2u * tile_width(p, t) * kRowBytes);
            const uint32_t kd = kv0 + s * kStageBytes;
            load_tile(kd, kd + kStageBytes / 2, kQPanel, t, x, bar);
          }
        }
      }
    } else if (threadIdx.x == 32) {
      // Q in, O out: item j's Q goes into buffer j % QB once the O of item
      // j - QB, which the consumers wrote there, has been read by its
      // store. The O of up to QB - 2 later items is stored first, so that
      // many stores stay in flight behind it.
      auto rows = [&](int j, bool load) {
        const Item x(p, w, j);
        const uint32_t buf = base + (j % p.q_bufs) * kQBytes;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t s = buf + c * kQPanel + half * (kQPanel / 2);
            if (load)
              tma_load_4d(s, &tq, qfull0 + 8 * (j % p.q_bufs), c * 64, x.h,
                          x.q0 + 64 * half, x.b);
            else
              tma_store_4d(&to, s, c * 64, x.h, x.q0 + 64 * half, x.b);
          }
      };
      int stored = 0;
      auto store_through = [&](int last) {
        for (; stored <= last; ++stored) {
          mbar_wait(oready0 + 8 * (stored % p.q_bufs),
                    (stored / p.q_bufs) & 1);
          rows(stored, false);
          bulk_commit();
        }
      };
      for (int j = 0; j < cnt; ++j) {
        if (j >= p.q_bufs) {
          const int jo = j - p.q_bufs;
          store_through(min(jo + p.q_bufs - 2, cnt - 1));
          switch (stored - 1 - jo) {   // stores younger than item jo's
            case 0: bulk_wait_read<0>(); break;
            case 1: bulk_wait_read<1>(); break;
            default: bulk_wait_read<2>(); break;
          }
        }
        mbar_expect_tx(qfull0 + 8 * (j % p.q_bufs), kQBytes);
        rows(j, true);
      }
      store_through(cnt - 1);
      bulk_wait<0>();
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                       // query rows 64cw ..
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    int loads = 0, prev = -1;
    if (cw == 1) named_arrive(2);                // the first goes first
    for (int j = 0; j < cnt; ++j) {
      const Item x(p, w, j);
      const int kv_len = kv_len_of(p, x.b);
      const int n = tiles_of(kv_len);
      const int buf = j % p.q_bufs;
      const uint32_t qb = base + buf * kQBytes;
      float o[kD / 2];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf;   // running max of rows g, g + 8
      float l0 = 0.f, l1 = 0.f;           // this thread's part of their sums
      mbar_wait(qfull0 + 8 * buf, (j / p.q_bufs) & 1);
      int kb = 0;
      if (Resident && n > 0) {
        if (x.bh != prev) ++loads;
        kb = (loads - 1) % p.kv_bufs;
        mbar_wait(kvfull0 + 8 * kb, ((loads - 1) / p.kv_bufs) & 1);
      }
      prev = x.bh;
      // Q's A fragments: k-step kk is columns 16kk .. +15 of this warp's
      // 16 rows, lanes 0-15 giving the rows of chunk 2kk, lanes 16-31 of
      // chunk 2kk + 1, in the buffer's 128-byte swizzle
      uint32_t qf[8][4];
      if (n > 0) {
        const int row = cw * 64 + warp * 16 + (lane & 15);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const int c = 2 * kk + (lane >> 4);
          ldmatrix_x4(qf[kk], qb + (c / 8) * kQPanel + row * 128 +
                                  (((c % 8) ^ (row & 7)) << 4));
        }
      }
      // tile t's K, V, panel stride and ring stage (streamed: waits for it)
      auto tile = [&](int t, uint32_t& kt, uint32_t& vt, uint32_t& ps,
                      int& s) {
        if (Resident) {
          kt = kv0 + kb * p.kv_unit + t * kFull * kRowBytes;
          vt = kt + p.kv_unit / 2;
          ps = tile_width(p, t) * 128u;
        } else {
          s = (loads + t) % kStages;
          mbar_wait(kvfull0 + 8 * s, ((loads + t) / kStages) & 1);
          kt = kv0 + s * kStageBytes;
          vt = kt + kStageBytes / 2;
          ps = kQPanel;
        }
      };
      auto release = [&](int s) {
        if (Resident) return;
        __syncwarp();
        if (lane == 0) mbar_arrive(kvempty0 + 8 * s);
      };
      // the 128-key tiles with S(t + 1) issued behind O += P(t).V(t), so
      // the tensor cores take the next tile's product while this one's
      // retires; then a narrower last tile alone
      int t = 0;
      {
        const int nf = min(n, p.nfull);
        if (nf > 0) {
          float sc[kFull / 2];
          uint32_t pa[kFull / 16][4];
          uint32_t kt, vt, ps;
          int s = 0;
          tile(0, kt, vt, ps, s);
          issue_s<kFull>(sc, qf, kt, ps, cw);
          wgmma_wait<0>();
          pin(sc);
          pin(qf);
          for (; t < nf; ++t) {
            const uint32_t vt_t = vt, ps_t = ps;
            const int s_t = s;
            softmax_p<kFull>(o, sc, pa, m0, m1, l0, l1, kv_len - t * kFull,
                             p.scale, t4);
            issue_pv<kFull>(o, pa, vt_t, ps_t);
            if (t + 1 < nf) {
              tile(t + 1, kt, vt, ps, s);
              issue_s<kFull>(sc, qf, kt, ps, cw);
              wgmma_wait<1>();   // P(t).V(t) has retired
              release(s_t);
              wgmma_wait<0>();
              pin(sc);
              pin(qf);
            } else {
              wgmma_wait<0>();
              release(s_t);
            }
            pin(o);
            pin(pa);
          }
        }
      }
      for (; t < n; ++t) {
        uint32_t kt, vt, ps;
        int s = 0;
        tile(t, kt, vt, ps, s);
        const int valid = kv_len - t * kFull;
        switch (tile_width(p, t)) {
          case 16: run_tile<16>(o, m0, m1, l0, l1, qf, kt, vt, ps, valid, p.scale, t4, cw); break;
          case 32: run_tile<32>(o, m0, m1, l0, l1, qf, kt, vt, ps, valid, p.scale, t4, cw); break;
          case 64: run_tile<64>(o, m0, m1, l0, l1, qf, kt, vt, ps, valid, p.scale, t4, cw); break;
          default: run_tile<128>(o, m0, m1, l0, l1, qf, kt, vt, ps, valid, p.scale, t4, cw); break;
        }
        release(s);
      }
      if (!Resident) loads += n;
      // the block's last item of this head gives the resident K / V back
      if (Resident && n > 0 &&
          (j + 1 == cnt || Item(p, w, j + 1).bh != x.bh)) {
        __syncwarp();
        if (lane == 0) mbar_arrive(kvempty0 + 8 * kb);
      }

      // epilogue: the row sums are spread over the 4 lanes of a row group
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
      const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
      // O rows r0, r1 of this warpgroup's half, bf16 in the 128-byte
      // swizzle: column 8j + 2t4 is 16-byte chunk j % 8 of panel j / 8,
      // the chunk XORed with the row's place in its 8-row atom
      const int r0 = warp * 16 + g;
      unsigned char* half = gbase + (qb - base) + cw * (kQPanel / 2);
#pragma unroll
      for (int jj = 0; jj < kD / 8; ++jj) {
        const uint32_t off = (jj / 8) * kQPanel + (((jj % 8) ^ (r0 & 7)) << 4) +
                             4 * t4;
        *reinterpret_cast<uint32_t*>(half + off + r0 * 128) =
            pack_bf16(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
        *reinterpret_cast<uint32_t*>(half + off + (r0 + 8) * 128) =
            pack_bf16(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(oready0 + 8 * buf);
      if (p.m != nullptr && t4 == 0) {
        const int row0 = x.q0 + cw * 64 + r0, row1 = row0 + 8;
        const long ml = (long)x.bh * p.Sq;
        if (row0 < p.Sq) {
          p.m[ml + row0] = m0;
          p.l[ml + row0] = l0;
        }
        if (row1 < p.Sq) {
          p.m[ml + row1] = m1;
          p.l[ml + row1] = l1;
        }
      }
    }
    if (cw == 0) named_sync(2);   // the second's last arrival
  }
}

// ------------------------------------------------------------ host side

// Runs plan `pl` (make_plan's for Sk) over q [B, Sq, H, 128], k / v [B,
// Sk, H, 128], o like q, on `grid` persistent blocks (1 to B * H * query
// tiles) walking their items as `walk` says (0 or 1);
// cudaErrorInvalidConfiguration for another walk or grid.
inline cudaError_t launch(const void* q, const void* k, const void* v,
                          const int* kv_lens, void* o, float* m, float* l,
                          int B, int Sq, int Sk, int H, float scale,
                          const Plan& pl, int walk, int grid,
                          cudaStream_t stream) {
  const uint64_t e = sizeof(__nv_bfloat16);
  const uint64_t dq[4] = {(uint64_t)kD, (uint64_t)H, (uint64_t)Sq,
                          (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)kD, (uint64_t)H, (uint64_t)Sk,
                          (uint64_t)B};
  const uint64_t sq[3] = {kD * e, H * kD * e, (uint64_t)Sq * H * kD * e};
  const uint64_t sk[3] = {kD * e, H * kD * e, (uint64_t)Sk * H * kD * e};
  const uint32_t box64[4] = {64, 1, 64, 1}, box128[4] = {64, 1, 128, 1},
                 box16[4] = {64, 1, 16, 1};
  Params p{};
  p.kv_lens = kv_lens;
  p.m = m;
  p.l = l;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.scale = scale;
  p.qtiles = (Sq + kQRows - 1) / kQRows;
  const long items = (long)p.qtiles * B * H;
  if ((walk != 0 && walk != 1) || items > 0x7fffffffL || grid < 1 ||
      grid > items)
    return cudaErrorInvalidConfiguration;
  CUtensorMap tq, to, tk, tv, tk16, tv16;
  cudaError_t err = sm90::make_map(&tq, q, 4, dq, sq, box64, 128);
  if (err == cudaSuccess) err = sm90::make_map(&to, o, 4, dq, sq, box64, 128);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, 4, dk, sk, box128, 128);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, 4, dk, sk, box128, 128);
  if (err == cudaSuccess) err = sm90::make_map(&tk16, k, 4, dk, sk, box16, 128);
  if (err == cudaSuccess) err = sm90::make_map(&tv16, v, 4, dk, sk, box16, 128);
  if (err != cudaSuccess) return err;
  p.items = (int)items;
  p.nfull = pl.nfull;
  p.tail = pl.tail;
  p.q_bufs = pl.q_bufs;
  p.kv_bufs = pl.kv_bufs;
  p.kv_unit = pl.kv_unit;
  p.walk = walk;
  auto kernel = pl.resident ? attn_short_kernel<true> : attn_short_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pl.smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, pl.smem, stream>>>(tq, to, tk, tv, tk16, tv16, p);
  return cudaGetLastError();
}

}  // namespace sm90short
