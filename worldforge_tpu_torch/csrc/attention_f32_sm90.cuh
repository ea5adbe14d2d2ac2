// Kernel 1's fp32 path on Hopper (sm_90a): flash attention whose two
// products each run as three TF32 wgmma products, fed by a TMA ring. Used
// by csrc/flash_attention.cu for fp32 head dims 64, 80 and 128 (the SVD
// UNet, VGGT, CLIP-H, VGGT's camera trunk); the design note is at the top
// of that file.
//
// Block layout: one block per (query tile, b * h), numbered on gridDim.x
// alone. Warpgroup 0 feeds the ring: its warp 0 issues every TMA copy (one
// thread), its warps 1-3 (96 threads) split each tile that lands into TF32
// hi / lo planes. Warpgroups 1..C are the consumers, 64 query rows each;
// two of them take turns issuing S = Q.K^T (named barriers), so one's
// softmax runs while the other's products do. Two variants (Plan below):
// 0 for long rows, 1 for short ones (d 64).
//
// Shared memory (offsets from a 1024-byte aligned base), each plane in the
// layout TMA writes and the wgmma descriptors read:
//   Q (hi), Q lo      [Rows][D], K-major, panels of PW floats (PW * 4-byte
//                     swizzle), as TMA lands Q. With two consumer
//                     warpgroups at d 64 and 80 each consumer reads its
//                     rows once and splits them in registers (S's A operand
//                     from registers); else the splitter splits the plane in
//                     place into hi and writes the lo plane
//   per stage s < NS:
//     K hi, K lo      [KT][D], as Q; TMA lands raw K in the hi plane, split
//                     in place
//     Vt hi, Vt lo    [D][KT], K-major (keys inner), 128-byte swizzle, the
//                     keys of each 8-key step in the order 0 2 4 6 1 3 5 7
//   V raw [NS]        [KT][D], unswizzled, as TMA lands it; with one
//                     consumer warpgroup it lands in the Vt lo plane instead
//                     and is transposed through registers
//   mbarriers         raw[NS], kready[NS], vready[NS], empty[NS], qraw,
//                     qready

#pragma once

#include "attention_sm90.cuh"

namespace sm90f32 {

constexpr float kNegInf = -1e30f;
constexpr int kSplitters = 96;   // warps 1-3 of warpgroup 0

// The launch plan of head dim D, variant V: 0 for long rows, 1 for short
// ones (one consumer warpgroup of 64 rows and 32-key tiles: at d 64 two
// blocks share an SM, so one block's loads overlap another's epilogue).
// flash_attention.cu holds it to attention_f32_plan.cuh's one_pass_plan,
// which the wrapper reads, and instantiates variant 1 at d 64 only.
template <int D, int V = 0>
struct Plan {
  static constexpr int C = D == 128 || V == 1 ? 1 : 2;  // consumer warpgroups
  static constexpr int Rows = 64 * C;             // query rows per block
  static constexpr int KT = D == 64 && V == 0 ? 64 : 32;  // keys a kv tile
  static constexpr int NS = 2;                    // ring stages
  static constexpr int Threads = 128 * (C + 1);
  // Q's split fragments in the consumers' registers (S's A from registers,
  // which halves S's shared-memory reads). At d 128 they would take 128
  // registers a thread, and the short variant keeps its threads at 128
  // registers or fewer so two blocks share an SM: there Q stays in shared
  // memory as hi / lo planes
  static constexpr bool QReg = D <= 80 && C == 2;
  static constexpr int PW = D % 32 == 0 ? 32 : 16;  // floats per Q / K panel
  static constexpr int SW = PW * 4;                 // their swizzle bytes
  static constexpr int Panels = D / PW;
  static constexpr uint32_t qplane = Rows * D * 4;
  static constexpr uint32_t kplane = KT * D * 4;  // K, V raw, each Vt plane
  static constexpr uint32_t q_hi = 0, q_lo = qplane;   // q_lo: not QReg
  // the stages: K hi / lo and Vt hi / lo planes
  __host__ __device__ static constexpr uint32_t k_hi(int s) {
    return (QReg ? 1 : 2) * qplane + 4 * kplane * s;
  }
  __host__ __device__ static constexpr uint32_t k_lo(int s) { return k_hi(s) + kplane; }
  __host__ __device__ static constexpr uint32_t vt_hi(int s) { return k_hi(s) + 2 * kplane; }
  __host__ __device__ static constexpr uint32_t vt_lo(int s) { return k_hi(s) + 3 * kplane; }
  // where TMA lands raw V: its own plane with two consumer warpgroups, the
  // Vt lo plane with one (transposed through registers); K lands in the K
  // hi plane and is split in place
  static constexpr bool VInPlace = C == 1;
  __host__ __device__ static constexpr uint32_t v_raw(int s) {
    return VInPlace ? vt_lo(s) : k_hi(NS) + kplane * s;
  }
  static constexpr uint32_t bars = k_hi(NS) + (VInPlace ? 0 : kplane * NS);
  static constexpr int nbars = 4 * NS + 2;
  static constexpr size_t bytes = bars + 8 * nbars + 1024;   // + alignment
  // S = Q K^T runs over D / 8 k-steps, summed in runs of at most 8 that are
  // added in fp32
  static constexpr int KS = D / 8;
  static constexpr int NR = (KS + 7) / 8;
  static constexpr int RK = KS / NR;
  static_assert(RK * NR == KS, "equal runs");
  static_assert(D % PW == 0 && KT % 32 == 0, "whole panels");
  static_assert(qplane % 1024 == 0 && kplane % 1024 == 0 && (D * 128) % 1024 == 0,
                "planes on swizzle-atom boundaries");
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
};

struct Params {
  const int* kv_lens;   // [B] key lengths (null: every row has Sk)
  float* o;
  float* m;   // optional [BH, Sq] running max (null: none)
  float* l;   // optional [BH, Sq] softmax normaliser
  int Sq, Sk, H;
  float scale;
};

// ------------------------------------------------------- TF32 wgmma

// D[64 x N] (+)= A[64 x 8] . B[8 x N], TF32 in, fp32 accumulate; D is
// overwritten where scale_d is 0. A and B from shared memory, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d);
// The same with A from registers: warp w of the warpgroup holds rows
// 16w + lane/4 (regs 0, 2) and 16w + lane/4 + 8 (regs 1, 3) at columns
// lane%4 (regs 0, 1) and lane%4 + 4 (regs 2, 3).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<80>(float (&d)[40],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------- the split

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both TF32 (round to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint4 split4(uint4 x, uint4& lo) {
  uint4 hi;
  split_tf32(__uint_as_float(x.x), hi.x, lo.x);
  split_tf32(__uint_as_float(x.y), hi.y, lo.y);
  split_tf32(__uint_as_float(x.z), hi.z, lo.z);
  split_tf32(__uint_as_float(x.w), hi.w, lo.w);
  return hi;
}

// Split rows [0, rows) of a plane `src` of `panels` panels of [R rows][SW
// bytes] into planes hi and lo at the same offsets (src may be hi: in
// place). The split is elementwise and a swizzle moves 16-byte chunks only
// within their row, so the layout carries over. Rows past `rows` (past the
// tensor's end or the kv length) are left: their scores are never stored
// (Q) or are masked (K).
template <int SW>
__device__ __forceinline__ void split_rows(const unsigned char* src,
                                           unsigned char* hi,
                                           unsigned char* lo, int panels,
                                           int R, int rows, int st) {
  constexpr int CH = SW / 16;   // 16-byte chunks a row
  if (rows == R) {
    for (int i = st; i < panels * R * CH; i += kSplitters) {
      uint4 l;
      const uint4 h = split4(reinterpret_cast<const uint4*>(src)[i], l);
      reinterpret_cast<uint4*>(hi)[i] = h;
      reinterpret_cast<uint4*>(lo)[i] = l;
    }
    return;
  }
  for (int i = st; i < panels * rows * CH; i += kSplitters) {
    const int pr = i / CH, pnl = pr / rows;
    const int at = (pnl * R + pr - pnl * rows) * CH + i % CH;
    uint4 l;
    const uint4 h = split4(reinterpret_cast<const uint4*>(src)[at], l);
    reinterpret_cast<uint4*>(hi)[at] = h;
    reinterpret_cast<uint4*>(lo)[at] = l;
  }
}

// Column d of 8 keys (step j) of V -> Vt hi / lo [D][KT]: keys inner,
// 128-byte swizzle (16-byte chunk c of row d at c ^ (d % 8)), the step's
// keys in the order 0 2 4 6 1 3 5 7 (P's registers hold keys 2t, 2t + 1
// where the A operand reads k-columns t, t + 4).
template <int D>
__device__ __forceinline__ void write_vt(const float (&x)[8], int d, int j,
                                         unsigned char* hi,
                                         unsigned char* lo) {
  uint32_t h[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) split_tf32(x[r], h[r], l[r]);
  const uint32_t row = (j / 4) * (D * 128) + d * 128;
  const uint32_t c0 = row + (((2 * (j % 4)) ^ (d & 7)) << 4);
  const uint32_t c1 = row + (((2 * (j % 4) + 1) ^ (d & 7)) << 4);
  *reinterpret_cast<uint4*>(hi + c0) = make_uint4(h[0], h[2], h[4], h[6]);
  *reinterpret_cast<uint4*>(hi + c1) = make_uint4(h[1], h[3], h[5], h[7]);
  *reinterpret_cast<uint4*>(lo + c0) = make_uint4(l[0], l[2], l[4], l[6]);
  *reinterpret_cast<uint4*>(lo + c1) = make_uint4(l[1], l[3], l[5], l[7]);
}

// V [KT keys][D] -> Vt hi / lo. Thread st takes column d of 8 keys at a
// time: consecutive threads read consecutive words of a key row, and eight
// consecutive d write eight rows, which the swizzle spreads over all banks.
// In place (V landed in the lo plane), every splitter reads its columns
// into registers before any writes.
template <int D, int KT, bool InPlace>
__device__ __forceinline__ void split_transpose_v(const float* v,
                                                  unsigned char* hi,
                                                  unsigned char* lo, int st) {
  constexpr int N = D * (KT / 8);
  if constexpr (!InPlace) {
    for (int u = st; u < N; u += kSplitters) {
      const int d = u % D, j = u / D;
      float x[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = v[(8 * j + r) * D + d];
      write_vt<D>(x, d, j, hi, lo);
    }
  } else {
    constexpr int U = (N + kSplitters - 1) / kSplitters;
    float x[U][8];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = st + i * kSplitters;
      if (u < N) {
        const int d = u % D, j = u / D;
#pragma unroll
        for (int r = 0; r < 8; ++r) x[i][r] = v[(8 * j + r) * D + d];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kSplitters) : "memory");
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = st + i * kSplitters;
      if (u < N) write_vt<D>(x[i], u % D, u / D, hi, lo);
    }
  }
}

// Named barrier `id` over the two consumer warpgroups: wait for the other
// one's arrival, or arrive without waiting.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Makes this thread's shared-memory writes visible to wgmma (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------- the kernel

template <int D, int V>
__global__ void __launch_bounds__(Plan<D, V>::Threads, 1)
fa_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Plan<D, V>;
  constexpr int C = L::C, KT = L::KT, NS = L::NS, PW = L::PW, SW = L::SW;
  constexpr uint64_t kSwz = SW == 128 ? 1 : 2;   // descriptor swizzle code
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - sm90::smem_u32(smem_raw));
  const uint32_t raw0 = base + L::bars;      // raw[s]: K and V landed
  const uint32_t kready0 = raw0 + 8 * NS;    // kready[s]: K's planes written
  const uint32_t vready0 = kready0 + 8 * NS; // vready[s]: Vt's planes written
  const uint32_t empty0 = vready0 + 8 * NS;  // empty[s]: consumers done
  const uint32_t qraw = empty0 + 8 * NS, qready = qraw + 8;

  const int qtiles = (p.Sq + L::Rows - 1) / L::Rows;
  const int bh = blockIdx.x / qtiles, b = bh / p.H, h = bh % p.H;
  const int q0 = (blockIdx.x % qtiles) * L::Rows;
  const int kv_len =
      p.kv_lens != nullptr ? max(0, min(p.kv_lens[b], p.Sk)) : p.Sk;
  const int n = (kv_len + KT - 1) / KT;      // tiles past kv_len are skipped
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(raw0 + 8 * s, 1);
      sm90::mbar_init(kready0 + 8 * s, kSplitters);
      sm90::mbar_init(vready0 + 8 * s, kSplitters);
      sm90::mbar_init(empty0 + 8 * s, 4 * C);   // one arrival per consumer warp
    }
    sm90::mbar_init(qraw, 1);
    sm90::mbar_init(qready, kSplitters);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------- producer + splitter
    if constexpr (C > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0 && n > 0) {
      sm90::mbar_expect_tx(qraw, L::qplane);
#pragma unroll
      for (int c = 0; c < L::Panels; ++c)
        sm90::tma_load_4d(base + L::q_hi + c * L::Rows * SW, &tq, qraw,
                          c * PW, h, q0, b);
      for (int t = 0; t < n; ++t) {
        const int s = t % NS;
        sm90::mbar_wait(empty0 + 8 * s, ((t / NS) & 1) ^ 1);
        const uint32_t bar = raw0 + 8 * s;
        sm90::mbar_expect_tx(bar, 2 * L::kplane);
#pragma unroll
        for (int c = 0; c < L::Panels; ++c)
          sm90::tma_load_4d(base + L::k_hi(s) + c * KT * SW, &tk, bar, c * PW,
                            h, t * KT, b);
        sm90::tma_load_4d(base + L::v_raw(s), &tv, bar, 0, h, t * KT, b);
      }
    } else if (threadIdx.x >= 32 && n > 0) {
      const int st = threadIdx.x - 32;
      if constexpr (!L::QReg) {
        sm90::mbar_wait(qraw, 0);
        split_rows<SW>(sm + L::q_hi, sm + L::q_hi, sm + L::q_lo, L::Panels, L::Rows,
                       min(L::Rows, p.Sq - q0), st);
        fence_async_smem();
        sm90::mbar_arrive(qready);
      }
      for (int t = 0; t < n; ++t) {
        const int s = t % NS;
        sm90::mbar_wait(raw0 + 8 * s, (t / NS) & 1);
        split_rows<SW>(sm + L::k_hi(s), sm + L::k_hi(s), sm + L::k_lo(s),
                       L::Panels, KT, min(KT, kv_len - t * KT), st);
        fence_async_smem();
        sm90::mbar_arrive(kready0 + 8 * s);
        split_transpose_v<D, KT, L::VInPlace>(
            reinterpret_cast<const float*>(sm + L::v_raw(s)),
            sm + L::vt_hi(s), sm + L::vt_lo(s), st);
        fence_async_smem();
        sm90::mbar_arrive(vready0 + 8 * s);
      }
    }
  } else {
    // ------------------------------------------------- consumers
    if constexpr (C > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int cw = wg - 1;                     // query rows 64 cw ..
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // Q's k-step kk (8 columns of 32 bytes) in panel kk / (PW / 8); this
    // warpgroup's 64 rows start 64 SW bytes into each panel
    auto qdesc = [&](uint32_t plane, int kk) {
      return sm90::smem_desc(base + plane + (kk / (PW / 8)) * L::Rows * SW +
                                 cw * 64 * SW + (kk % (PW / 8)) * 32,
                             16, 8 * SW, kSwz);
    };
    auto kdesc = [&](uint32_t plane, int kk) {
      return sm90::smem_desc(base + plane + (kk / (PW / 8)) * KT * SW +
                                 (kk % (PW / 8)) * 32,
                             16, 8 * SW, kSwz);
    };
    // Vt's k-step j: keys 8j .. 8j + 7 in panel j / 4 of D rows x 128 bytes
    auto vdesc = [&](uint32_t plane, int j) {
      return sm90::smem_desc(base + plane + (j / 4) * D * 128 + (j % 4) * 32,
                             16, 1024, 1);
    };
    const float scale_log2 = p.scale * sm90::kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;   // running max of rows g, g + 8
    float l0 = 0.f, l1 = 0.f;           // this thread's part of their sums
    // Q as S's A operand: split fragments in registers (k-step kk: rows
    // 16 warp + g (+ 8), columns 8 kk + t4 (+ 4), read from the raw plane
    // through its swizzle), or the splitter's hi / lo planes
    uint32_t qh[L::QReg ? L::KS : 1][4], ql[L::QReg ? L::KS : 1][4];
    if (n > 0) {
      if constexpr (L::QReg) {
        sm90::mbar_wait(qraw, 0);
#pragma unroll
        for (int kk = 0; kk < L::KS; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = cw * 64 + warp * 16 + g + 8 * (i & 1);
            const int c = 8 * kk + t4 + 4 * (i >> 1);
            uint32_t at = (c / PW) * L::Rows * SW + r * SW + (c % PW) * 4;
            at ^= ((at >> 7) & (SW / 16 - 1)) << 4;
            split_tf32(*reinterpret_cast<const float*>(sm + L::q_hi + at),
                       qh[kk][i], ql[kk][i]);
          }
      } else {
        sm90::mbar_wait(qready, 0);
      }
    }
    // Two consumer warpgroups take turns issuing S (named barriers 2 and
    // 3, 256 threads: one warpgroup waits, the other arrives), so one's
    // softmax overlaps the other's products on the tensor cores; the first
    // goes first.
    if constexpr (C == 2)
      if (cw == 1 && n > 0) named_arrive(2);

    for (int t = 0; t < n; ++t) {
      const int s = t % NS;
      sm90::mbar_wait(kready0 + 8 * s, (t / NS) & 1);

      // S = Q K^T: per run of RK k-steps the cross terms lo.hi and hi.lo
      // first, then hi.hi (lo.lo is below fp32 rounding); the runs are
      // added in fp32
      float sc[KT / 2];
      if constexpr (C == 2) named_sync(2 + cw);       // this one's turn
#pragma unroll
      for (int r = 0; r < L::NR; ++r) {
        float tp[KT / 2];
        sm90::wgmma_fence();
        if constexpr (L::QReg) {
          sm90::pin(qh);
          sm90::pin(ql);
        }
#pragma unroll
        for (int i = 0; i < L::RK; ++i) {
          const int kk = r * L::RK + i;
          if constexpr (L::QReg)
            wgmma_tf32_rs<KT>(tp, ql[kk], kdesc(L::k_hi(s), kk), i > 0);
          else
            wgmma_tf32_ss<KT>(tp, qdesc(L::q_lo, kk), kdesc(L::k_hi(s), kk), i > 0);
        }
#pragma unroll
        for (int i = 0; i < L::RK; ++i) {
          const int kk = r * L::RK + i;
          if constexpr (L::QReg)
            wgmma_tf32_rs<KT>(tp, qh[kk], kdesc(L::k_lo(s), kk), 1);
          else
            wgmma_tf32_ss<KT>(tp, qdesc(L::q_hi, kk), kdesc(L::k_lo(s), kk), 1);
        }
#pragma unroll
        for (int i = 0; i < L::RK; ++i) {
          const int kk = r * L::RK + i;
          if constexpr (L::QReg)
            wgmma_tf32_rs<KT>(tp, qh[kk], kdesc(L::k_hi(s), kk), 1);
          else
            wgmma_tf32_ss<KT>(tp, qdesc(L::q_hi, kk), kdesc(L::k_hi(s), kk), 1);
        }
        sm90::wgmma_commit();
        if constexpr (C == 2)
          if (r == L::NR - 1) named_arrive(3 - cw);   // the other's turn
        sm90::wgmma_wait_all();
        sm90::pin(tp);
        if constexpr (L::QReg) {
          sm90::pin(qh);
          sm90::pin(ql);
        }
#pragma unroll
        for (int e = 0; e < KT / 2; ++e) sc[e] = r == 0 ? tp[e] : sc[e] + tp[e];
      }

      // online softmax on rows g (regs 4j, 4j+1) and g + 8 (4j+2, 4j+3),
      // keys 8j + 2 t4 + {0, 1}; m is the running max of the scaled scores,
      // exp(x - m) = 2^(x log2 e - m log2 e) as one FMA and ex2
      const int valid = kv_len - t * KT;
      if (valid < KT) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t4 + (e & 1) >= valid) sc[4 * j + e] = kNegInf;
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
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
      const float al0 = sm90::ex2((m0 - mn0) * sm90::kLog2e);
      const float al1 = sm90::ex2((m1 - mn1) * sm90::kLog2e);
      m0 = mn0;
      m1 = mn1;
      const float b0 = mn0 * sm90::kLog2e, b1 = mn1 * sm90::kLog2e;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        sc[4 * j] = sm90::ex2(fmaf(sc[4 * j], scale_log2, -b0));
        sc[4 * j + 1] = sm90::ex2(fmaf(sc[4 * j + 1], scale_log2, -b0));
        sc[4 * j + 2] = sm90::ex2(fmaf(sc[4 * j + 2], scale_log2, -b1));
        sc[4 * j + 3] = sm90::ex2(fmaf(sc[4 * j + 3], scale_log2, -b1));
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = al0 * l0 + sum0;
      l1 = al1 * l1 + sum1;
      // P as the A operand, split once: k-step j's columns t4, t4 + 4 are
      // keys 8j + 2 t4, 8j + 2 t4 + 1 (Vt holds its keys in that order)
      uint32_t phi[KT / 8][4], plo[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        split_tf32(sc[4 * j], phi[j][0], plo[j][0]);
        split_tf32(sc[4 * j + 2], phi[j][1], plo[j][1]);
        split_tf32(sc[4 * j + 1], phi[j][2], plo[j][2]);
        split_tf32(sc[4 * j + 3], phi[j][3], plo[j][3]);
      }

      // this tile's P V, summed apart (a fresh accumulator) and added to O
      // in fp32
      float ot[D / 2];
      sm90::mbar_wait(vready0 + 8 * s, (t / NS) & 1);
      sm90::pin(phi);
      sm90::pin(plo);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
        wgmma_tf32_rs<D>(ot, plo[j], vdesc(L::vt_hi(s), j), j > 0);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
        wgmma_tf32_rs<D>(ot, phi[j], vdesc(L::vt_lo(s), j), 1);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
        wgmma_tf32_rs<D>(ot, phi[j], vdesc(L::vt_hi(s), j), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::pin(ot);
      sm90::pin(phi);
      sm90::pin(plo);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] = fmaf(o[4 * j], al0, ot[4 * j]);
        o[4 * j + 1] = fmaf(o[4 * j + 1], al0, ot[4 * j + 1]);
        o[4 * j + 2] = fmaf(o[4 * j + 2], al1, ot[4 * j + 2]);
        o[4 * j + 3] = fmaf(o[4 * j + 3], al1, ot[4 * j + 3]);
      }
    }

    // the second warpgroup's last arrival on the first's barrier
    if constexpr (C == 2)
      if (cw == 0 && n > 0) named_sync(2);

    // epilogue: the row sums are spread over the 4 lanes of a row group
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const int r0 = cw * 64 + warp * 16 + g, r1 = r0 + 8;
    const bool ok0 = q0 + r0 < p.Sq, ok1 = q0 + r1 < p.Sq;
    const long rs = (long)p.H * D;
    float* o0 = p.o + ((long)b * p.Sq + q0 + r0) * rs + (long)h * D + 2 * t4;
    float* o1 = p.o + ((long)b * p.Sq + q0 + r1) * rs + (long)h * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (ok0)
        *reinterpret_cast<float2*>(o0 + 8 * j) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (ok1)
        *reinterpret_cast<float2*>(o1 + 8 * j) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (p.m != nullptr && t4 == 0) {
      const long ml = (long)bh * p.Sq + q0;
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

// ------------------------------------------------------- host side

template <int D, int V>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lens, float* o, float* m, float* l, int B,
                   int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  using L = Plan<D, V>;
  // 4D maps (D, H, S, B): a ragged last tile of a batch row is zero-filled
  const uint64_t e = sizeof(float);
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)(Sk > 0 ? Sk : 1),
                          (uint64_t)B};
  const uint64_t sq[3] = {D * e, H * D * e, (uint64_t)Sq * H * D * e};
  const uint64_t sk[3] = {D * e, H * D * e, (uint64_t)Sk * H * D * e};
  const uint32_t bq[4] = {(uint32_t)L::PW, 1, (uint32_t)L::Rows, 1};
  const uint32_t bk[4] = {(uint32_t)L::PW, 1, (uint32_t)L::KT, 1};
  const uint32_t bv[4] = {(uint32_t)D, 1, (uint32_t)L::KT, 1};
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map(&tq, q, 4, dq, sq, bq, L::SW, f32);
  if (err == cudaSuccess) err = sm90::make_map(&tk, k, 4, dk, sk, bk, L::SW, f32);
  if (err == cudaSuccess) err = sm90::make_map(&tv, v, 4, dk, sk, bv, 0, f32);
  if (err != cudaSuccess) return err;
  Params p{};
  p.kv_lens = kv_lens;
  p.o = o;
  p.m = m;
  p.l = l;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.scale = scale;
  const long blocks = (long)((Sq + L::Rows - 1) / L::Rows) * B * H;
  if (blocks < 1 || blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fa_f32_wgmma_kernel<D, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::bytes);
  if (err != cudaSuccess) return err;
  fa_f32_wgmma_kernel<D, V><<<(unsigned)blocks, L::Threads, L::bytes, stream>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace sm90f32
