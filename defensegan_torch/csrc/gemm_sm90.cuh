// C = A @ B with a fused elementwise epilogue, for Hopper (sm_90a): wgmma +
// TMA. Every product of the fused projection loops runs here: v2's and
// v2i's four (fused_projection_v2.cu, fused_projection_v2i.cu), the fc
// products of v3 and v4 and v3's two packed conv-B products
// (fused_projection_v3.cu, fused_projection_v4.cu).
//
//   C[M, N] = A[M, K] @ B[K, N], then epi(row, col, c0, c1) on every pair of
//   adjacent columns (col even).
//
// Element types:
//   bf16  A [M, K] row-major, B [K, N] row-major (N-major), read as stored
//         through wgmma's transpose flag for B; f32 sums.
//   int8  A [M, K] row-major, and B given K-major as B^T [N, K]: 8-bit
//         wgmma has no transpose flag. s32 sums, exact whatever the order.
//
// What bounds it on an H100: v2's D products walk only the K slabs of
// D's (D^T's) nonzero blocks (the slab list below: 26.5% and 22.3% of the
// dense walk on the flagship), which leaves them bound by what they move,
// not by operations: h @ D by its slabs through L2 (477 MB a step at
// 10240 rows), do @ D^T by its epilogue, which reads h and writes dh
// (256 MB a step); v2i's D products, walked dense, are operations (1979
// TOP/s int8); the K = 128 fc forward is bytes (it writes h, F = 6272
// columns a row); the fc backward reads its K = 6272-deep A once. The
// design is the grid conv's (conv3x3_sm90.cuh) without the taps:
//   * a block of three warpgroups: two consumers, each computing 64 x 128
//     of the 128 x 128 tile with wgmma.mma_async (sums in registers), and
//     a producer whose one thread issues the TMA copies; setmaxnreg moves
//     the producer's registers to the consumers;
//   * 128-byte K slabs (64 bf16 or 128 int8) that TMA writes in the layout
//     wgmma reads (SWIZZLE_128B), a ring of 4 stages of 32 KB with full /
//     empty mbarriers; a box past M, N or K reads zeros, so ragged edges
//     (v2i's K 832 in 128-byte slabs, conv B's K 160, P 832 = 6.5 tiles)
//     need no padding of the operands;
//   * persistent: min(units, SMs) blocks walk the work units (m-tile, K
//     split, n-tile), n fastest, so the n-tiles of one m-tile run side by
//     side and share its A slabs in L2, and the producer loads the next
//     unit while the consumers run the epilogue;
//   * the epilogue stages each consumer's 64 x 128 sums in shared memory
//     (rows padded by 8 words against bank conflicts) and hands them on
//     row by row: a warp holds 64 consecutive columns of one row, two per
//     lane, so every load and store of the epilogue is a whole line; what
//     an epilogue reads (the relu mask h, the targets x, biases, scales)
//     is loaded into registers when the unit starts, in flight while its
//     slabs run, so the epilogue itself waits on no load;
//   * a slab list (kSlabList, with splits 1): for each n-tile
//     the K slabs whose block of B holds a nonzero, built once from B
//     (kernels/gemm.py::slab_list). The producer loads only those A and B
//     slabs; the consumers run as many, the first with scale_d 0; a tile
//     with an empty list stores zero sums. A block left out is all zero,
//     so its products are exact zeros (A finite) and the sums are the
//     dense walk's; the list does not depend on M;
//   * split-K where N fits one tile (the fc backward, N = 128: 80 tiles
//     for 132 SMs at 10240 rows, 8 at v4's 1024): `splits` fixed K ranges
//     of whole slabs, each stored as float32 partial sums in a workspace
//     [M, splits * N]; one reduction adds them in split order and runs the
//     epilogue. The count comes from the caller and depends on K and N
//     only (kernels/gemm.py::split_k_for), so a row's sums do not depend
//     on how many rows a call has; no atomics touch the sums.
// N = 832 and N = 192 take the last tile half empty: its B box reads zeros
// past N and its columns past N are not stored (7.7% more operations than
// P on v2's h @ D, 33% on v3's conv B forward; a 64-wide or 208-wide tile
// would need a second kernel shape for one or two launches a step).
//
// Requirements (checked by make_gemm and the Python wrappers): M >= 1,
// N a multiple of 64 (a warp's 64 columns of a row are all in or all out:
// an epilogue may use warp collectives), K * element size a multiple of 16
// bytes, every base 16-byte aligned, 1 <= splits <= K's slabs with every
// split non-empty, splits > 1 only in bf16, a slab list only with splits
// 1. Launches go on the caller's stream and allocate nothing.
#pragma once

#include <type_traits>

#include "sm90_common.cuh"

namespace fpk {

namespace sm90 {

constexpr int kGemmBN = 128;                  // columns per tile
constexpr int kStageLd = kGemmBN + 8;         // 32-bit words per staged row
constexpr int kStaging = kConsumers * 64 * kStageLd * 4;   // 68 KB
constexpr int kGemmStage = kABytes + kGemmBN * kSlabBytes; // 32 KB
constexpr int kGemmStages =
    (227 * 1024 - kStaging - 1024 - 256) / kGemmStage;      // 4
// ring (1024-byte aligned: the swizzle's atom), staging, barriers
constexpr int kGemmSmem =
    1024 + kGemmStages * kGemmStage + kStaging + 16 * kGemmStages;
static_assert(kGemmSmem <= 227 * 1024, "dynamic shared memory limit");

template <typename T>
struct Operand;

template <>
struct Operand<bf16> {
  using Acc = float;
  static constexpr int kPerSlab = 64;   // K per slab
  static constexpr int kStep = 16;      // K per wgmma
};

template <>
struct Operand<int8_t> {
  using Acc = int;
  static constexpr int kPerSlab = 128;
  static constexpr int kStep = 32;
};

// The work unit at position t of the walk: (m-tile, split, n-tile), the
// n-tile fastest; its slabs [s0, s1).
struct GemmUnit {
  int m0, n0, split, s0, s1;
  __device__ __forceinline__ GemmUnit(int t, int n_n, int splits,
                                      int per_split, int slabs) {
    const int nt = t % n_n;
    const int rest = t / n_n;
    split = rest % splits;
    m0 = (rest / splits) * kBM;
    n0 = nt * kGemmBN;
    s0 = split * per_split;
    s1 = min(s0 + per_split, slabs);
  }
};

template <typename Acc>
struct Pair;
template <>
struct Pair<float> {
  using T = float2;
};
template <>
struct Pair<int> {
  using T = int2;
};

struct None {};

// What an epilogue reads, by the traits of a functor with kReads: per pair
// of elements (In, from in(r, c)), per pair of columns (Col, col(c)) and per
// row (Row, row(r)); its operator() then takes them after the sums. A
// functor without kReads reads nothing (or reads it itself: the momentum
// update, which runs after the split sums) and takes the sums alone.
template <typename E, bool = E::kReads>
struct Reads {
  using In = None;
  using Col = None;
  using Row = None;
};
template <typename E>
struct Reads<E, true> {
  using In = typename E::In;
  using Col = typename E::Col;
  using Row = typename E::Row;
};

template <typename E, typename A>
__device__ __forceinline__ void invoke(const E& e, int r, int c, A a0, A a1,
                                       const typename Reads<E>::In& in,
                                       const typename Reads<E>::Col& col,
                                       const typename Reads<E>::Row& row) {
  if constexpr (E::kReads) {
    e(r, c, a0, a1, in, col, row);
  } else {
    e(r, c, a0, a1);
  }
}

// The K slabs each n-tile walks with kSlabList: tile j's are idx[off[j]]
// .. idx[off[j + 1] - 1], in increasing order (CSR, on the device).
struct SlabList {
  const int* off;   // [n-tiles + 1]
  const int* idx;   // [off[n-tiles]]
};

// The positions [x, y) of a unit's walk: its slabs [s0, s1), or with a
// slab list the entries of its n-tile's list (slab list.idx[j]).
template <bool kSlabList>
__device__ __forceinline__ int2 walk(const GemmUnit& u,
                                     const SlabList& list) {
  if constexpr (kSlabList) {
    const int nt = u.n0 / kGemmBN;
    return make_int2(list.off[nt], list.off[nt + 1]);
  } else {
    return make_int2(u.s0, u.s1);
  }
}

// split_stride: where a split's columns go in the epilogue's output (the
// workspace's N); 0 when splits == 1. `list` is read only with kSlabList.
template <typename T, typename Epi, bool kSlabList = false>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, int M, int N, int K,
              int splits, int split_stride, Epi epi, SlabList list) {
  using Op = Operand<T>;
  using Acc = typename Op::Acc;
  using P2 = typename Pair<Acc>::T;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = (base + 1023u) & ~1023u;
  Acc* staging = reinterpret_cast<Acc*>(smem_raw + (ring - base) +
                                        kGemmStages * kGemmStage);
  const uint32_t bars = ring + kGemmStages * kGemmStage + kStaging;
  auto full = [&](uint32_t s) { return bars + 8 * s; };
  auto empty = [&](uint32_t s) { return bars + 8 * (kGemmStages + s); };
  const int n_n = (N + kGemmBN - 1) / kGemmBN;
  const int slabs = (K + Op::kPerSlab - 1) / Op::kPerSlab;
  const int per_split = (slabs + splits - 1) / splits;
  const int n_units = ((M + kBM - 1) / kBM) * splits * n_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler (a shuffle from lane 0), so that no
  // wgmma sits on a path it must treat as divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full with TMA copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kConsumers * 128) return;
    uint32_t stage = 0, phase = 0;
    for (int t = blockIdx.x; t < n_units; t += gridDim.x) {
      const GemmUnit u(t, n_n, splits, per_split, slabs);
      const int2 w = walk<kSlabList>(u, list);
      for (int j = w.x; j < w.y; ++j) {
        const int i = kSlabList ? list.idx[j] : j;
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), kGemmStage);
        const uint32_t sa = ring + stage * kGemmStage;
        tma_load(sa, &map_a, full(stage), i * Op::kPerSlab, u.m0);
        if constexpr (std::is_same<T, bf16>::value) {
          // B [K, N]: two 64-column chunks of 64 K rows
#pragma unroll
          for (int h = 0; h < kGemmBN / 64; ++h)
            tma_load(sa + kABytes + h * kBChunk, &map_b, full(stage),
                     u.n0 + 64 * h, i * Op::kPerSlab);
        } else {
          // B^T [N, K]: 128 rows of one 128-byte K slab
          tma_load(sa + kABytes, &map_b, full(stage), i * Op::kPerSlab,
                   u.n0);
        }
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: rows [64*wg, 64*wg + 64) of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // where the epilogue has warp collectives (a row amax), the warp, like
    // the role, through a shuffle: its row and column conditions are then
    // warp-uniform to the compiler, so the collectives sit on no divergent
    // path (which would serialize the wgmma: warning C7518). Elsewhere the
    // plain index: on an H100 the shuffle cost the bf16 fc forward, whose
    // time is mostly its epilogue, 27%.
    const int warp = Epi::kWarpCollective
                         ? __shfl_sync(0xffffffffu, (threadIdx.x & 127) >> 5, 0)
                         : (threadIdx.x & 127) >> 5;
    const int lane = threadIdx.x & 31;
    const bool signals = (threadIdx.x & 127) == 0;
    Acc* st = staging + wg * 64 * kStageLd;
    Acc acc[kGemmBN / 2];
    uint32_t stage = 0, phase = 0;
    for (int t = blockIdx.x; t < n_units; t += gridDim.x) {
      const GemmUnit u(t, n_n, splits, per_split, slabs);
      const int col_shift = u.split * split_stride;
      // what the epilogue reads from memory (kReads: the relu mask h, the
      // targets x, biases and scales) goes into registers now, so that the
      // loads are in flight while the slabs run and the epilogue waits on
      // none. The thread's element pairs: rows row0 + rr (rr < 16) of the
      // warpgroup's 64, columns 64 * h + 2 * lane of the tile.
      const int row0 = u.m0 + 64 * wg + 16 * warp;
      typename Reads<Epi>::In in[16][kGemmBN / 64];
      typename Reads<Epi>::Col col[kGemmBN / 64];
      typename Reads<Epi>::Row row_in[16];
      if constexpr (Epi::kReads) {
#pragma unroll
        for (int h = 0; h < kGemmBN / 64; ++h)
          if (u.n0 + 64 * h < N) col[h] = epi.col(u.n0 + 64 * h + 2 * lane);
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          if (row0 + rr < M) {
            row_in[rr] = epi.row(row0 + rr);
#pragma unroll
            for (int h = 0; h < kGemmBN / 64; ++h)
              if (u.n0 + 64 * h < N)
                in[rr][h] = epi.in(row0 + rr, u.n0 + 64 * h + 2 * lane);
          }
        }
        __syncwarp();
      }
      const int2 w = walk<kSlabList>(u, list);
      if constexpr (kSlabList) {
        // zero sums, which a tile with no slab hands to its epilogue and
        // the first slab's wgmma (scale_d 0) overwrites; on every unit,
        // since a branch on the list is not warp-uniform to the compiler
#pragma unroll
        for (int q = 0; q < kGemmBN / 2; ++q) acc[q] = Acc(0);
      }
      int held = -1;         // a stage whose wgmma may still be reading it
      for (int j = w.x; j < w.y; ++j) {
        mbar_wait(full(stage), phase);
        const uint32_t sa = ring + stage * kGemmStage;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Op::kPerSlab / Op::kStep; ++kk) {
          const uint64_t da =
              sw128_desc(sa + wg * (kABytes / 2) + kk * 32, 16, 1024);
          const int scale_d = ((j - w.x) | kk) != 0;
          if constexpr (std::is_same<T, bf16>::value) {
            const uint64_t db =
                sw128_desc(sa + kABytes + kk * 16 * 128, kBChunk, 1024);
            Wgmma<kGemmBN>::mma(acc, da, db, scale_d);
          } else {
            const uint64_t db = sw128_desc(sa + kABytes + kk * 32, 16, 1024);
            WgmmaS8<kGemmBN>::mma(acc, da, db, scale_d);
          }
        }
        wgmma_commit();
        // the previous slab's products are done: release its stage
        wgmma_wait<1>();
        if (signals && held >= 0) mbar_arrive(empty(held));
        __syncwarp();
        held = static_cast<int>(stage);
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (held >= 0) {
        wgmma_wait<0>();
        if (signals) mbar_arrive(empty(held));
        __syncwarp();
      }
      fence_regs(acc);
      // stage the sums: thread (warp, lane) holds rows 16*warp + lane/4
      // (+ 8) and, per 8-column block j, columns 8j + 2*(lane % 4) (+ 1).
      // The warpgroup's previous unit must be read out first.
      named_barrier(1 + wg, 128);
      {
        const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
        for (int j = 0; j < kGemmBN / 8; ++j) {
          const int c = 8 * j + 2 * (lane & 3);
          *reinterpret_cast<P2*>(st + r0 * kStageLd + c) =
              P2{acc[4 * j], acc[4 * j + 1]};
          *reinterpret_cast<P2*>(st + (r0 + 8) * kStageLd + c) =
              P2{acc[4 * j + 2], acc[4 * j + 3]};
        }
      }
      named_barrier(1 + wg, 128);
      // hand the tile on row by row: warp w takes rows 16w .. 16w + 15,
      // each in 64-column passes, two columns a lane
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
#pragma unroll
        for (int h = 0; h < kGemmBN / 64; ++h) {
          const int c = 64 * h + 2 * lane;
          if (row0 + rr < M && u.n0 + 64 * h < N) {
            const P2 v = *reinterpret_cast<const P2*>(
                st + (16 * warp + rr) * kStageLd + c);
            invoke(epi, row0 + rr, u.n0 + c + col_shift, v.x, v.y, in[rr][h],
                   col[h], row_in[rr]);
          }
        }
      }
    }
  }
}

// Sums the splits' partial sums in split order, then runs the epilogue:
// one thread per pair of columns, a warp on 64 columns of one row.
template <typename Epi>
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws, int M, int N, int splits,
                  Epi epi) {
  const int pairs = N / 2;
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i >= static_cast<long long>(M) * pairs) return;
  const int r = static_cast<int>(i / pairs);
  const int c = 2 * static_cast<int>(i - static_cast<long long>(r) * pairs);
  const float* p = ws + (size_t)r * splits * N + c;
  float2 s = *reinterpret_cast<const float2*>(p);
  for (int k = 1; k < splits; ++k) {
    const float2 q = *reinterpret_cast<const float2*>(p + (size_t)k * N);
    s.x += q.x;
    s.y += q.y;
  }
  if constexpr (Epi::kReads) {
    invoke(epi, r, c, s.x, s.y, epi.in(r, c), epi.col(c), epi.row(r));
  } else {
    epi(r, c, s.x, s.y);
  }
}

}  // namespace sm90

// ---- epilogues: columns c, c + 1 of row r from the sums (float for bf16,
// int for int8). One that reads memory (kReads) says what in In / Col / Row
// (sm90::Reads), which the kernel loads before the unit's slabs run; one
// that uses warp collectives (kWarpCollective) is called by all 32 lanes
// of a warp on conditions the compiler sees as warp-uniform.

using sm90::None;

// out = the f32 sums (bf16 products; also the split partial sums).
struct EpiStoreF32 {
  float* out;
  int ld;
  static constexpr bool kReads = false, kWarpCollective = false;
  __device__ __forceinline__ void operator()(int r, int c, float a0,
                                             float a1) const {
    *reinterpret_cast<float2*>(out + (size_t)r * ld + c) = float2{a0, a1};
  }
};

// out = the int32 sums (int8 products).
struct EpiStoreI32 {
  int* out;
  int ld;
  static constexpr bool kReads = false, kWarpCollective = false;
  __device__ __forceinline__ void operator()(int r, int c, int a0,
                                             int a1) const {
    *reinterpret_cast<int2*>(out + (size_t)r * ld + c) = int2{a0, a1};
  }
};

// out = bf16(acc): v3's packed conv-B product.
struct EpiStoreBf16 {
  bf16* out;
  int ld;
  static constexpr bool kReads = false, kWarpCollective = false;
  __device__ __forceinline__ void operator()(int r, int c, float a0,
                                             float a1) const {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ld + c) =
        __floats2bfloat162_rn(a0, a1);
  }
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// h = relu(acc + b1) -> bf16: the fc forward of v2, v3 and v4.
struct EpiBiasRelu {
  const float* b1;
  bf16* h;
  int ld;
  static constexpr bool kReads = true, kWarpCollective = false;
  using In = None;
  using Col = float2;      // b1[c], b1[c + 1]
  using Row = None;
  __device__ __forceinline__ In in(int, int) const { return {}; }
  __device__ __forceinline__ Col col(int c) const { return load2(b1 + c); }
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1,
                                             In, Col b, Row) const {
    *reinterpret_cast<__nv_bfloat162*>(h + (size_t)r * ld + c) =
        __floats2bfloat162_rn(fmaxf(a0 + b.x, 0.0f), fmaxf(a1 + b.y, 0.0f));
  }
};

// The largest |value| of a warp's 64 columns into amax[r], as the bits of
// a non-negative float (which order as unsigned ints): exact, and the same
// whatever the order of the atomics. All 32 lanes call it together; lane 0
// adds the warp's max by a predicated reduction inside the asm, so that
// ptxas sees no divergent branch before the next unit's wgmma.
__device__ __forceinline__ void row_amax(unsigned* amax, int r, float a0,
                                         float a1) {
  const unsigned m = __reduce_max_sync(
      0xffffffffu, __float_as_uint(fmaxf(fabsf(a0), fabsf(a1))));
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.u32 p, %2, 0;\n"
      "@p red.global.max.u32 [%0], %1;\n}\n" ::"l"(amax + r),
      "r"(m), "r"(threadIdx.x & 31)
      : "memory");
}

// h = relu(acc + b1) -> f32, and the row's amax of h: v2i's fc forward,
// whose h is quantized per row next.
struct EpiBiasReluAmax {
  const float* b1;
  float* h;
  unsigned* amax;
  int ld;
  static constexpr bool kReads = true, kWarpCollective = true;
  using In = None;
  using Col = float2;      // b1[c], b1[c + 1]
  using Row = None;
  __device__ __forceinline__ In in(int, int) const { return {}; }
  __device__ __forceinline__ Col col(int c) const { return load2(b1 + c); }
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1,
                                             In, Col b, Row) const {
    const float v0 = fmaxf(a0 + b.x, 0.0f), v1 = fmaxf(a1 + b.y, 0.0f);
    *reinterpret_cast<float2*>(h + (size_t)r * ld + c) = float2{v0, v1};
    row_amax(amax, r, v0, v1);
  }
};

__device__ __forceinline__ float tanh_grad(float o, float x, float scale) {
  const float t = tanhf(o);
  return (t - x) * (1.0f - t * t) * scale;
}

// o = acc + bd; do = (tanh(o) - x)(1 - tanh(o)^2) * scale -> bf16: v2's
// h @ D. Padded output columns have D = 0, bD = 0, x = 0, so do = 0 there.
struct EpiTanhGrad {
  const float* bd;
  const bf16* x;
  bf16* dout;
  int ld;
  float scale;
  static constexpr bool kReads = true, kWarpCollective = false;
  using In = __nv_bfloat162;   // x[r, c], x[r, c + 1]
  using Col = float2;          // bd[c], bd[c + 1]
  using Row = None;
  __device__ __forceinline__ In in(int r, int c) const {
    return *reinterpret_cast<const In*>(x + (size_t)r * ld + c);
  }
  __device__ __forceinline__ Col col(int c) const { return load2(bd + c); }
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1,
                                             In xv, Col b, Row) const {
    *reinterpret_cast<__nv_bfloat162*>(dout + (size_t)r * ld + c) =
        __floats2bfloat162_rn(tanh_grad(a0 + b.x, __low2float(xv), scale),
                              tanh_grad(a1 + b.y, __high2float(xv), scale));
  }
};

// dh = acc * [h > 0] -> bf16. The mask is taken from the bf16 h, which is
// positive exactly where the f32 h is (bf16 keeps f32's exponent range).
// h and dh may be the same buffer: each element is read, then written, by
// the one thread that owns it.
struct EpiReluMask {
  const bf16* h;
  bf16* dh;
  int ld;
  static constexpr bool kReads = true, kWarpCollective = false;
  using In = __nv_bfloat162;   // h[r, c], h[r, c + 1]
  using Col = None;
  using Row = None;
  __device__ __forceinline__ In in(int r, int c) const {
    return *reinterpret_cast<const In*>(h + (size_t)r * ld + c);
  }
  __device__ __forceinline__ Col col(int) const { return {}; }
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1,
                                             In hv, Col, Row) const {
    *reinterpret_cast<__nv_bfloat162*>(dh + (size_t)r * ld + c) =
        __floats2bfloat162_rn(__low2float(hv) > 0.0f ? a0 : 0.0f,
                              __high2float(hv) > 0.0f ? a1 : 0.0f);
  }
};

// Momentum update from dz = acc: v = m*v + dz; z = z - lr*v; zb = bf16(z).
// It runs after the split sums (or in the product's epilogue where K is
// not split) and reads z and v itself.
struct EpiMomentum {
  float* z;
  float* v;
  bf16* zb;
  int ld;
  float momentum;
  float lr;
  static constexpr bool kReads = false, kWarpCollective = false;
  __device__ __forceinline__ void operator()(int r, int c, float a0,
                                             float a1) const {
    const size_t i = (size_t)r * ld + c;
    const float2 vv = load2(v + i);
    const float2 zz = load2(z + i);
    const float v0 = momentum * vv.x + a0, v1 = momentum * vv.y + a1;
    const float z0 = zz.x - lr * v0, z1 = zz.y - lr * v1;
    *reinterpret_cast<float2*>(v + i) = float2{v0, v1};
    *reinterpret_cast<float2*>(z + i) = float2{z0, z1};
    *reinterpret_cast<__nv_bfloat162*>(zb + i) = __floats2bfloat162_rn(z0, z1);
  }
};

// v2i's hq @ Dq: o = f32(acc) * (sh[r] * sd[c]) + bd[c]; do = the tanh
// gradient against x, kept f32 for the row quantization, with its row amax.
struct EpiTanhGradI8 {
  const float* sh;
  const float* sd;
  const float* bd;
  const bf16* x;
  float* dout;
  unsigned* amax;
  int ld;
  float scale;
  static constexpr bool kReads = true, kWarpCollective = true;
  using In = __nv_bfloat162;   // x[r, c], x[r, c + 1]
  struct Col {
    float2 sd, bd;
  };
  using Row = float;           // sh[r]
  __device__ __forceinline__ In in(int r, int c) const {
    return *reinterpret_cast<const In*>(x + (size_t)r * ld + c);
  }
  __device__ __forceinline__ Col col(int c) const {
    return Col{load2(sd + c), load2(bd + c)};
  }
  __device__ __forceinline__ Row row(int r) const { return sh[r]; }
  __device__ __forceinline__ void operator()(int r, int c, int a0, int a1,
                                             In xv, Col k, Row s) const {
    const float d0 = tanh_grad(static_cast<float>(a0) * (s * k.sd.x) + k.bd.x,
                               __low2float(xv), scale);
    const float d1 = tanh_grad(static_cast<float>(a1) * (s * k.sd.y) + k.bd.y,
                               __high2float(xv), scale);
    *reinterpret_cast<float2*>(dout + (size_t)r * ld + c) = float2{d0, d1};
    row_amax(amax, r, d0, d1);
  }
};

// v2i's gq @ DTq: dh = f32(acc) * (sg[r] * sdt[c]), masked by the f32
// h > 0 -> bf16.
struct EpiReluMaskI8 {
  const float* sg;
  const float* sdt;
  const float* h;
  bf16* dh;
  int ld;
  static constexpr bool kReads = true, kWarpCollective = false;
  using In = float2;           // h[r, c], h[r, c + 1]
  using Col = float2;          // sdt[c], sdt[c + 1]
  using Row = float;           // sg[r]
  __device__ __forceinline__ In in(int r, int c) const {
    return load2(h + (size_t)r * ld + c);
  }
  __device__ __forceinline__ Col col(int c) const { return load2(sdt + c); }
  __device__ __forceinline__ Row row(int r) const { return sg[r]; }
  __device__ __forceinline__ void operator()(int r, int c, int a0, int a1,
                                             In hv, Col k, Row s) const {
    const float g0 = static_cast<float>(a0) * (s * k.x);
    const float g1 = static_cast<float>(a1) * (s * k.y);
    *reinterpret_cast<__nv_bfloat162*>(dh + (size_t)r * ld + c) =
        __floats2bfloat162_rn(hv.x > 0.0f ? g0 : 0.0f,
                              hv.y > 0.0f ? g1 : 0.0f);
  }
};

// ---- host side

// One product, its tensor maps encoded once (the loops encode theirs
// before the L loop: the operands stay where they are across steps).
struct Gemm {
  CUtensorMap a, b;
  int M, N, K, splits;
  bool int8;
};

// bf16: a [M, K], b [K, N]; int8: a [M, K], b = B^T [N, K]. Returns
// cudaErrorInvalidValue on shapes the kernel does not take or a map that
// cuTensorMapEncodeTiled refuses.
template <typename T>
inline cudaError_t make_gemm(Gemm* g, const T* a, const T* b, int M, int N,
                             int K, int splits = 1) {
  using Op = sm90::Operand<T>;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const int slabs = (K + Op::kPerSlab - 1) / Op::kPerSlab;
  const int per_split = splits > 0 ? (slabs + splits - 1) / splits : 0;
  if (M < 1 || N < 64 || N % 64 || K < 1 || (K * sizeof(T)) % 16 ||
      splits < 1 || splits > slabs || (splits - 1) * per_split >= slabs ||
      (kInt8 && splits != 1))
    return cudaErrorInvalidValue;
  *g = Gemm{};
  g->M = M;
  g->N = N;
  g->K = K;
  g->splits = splits;
  g->int8 = kInt8;
  cudaError_t e = encode_map(&g->a, a, sizeof(T), M, K, sm90::kBM);
  if (e != cudaSuccess) return e;
  return kInt8 ? encode_map(&g->b, b, 1, N, K, sm90::kGemmBN)
               : encode_map(&g->b, b, 2, K, N, sm90::kBK);
}

template <typename T, typename Epi, bool kSlabList = false>
inline cudaError_t launch_gemm_units(const Gemm& g, Epi epi, int split_stride,
                                     cudaStream_t stream,
                                     sm90::SlabList list = {}) {
  // set on every launch: a function-static "done" flag would be one object
  // per process (a static local of an inline function), shared by the
  // libraries of all four loops
  cudaError_t e = cudaFuncSetAttribute(
      sm90::gemm_sm90<T, Epi, kSlabList>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, sm90::kGemmSmem);
  if (e != cudaSuccess) return e;
  const int units = ((g.M + sm90::kBM - 1) / sm90::kBM) * g.splits *
                    ((g.N + sm90::kGemmBN - 1) / sm90::kGemmBN);
  const int grid = units < sm_count() ? units : sm_count();
  sm90::gemm_sm90<T, Epi, kSlabList>
      <<<grid, sm90::kThreads, sm90::kGemmSmem, stream>>>(
          g.a, g.b, g.M, g.N, g.K, g.splits, split_stride, epi, list);
  return cudaGetLastError();
}

// C = A @ B, then epi on every pair of columns. With g.splits > 1 the
// splits' sums go through ws [M, splits * N] (f32) and one reduction runs
// epi on their sum.
template <typename T, typename Epi>
inline cudaError_t launch_gemm(const Gemm& g, Epi epi, float* ws,
                               cudaStream_t stream) {
  if (g.int8 != std::is_same<T, int8_t>::value) return cudaErrorInvalidValue;
  if (g.splits == 1) return launch_gemm_units<T>(g, epi, 0, stream);
  if constexpr (std::is_same<T, bf16>::value) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    cudaError_t e = launch_gemm_units<T>(
        g, EpiStoreF32{ws, g.splits * g.N}, g.N, stream);
    if (e != cudaSuccess) return e;
    const long long pairs = static_cast<long long>(g.M) * (g.N / 2);
    sm90::splitk_reduce<Epi><<<static_cast<unsigned>((pairs + 255) / 256),
                               256, 0, stream>>>(ws, g.M, g.N, g.splits, epi);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

// C = A @ B walking, for each n-tile, only the K slabs `list` names (see
// sm90::SlabList; K not split), then epi on every pair of columns: the
// dense product wherever the blocks the list leaves out are all zero.
template <typename T, typename Epi>
inline cudaError_t launch_gemm_listed(const Gemm& g, Epi epi,
                                      sm90::SlabList list,
                                      cudaStream_t stream) {
  if (g.int8 != std::is_same<T, int8_t>::value || g.splits != 1 ||
      list.off == nullptr)
    return cudaErrorInvalidValue;
  return launch_gemm_units<T, Epi, true>(g, epi, 0, stream, list);
}

// z (f32) -> bf16 copy: the first step's A operand of z @ W1.
__global__ void cast_bf16(const float* __restrict__ z, bf16* __restrict__ zb,
                          int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) zb[i] = __float2bfloat16_rn(z[i]);
}

inline cudaError_t launch_cast_bf16(const float* z, bf16* zb, int n,
                                    cudaStream_t stream) {
  cast_bf16<<<(n + 255) / 256, 256, 0, stream>>>(z, zb, n);
  return cudaGetLastError();
}

}  // namespace fpk
