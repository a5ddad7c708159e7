// 3x3 SAME convolution on a small grid, for Hopper (sm_90a): wgmma + TMA.
// The grid convs of the deep projection loops run here: conv A of
// fused_projection_v3.cu and every level of fused_projection_v4.cu, both
// directions.
//
// An activation is [M, g*g*C] in (pixel, channel) order, latent-major and
// flat, so "pixel q of 128 latents" is a 128-row A operand at column q*C
// with row stride g*g*C. A tile is 128 latents x BN channels of ONE output
// pixel p: out[p] = sum over taps k of in[p +- off_k] @ W_k, off_k = dy*g +
// dx, k = (dy+1)*3 + (dx+1). A tap is a change of the A column and of the
// weights' row block, the same for the whole tile; a tap whose source pixel
// leaves the grid is skipped (masks[p*9 + k] == 0), not masked element by
// element. A grid may also have gy rows of g pixels (the padded 7 x 8 grid
// of the v3p experiment, fused_projection_v3_variants.cu): then every g*g
// here reads gy*g, and a tap whose source pixel index leaves [0, gy*g)
// reads the zeros of TMA's out-of-bounds fill, so such a grid may issue
// every tap (masks all 1).
//
// kBackward = false: out[p] = sum_k in[p + off_k] @ W_k, valid iff
// masks[p, k]. kBackward = true (the input gradient): out[p] = sum_k
// bf16(in[p - off_k] @ W_k), valid iff masks[p, 8 - k]; W_k are then the
// per-tap transposes (with kChain: the taps' sum in one chain, rounded
// once by the epilogue). Weights: [9*cin, cout], taps stacked on rows.
// epi(row, channel, pixel_offset, acc0, acc1) writes channels c and c + 1
// of pixel p at pixel_offset + c.
//
// Interleaved activations (the multi-level loop). A blocked activation
// [g*g, 4*f], lanes (py, px, channel), is the fine activation [(2g)*(2g),
// f] up to a permutation of f-wide runs within a row. A level that
// interleaves stores its output directly in fine order (out_fine = f) and
// its backward reads the gradient from there (in_fine = f), so the
// interleave is no pass of its own. f % 64 == 0: a K slab and each 64
// channels of a tile lie inside one run (a 128-wide tile may straddle two
// runs of 192: its offset is taken per 64 channels).
//
// What bounds it on an H100: operations, at 989 TFLOP/s bf16 (a tile's
// slabs come from L2: the weights and a 128-row slice of the activation
// stay there). The design:
//   * a block of three warpgroups: two consumers, each computing 64 x BN
//     of the 128 x BN tile with wgmma.mma_async (bf16 in, f32 sums in
//     registers), and a producer whose one thread issues the TMA copies;
//     setmaxnreg moves the producer's registers to the consumers;
//   * K slabs of 64 bf16 = one 128-byte swizzled row, so TMA writes them
//     in the layout wgmma reads (SWIZZLE_128B); a ring of 6 (BN 128) or 8
//     (BN 64) stages in 192 KB of dynamic shared memory, full/empty
//     mbarriers, no block-wide barrier in the main loop;
//   * the weights are read as they are stored, N-contiguous, through
//     wgmma's transpose flag for B: no transposed copy;
//   * persistent: gridDim.x blocks (one per SM) walk the tiles (m-tile,
//     pixel rank, n-tile) in that order, so the producer loads the next
//     tile while the consumers run the epilogue, a 128-row slice of the
//     activation stays in L2 across all pixels, and pixels with 9 taps
//     come first in each m-tile (`order`, from the wrapper);
//   * the epilogue runs straight from wgmma's register layout: each thread
//     owns two adjacent channels of a row, written as one bf16x2; what it
//     reads (the relu mask h, the targets x) is prefetched into L2 when
//     the tile starts.
// BN = 128 where cout % 128 == 0, else 64 (the out level's 64 lanes).
//
// How the taps are summed (TapSum):
//   kChain       one accumulation chain over all taps (v3's forward);
//   kPerTap      each tap's first wgmma starts a partial sum (scale-d 0),
//                which is added to the f32 accumulator at the tap's end.
//                The tensor cores do not round their running sum to
//                nearest, so a chain's error grows with its length; a grid
//                conv's 9*cin-long sum taken tap by tap stays about as
//                close to a float32 sum as two float32 orders are to each
//                other (v4's forward convs, whose rows pass four levels of
//                such sums);
//   kPerTapBf16  as kPerTap, each tap's partial rounded to bf16 before the
//                add: the backward convs' rounding, where the TPU kernels
//                round. (A backward conv takes kChain too: the tap-packed
//                conv A experiment sums its taps as one K = 9*cin product.)
// Folding a partial waits for its wgmma group; the other consumer
// warpgroup, on its own 64 rows of the same stages, keeps the tensor cores
// busy meanwhile. (Two partial sums taken in turns would fold one tap while
// the next runs, but at BN 128 they need 192 f32 registers a thread and
// spill: on an H100 that ran v4's convs 10% slower.)
//
// Requirements (checked by make_conv3x3 and the Python wrappers): M >= 1
// (rows past M read zeros and are not stored), cin, cout, in_fine and
// out_fine multiples of 64, every activation and weight base 16-byte
// aligned. The tensor maps are encoded on the host through the runtime's
// driver entry point (no -lcuda). Launches go on the caller's stream and
// allocate nothing. The barriers, TMA loads, wgmma and tensor-map encoding
// are shared with the GEMM (sm90_common.cuh).
#pragma once

#include "sm90_common.cuh"

namespace fpk {

enum TapSum { kChain, kPerTap, kPerTapBf16 };

// Offset of lane c of blocked pixel p in the fine layout.
__host__ __device__ __forceinline__ int interleaved_offset(int p, int c,
                                                           int g, int fine) {
  int run = c / fine;
  int y = p / g, x = p - y * g;
  int fp = (2 * y + (run >> 1)) * 2 * g + 2 * x + (run & 1);
  return fp * fine + (c - run * fine);
}

namespace sm90 {

constexpr int kRingBytes = 192 * 1024;

template <int BN>
struct Ring {
  static constexpr int kStage = kABytes + (BN / 64) * kBChunk;
  static constexpr int kStages = kRingBytes / kStage;        // 6 or 8
  // + barriers, + 1 KB to align the ring to the 128-byte swizzle's atom
  static constexpr int kSmem = kStages * kStage + 16 * kStages + 1024;
  static_assert(kSmem <= 227 * 1024, "dynamic shared memory limit");
};

// The tile at position t of the walk: (m-tile, pixel rank, n-tile), the
// n-tile fastest; order[rank] is the pixel.
struct TileAt {
  int p, m0, n0;
  __device__ __forceinline__ TileAt(int t, int n_n, int p2, int bn,
                                    const int* order) {
    const int nt = t % n_n;
    const int rest = t / n_n;
    p = order[rest % p2];
    m0 = (rest / p2) * kBM;
    n0 = nt * bn;
  }
};

template <int BN, TapSum kSum, bool kBackward, typename Epi>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_sm90(const __grid_constant__ CUtensorMap map_in,
                 const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ masks,
                 const int* __restrict__ order, int M, int g, int gy,
                 int cin, int cout, int in_fine, int out_fine, Epi epi) {
  using R = Ring<BN>;
  constexpr int kRegs = BN / 2;        // f32 sums per thread of 64 x BN
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + R::kStages * R::kStage;
  auto full = [&](uint32_t s) { return bars + 8 * s; };
  auto empty = [&](uint32_t s) { return bars + 8 * (R::kStages + s); };
  const int p2 = gy * g;
  const int n_n = cout / BN;
  const int n_tiles = ((M + kBM - 1) / kBM) * p2 * n_n;
  const int spt = cin / kBK;           // slabs per tap

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
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
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const TileAt tile(t, n_n, p2, BN, order);
      for (int k = 0; k < 9; ++k) {
        if (masks[tile.p * 9 + (kBackward ? 8 - k : k)] == 0.0f) continue;
        const int off = (k / 3 - 1) * g + (k % 3 - 1);
        const int src = kBackward ? tile.p - off : tile.p + off;
        for (int s = 0; s < spt; ++s) {
          const int k0 = s * kBK;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), R::kStage);
          const uint32_t sa = ring + stage * R::kStage;
          const int col = in_fine ? interleaved_offset(src, k0, g, in_fine)
                                  : src * cin + k0;
          tma_load(sa, &map_in, full(stage), col, tile.m0);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load(sa + kABytes + h * kBChunk, &map_w, full(stage),
                     tile.n0 + 64 * h, k * cin + k0);
          if (++stage == R::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: rows [64*wg, 64*wg + 64) of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x & 127) >> 5;
    const int lane = threadIdx.x & 31;
    const bool signals = (threadIdx.x & 127) == 0;
    float acc[kRegs];
    float part[kRegs];       // one tap's sum; unused with kChain
    uint32_t stage = 0, phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const TileAt tile(t, n_n, p2, BN, order);
      int n_taps = 0;
      for (int k = 0; k < 9; ++k) n_taps += masks[tile.p * 9 + k] != 0.0f;
      n_taps = __shfl_sync(0xffffffffu, n_taps, 0);
      // where channels c0 .. c0 + 63 of the tile sit in the output row, less
      // c0 (a 128-wide tile may straddle two runs of an interleave)
      auto offset_of = [&](int c0) {
        return out_fine ? interleaved_offset(tile.p, c0, g, out_fine) - c0
                        : tile.p * cout;
      };
      // thread (warp, lane) holds rows 16*warp + lane/4 (+ 8) and, per
      // 8-column block j, columns 8j + 2*(lane % 4) (+ 1)
      auto row_of = [&]() {
        return tile.m0 + 64 * wg + 16 * warp + (lane >> 2);
      };
      // bring the lines the epilogue reads (h, x) into L2 while the taps
      // run: one 128-byte line per 64 channels of a row
      if constexpr (Epi::kReads) {
        if ((lane & 3) < BN / 64) {
          const int row = row_of();
          const int c0 = tile.n0 + 64 * (lane & 3);
          if (row < M) epi.prefetch(row, c0, offset_of(c0));
          if (row + 8 < M) epi.prefetch(row + 8, c0, offset_of(c0));
        }
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < kRegs; ++i) acc[i] = 0.0f;
      int held = -1;         // a stage whose wgmma may still be reading it
      for (int tap = 0; tap < n_taps; ++tap) {
        for (int s = 0; s < spt; ++s) {
          mbar_wait(full(stage), phase);
          const uint32_t sa = ring + stage * R::kStage;
          if constexpr (kSum == kChain) fence_regs(acc);
          else fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            const uint64_t da = sw128_desc(sa + wg * (kABytes / 2) + kk * 32,
                                           16, 1024);
            const uint64_t db =
                sw128_desc(sa + kABytes + kk * 16 * 128, kBChunk, 1024);
            if constexpr (kSum == kChain) {
              Wgmma<BN>::mma(acc, da, db, (tap | s | kk) != 0);
            } else {
              Wgmma<BN>::mma(part, da, db, (s | kk) != 0);
            }
          }
          wgmma_commit();
          if (kSum != kChain && s == spt - 1) {
            // the tap is complete: fold its sum, release its stages
            wgmma_wait<0>();
            fence_regs(part);
#pragma unroll
            for (int i = 0; i < kRegs; ++i) {
              if constexpr (kSum == kPerTapBf16) {
                acc[i] += __bfloat162float(__float2bfloat16_rn(part[i]));
              } else {
                acc[i] += part[i];
              }
            }
            fence_regs(part);
            if (signals) {
              if (held >= 0) mbar_arrive(empty(held));
              mbar_arrive(empty(stage));
            }
            __syncwarp();
            held = -1;
          } else {
            // the previous slab's products are done: release its stage
            wgmma_wait<1>();
            if (signals && held >= 0) mbar_arrive(empty(held));
            __syncwarp();
            held = static_cast<int>(stage);
          }
          if (++stage == R::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if (held >= 0) {
        wgmma_wait<0>();
        if (signals) mbar_arrive(empty(held));
      }
      fence_regs(acc);
      int offset[BN / 64];
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) offset[h] = offset_of(tile.n0 + 64 * h);
      const int row = row_of();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = tile.n0 + 8 * j + 2 * (lane & 3);
        if (row < M) epi(row, c, offset[j / 8], acc[4 * j], acc[4 * j + 1]);
        if (row + 8 < M)
          epi(row + 8, c, offset[j / 8], acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

}  // namespace sm90

// ---- host side: tensor maps and launch

// One grid conv, its tensor maps encoded once: an A map over the input
// activation [M, g*g*cin] (128 x 64 boxes) and a B map over the weights
// [9*cin, cout] (64 x 64 boxes), both 128-byte swizzled.
struct Conv3x3 {
  CUtensorMap in, w;
  const float* masks;   // [g*g, 9] f32 0/1
  const int* order;     // [g*g] pixels, 9 taps first
  int M, g, gy, cin, cout, in_fine, out_fine;
};

// in: [M, g*g*cin] (fine order where in_fine); w: [9*cin, cout]. gy: the
// grid's rows where they are not g (0: a square grid; an interleave needs
// one). Returns cudaErrorInvalidValue on widths the kernel does not take
// or a map that cuTensorMapEncodeTiled refuses.
inline cudaError_t make_conv3x3(Conv3x3* c, const bf16* in, const bf16* w,
                                const float* masks, const int* order, int M,
                                int g, int cin, int cout, int in_fine = 0,
                                int out_fine = 0, int gy = 0) {
  if (gy == 0) gy = g;
  if (M < 1 || g < 1 || gy < 1 || cin % 64 || cout % 64 || in_fine % 64 ||
      out_fine % 64 || (in_fine && 4 * in_fine != cin) ||
      (out_fine && 4 * out_fine != cout) ||
      ((in_fine || out_fine) && gy != g))
    return cudaErrorInvalidValue;
  *c = Conv3x3{};
  c->masks = masks;
  c->order = order;
  c->M = M;
  c->g = g;
  c->gy = gy;
  c->cin = cin;
  c->cout = cout;
  c->in_fine = in_fine;
  c->out_fine = out_fine;
  cudaError_t e = encode_map(&c->in, in, 2, M, gy * g * cin, sm90::kBM);
  if (e != cudaSuccess) return e;
  return encode_map(&c->w, w, 2, 9 * cin, cout, sm90::kBK);
}

template <int BN, TapSum kSum, bool kBackward, typename Epi>
inline cudaError_t launch_conv3x3_bn(const Conv3x3& c, Epi epi,
                                     cudaStream_t stream) {
  using R = sm90::Ring<BN>;
  // set on every launch: a function-static "done" flag here would be one
  // object per process (a static local of an inline function), shared by
  // the v3 and v4 libraries, each of which registers its own kernel
  cudaError_t e = cudaFuncSetAttribute(
      sm90::conv3x3_sm90<BN, kSum, kBackward, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (e != cudaSuccess) return e;
  const int tiles =
      ((c.M + sm90::kBM - 1) / sm90::kBM) * c.gy * c.g * (c.cout / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  sm90::conv3x3_sm90<BN, kSum, kBackward, Epi>
      <<<grid, sm90::kThreads, R::kSmem, stream>>>(
          c.in, c.w, c.masks, c.order, c.M, c.g, c.gy, c.cin, c.cout,
          c.in_fine, c.out_fine, epi);
  return cudaGetLastError();
}

// kSum: how the taps are summed; a backward conv (kBackward) rounds each
// tap (kPerTapBf16) or sums them in one chain (kChain).
template <TapSum kSum, bool kBackward, typename Epi>
inline cudaError_t launch_conv3x3(const Conv3x3& c, Epi epi,
                                  cudaStream_t stream) {
  static_assert(!kBackward || kSum != kPerTap,
                "a backward conv rounds each tap or sums them in one chain");
  return c.cout % 128 == 0
             ? launch_conv3x3_bn<128, kSum, kBackward, Epi>(c, epi, stream)
             : launch_conv3x3_bn<64, kSum, kBackward, Epi>(c, epi, stream);
}

// ---- epilogues: channels c, c + 1 of a row, from the f32 sums. One that
// reads memory (kReads) names, in prefetch, the 128-byte line (64 channels
// from c) it will read

// h = relu(acc + bias[c]) -> bf16 at out[r, pixel, c].
struct EpiConvBiasRelu {
  const float* bias;
  bf16* out;
  int ld;
  static constexpr bool kReads = false;
  __device__ __forceinline__ void operator()(int r, int c, int pix_off,
                                             float a0, float a1) const {
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ld + pix_off + c) =
        __floats2bfloat162_rn(fmaxf(a0 + bias[c], 0.0f),
                              fmaxf(a1 + bias[c + 1], 0.0f));
  }
};

// dh = acc * [h > 0] -> bf16, written over h[r, pixel, c]. The mask is taken
// from the bf16 h, which is positive exactly where the f32 h is (bf16 keeps
// f32's exponent range); each element is read, then written, by the one
// thread that owns it.
struct EpiConvReluMask {
  bf16* h;
  int ld;
  static constexpr bool kReads = true;
  __device__ __forceinline__ void prefetch(int r, int c, int pix_off) const {
    prefetch_l2(h + (size_t)r * ld + pix_off + c);
  }
  __device__ __forceinline__ void operator()(int r, int c, int pix_off,
                                             float a0, float a1) const {
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(h + (size_t)r * ld + pix_off + c);
    const __nv_bfloat162 hv = *p;
    *p = __floats2bfloat162_rn(__low2float(hv) > 0.0f ? a0 : 0.0f,
                               __high2float(hv) > 0.0f ? a1 : 0.0f);
  }
};

}  // namespace fpk
