// The step of the deep loop v3 and its L loop, shared by
// fused_projection_v3.cu (v3's two entries), fused_projection_v3_variants.cu
// (the layout experiments v3p, packed and ilp, which change one switch
// each) and v3_diag2.cu (the step cut after one of its sections; see those
// files' headers for the function, the layouts and the design).
//
// A chain is one row range's step: seven launches (eight with the split-K
// sum; five and six with kFusedConvB) over its own buffers, its products'
// tensor maps encoded once per call. `run` builds the chain and issues the
// L steps. The switches:
//   kPadded         the v3p grid: g rows of g + 1 pixels, the last column a
//                   zero pad. Conv A walks the g*g real pixels and counts a
//                   tap only where its source is a real pixel (v3's taps,
//                   from the caller's masks and order); the fc's product is
//                   rounded to bf16 before the bias; do is multiplied by
//                   the pad mask; h1 is zeroed once per call (see `run`);
//   kChainBackward  conv A's backward sums its taps in one chain and rounds
//                   once (v3 rounds each tap);
//   kPingPong       conv A, both ways, on the ping-pong schedule of
//                   conv3x3_sm90.cuh (ilp): the same products, the two
//                   consumer warpgroups out of phase;
//   kFusedConvB     conv B forward, tanh_grad_pack and conv B backward as
//                   one kernel (convb::section below; v3's fp_v3_fused_run
//                   sets it alone, packed with kChainBackward): the same
//                   function, its obb and dop never in device memory.
// With all four off it is v3's fp_v3_run, launch for launch. `step` takes two
// more, for v3_diag2.cu alone: kF32ConvB (conv B's packed product stored
// in float32, tanh_grad_pack reading it so) and the cut (`upto`: the step
// ends after that section; the conv B and tanh-gradient cuts write o and
// do out of tanh_grad_pack's first phase).
#pragma once

#include <type_traits>

#include "conv3x3_sm90.cuh"
#include "gemm_sm90.cuh"

namespace fpk {
namespace v3 {

constexpr int kPackThreads = 256;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// One block per latent m, on a grid of gy rows of gx pixels (P = gy*gx).
// Phase 1: o[p, c] = bb[c] + sum over counted taps of obb[m, p+off_k,
// k*cb + c] (k ascending, f32); t = tanh(o); do[p, c] = bf16((t - x)(1 -
// t^2) * scale), kept in shared memory. Phase 2: dop[m, p, k*cb + c] =
// do[p-off_k, c] where that tap counts, else 0; columns 9*cb .. kpk are
// zero. kPadded = false: v3's tanh_grad_pack (a tap counts where masks
// says its source pixel is in the grid). kPadded = true: a tap counts where
// its source pixel index lies in [0, P), and do is zero on pad pixels
// (padm[p] == 0). Ob: obb's type (bf16; float under kF32ConvB). kExits:
// phase 1 also writes o and do to o_out and do_out [M, P*cb], and phase 2
// does not run (the step's conv B and tanh-gradient cuts).
template <bool kPadded, typename Ob = bf16, bool kExits = false>
__global__ void __launch_bounds__(kPackThreads)
    tanh_grad_pack(const Ob* __restrict__ obb, const bf16* __restrict__ x,
                   const float* __restrict__ bb,
                   const float* __restrict__ masks,
                   const float* __restrict__ padm, bf16* __restrict__ dop,
                   float* __restrict__ o_out, bf16* __restrict__ do_out,
                   int gy, int gx, int cb, int npk, int kpk, float scale) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  bf16* s_do = reinterpret_cast<bf16*>(s_raw);
  const int p2 = gy * gx;
  const size_t m = blockIdx.x;
  const Ob* ob = obb + m * p2 * npk;
  const bf16* xr = x + m * p2 * cb;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < p2 * cb; i += kPackThreads) {
    int p = i / cb, c = i - p * cb;
    float o = bb[c];
    for (int k = 0; k < 9; ++k) {
      int off = (k / 3 - 1) * gx + (k % 3 - 1);
      bool counts = kPadded ? (p + off >= 0 && p + off < p2)
                            : masks[p * 9 + k] != 0.0f;
      if (counts) o += to_f32(ob[(p + off) * npk + k * cb + c]);
    }
    float t = tanhf(o);
    float res = t - __bfloat162float(xr[i]);
    s_do[i] = __float2bfloat16_rn(res * (1.0f - t * t) * scale);
    if (kPadded && padm[p] == 0.0f) s_do[i] = zero;
    if constexpr (kExits) {
      o_out[m * p2 * cb + i] = o;
      do_out[m * p2 * cb + i] = s_do[i];
    }
  }
  if constexpr (kExits) return;
  __syncthreads();
  bf16* dp = dop + m * p2 * kpk;
  for (int i = threadIdx.x; i < p2 * kpk; i += kPackThreads) {
    int p = i / kpk, j = i - p * kpk;
    bf16 val = zero;
    if (j < 9 * cb) {
      int k = j / cb, c = j - k * cb;
      int off = (k / 3 - 1) * gx + (k % 3 - 1);
      bool counts = kPadded ? (p - off >= 0 && p - off < p2)
                            : masks[p * 9 + 8 - k] != 0.0f;
      if (counts) val = s_do[(p - off) * cb + c];
    }
    dp[i] = val;
  }
}

// ---- conv B's section as one kernel (kFusedConvB: v3's fp_v3_fused_run,
// the packed experiment)
//
// The function of conv B forward -> tanh_grad_pack -> conv B backward for
// whole latents, with their rounding points and summation orders: per
// latent m (P = g*g <= 64 pixels, cb = 16, so 9*cb = 144),
//   obb = bf16(h1[p] @ KBP)                     [P, 144]  (KBP = kbp's 144)
//   o   = bb + sum over counted taps k ascending of obb[p+off_k][16k + c]
//   do  = bf16((tanh(o) - x)(1 - tanh(o)^2) * scale)
//   dh1 = bf16(dop[p] @ KBT) * [h1 > 0]         over h1, dop[p][16k + c] =
//         do[p-off_k][c] where the tap counts, else 0
// A tile of the GEMM view [M*P, ca] cuts across latents, so there obb and
// dop went through device memory between three launches. Here a consumer
// warpgroup takes one latent whole: its P rows of h1 arrive by TMA in a
// 64-row wgmma tile (rows P..63 hold stale data and are never stored), the
// forward's products are rounded into shared memory, the tap sum and the
// tanh gradient read them there, and the backward takes its A operand,
// dop, straight from do in registers (the m64k16 fragment: a k16 step is
// one tap's 16 channels), so obb and dop never reach device memory. Both
// products read one copy of KBT resident in shared memory (kbpt's rows
// 0..143, the padding left out): forward as a K-major B (KBP = KBT's
// transpose, N = 144), backward as an MN-major B (K = 144). dh1 is written
// over h1's tile in shared memory (each element read, then written, by its
// owner) and leaves by TMA stores; the tile goes back to the producer
// once its store has read it, checked while the warpgroup's next forward
// runs. Persistent: one block an SM, two consumer warpgroups each on its
// own latent (one's epilogue and tap sum fall while the other's products
// run), a producer thread keeping a ring of h1 tiles full. The products
// are issued 64/49 wide in M (the tile's stale rows): 2 x 64 x 256 x 144
// x 2 FLOP a latent at ca 256.
// What bounds it on an H100: neither its bytes (h1 in, dh1 out: 50 KB a
// latent, 0.153 ms at 10240 latents) nor its issued products (0.098 ms at
// the bf16 peak): the threads' own work between the products -- the tap
// sum with its tanh, the epilogue -- on two warpgroups an SM sets its pace
// (PERF.md).
namespace convb {

constexpr int kTaps = 9;
constexpr int kCb = 16;                 // conv B's channels (one k16 step)
constexpr int kN = kTaps * kCb;         // 144
constexpr int kRows = 64;               // the wgmma tile of a latent
constexpr int kObbLd = kN + 8;          // bf16 a staged obb row
constexpr int kDoLd = kCb + 8;          // bf16 a do row
constexpr int kSlab = kRows * sm90::kSlabBytes;   // 8 KB: 64 rows x 64 bf16

template <int CA>
struct Smem {
  static constexpr int kChunk = kN * sm90::kSlabBytes;  // 144 rows of KBT
  static constexpr int kW = (CA / 64) * kChunk;
  static constexpr int kStage = (CA / 64) * kSlab;
  static constexpr int kObb = kRows * kObbLd * 2;
  static constexpr int kDo = kRows * kDoLd * 2;
  static constexpr int kFixed =
      1024 + kW + sm90::kConsumers * (kObb + kDo) + kRows * 2 + 128;
  static constexpr int kFit = (227 * 1024 - kFixed) / kStage;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr int kBytes = kFixed + kStages * kStage;
  static_assert(kStages >= 2, "two h1 tiles in flight");
  static_assert(kBytes <= 227 * 1024, "dynamic shared memory limit");
};

// The swizzled address of elements c, c + 1 of row r in a 128-byte-
// swizzled tile of 64-column slabs (TMA's SWIZZLE_128B layout).
__device__ __forceinline__ uint32_t swz(uint32_t tile, int r, int c) {
  const int b = (c & 63) * 2;
  return tile + (c >> 6) * kSlab + r * 128 +
         ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// map_h1: h1 as [M*P, CA], P-row boxes of 64 columns; map_w: kbpt as
// [kpk, CA], 144-row boxes. x [M, P*16] bf16, bb [16], masks [P, 9].
template <int CA>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    section(const __grid_constant__ CUtensorMap map_h1,
            const __grid_constant__ CUtensorMap map_w,
            const bf16* __restrict__ x, const float* __restrict__ bb,
            const float* __restrict__ masks, int M, int g, float scale) {
  using namespace sm90;
  using S = Smem<CA>;
  constexpr int kSlabs = CA / 64;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t wts = (base + 1023u) & ~1023u;
  const uint32_t ring = wts + S::kW;
  unsigned char* after_ring =
      smem_raw + (ring - base) + kStages * S::kStage;
  bf16* obb_all = reinterpret_cast<bf16*>(after_ring);
  bf16* do_all = obb_all + kConsumers * kRows * kObbLd;
  uint16_t* taps = reinterpret_cast<uint16_t*>(do_all + kConsumers * kRows *
                                               kDoLd);
  const uint32_t bars = smem_u32(taps + kRows);   // 8-byte aligned
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t wbar = bars + 8 * 2 * kStages;
  const int P = g * g;

  // the taps each pixel counts: bit k where masks[p, k] != 0
  for (int p = threadIdx.x; p < kRows; p += kThreads) {
    uint16_t bits = 0;
    for (int k = 0; k < kTaps && p < P; ++k)
      bits |= static_cast<uint16_t>(masks[p * kTaps + k] != 0.0f) << k;
    taps[p] = bits;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: KBT once, then one latent's h1 tile a stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(wbar, kSlabs * kN * kSlabBytes);
    for (int s = 0; s < kSlabs; ++s)
      tma_load(wts + s * S::kChunk, &map_w, wbar, 64 * s, 0);
    int i = 0;
    for (int m = blockIdx.x; m < M; m += gridDim.x, ++i) {
      const int st = i % kStages;
      mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(full(st), kSlabs * P * kSlabBytes);
      for (int s = 0; s < kSlabs; ++s)
        tma_load(ring + st * S::kStage + s * kSlab, &map_h1, full(st),
                 64 * s, m * P);
    }
    return;
  }
  // ---- consumers: warpgroup wg takes the block's latents i = wg, wg + 2..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const bool leader = tid == 0;
  const int r0 = 16 * warp + (lane >> 2);      // the thread's rows r0, r0 + 8
  const int c2 = 2 * (lane & 3);               // and columns c2, c2 + 1 (+ 8j)
  bf16* obb = obb_all + wg * kRows * kObbLd;
  bf16* dos = do_all + wg * kRows * kDoLd;
  constexpr int kPer = kRows * kCb / 128;   // tap-sum elements a thread
  const int cc = tid & (kCb - 1);       // the channel of all of them
  const float bbc = bb[cc];
  mbar_wait(wbar, 0);
  int held = -1;          // the stage whose dh1 the TMA store may still read
  int i = wg;
  for (int m = blockIdx.x + wg * gridDim.x; m < M;
       m += 2 * gridDim.x, i += 2) {
    const int st = i % kStages;
    const uint32_t tile = ring + st * S::kStage;
    // the targets of the tanh gradient, in flight while the products run
    bf16 xv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + 128 * j;
      xv[j] = e < P * kCb ? x[(size_t)m * P * kCb + e]
                          : __float2bfloat16_rn(0.0f);
    }
    mbar_wait(full(st), (i / kStages) & 1);

    // conv B forward: obb = bf16(h1 @ KBP), 64 x 144 a warpgroup
    {
      float acc[kN / 2];
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) acc[j] = 0.0f;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = sw128_desc(tile + s * kSlab + kk * 32, 16, 1024);
          const uint64_t db =
              sw128_desc(wts + s * S::kChunk + kk * 32, 16, 1024);
          WgmmaKB<kN>::mma(acc, da, db, (s | kk) != 0);
        }
      }
      wgmma_commit();
      // while the products run: the previous tile's store has read its
      // stage, which goes back to the producer
      if (leader && held >= 0) {
        bulk_wait_read();
        mbar_arrive(empty(held));
      }
      __syncwarp();
      held = st;
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = 8 * j + c2;
        if (r0 < P)
          *reinterpret_cast<__nv_bfloat162*>(obb + r0 * kObbLd + c) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < P)
          *reinterpret_cast<__nv_bfloat162*>(obb + (r0 + 8) * kObbLd + c) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    named_barrier(1 + wg, 128);

    // the tap sum and the tanh gradient (tanh_grad_pack's phase 1): the
    // thread's elements are channel cc of pixels tid / 16 + 8j
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = (tid >> 4) + 8 * j;
      if (p < P) {
        const int bits = taps[p];
        // every tap's element loaded first (a tap that does not count reads
        // its own pixel's), then added in tap order where it counts
        float v[kTaps];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          const int off = (k / 3 - 1) * g + (k % 3 - 1);
          const int q = ((bits >> k) & 1) ? p + off : p;
          v[k] = __bfloat162float(obb[q * kObbLd + k * kCb + cc]);
        }
        float o = bbc;
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          if ((bits >> k) & 1) o += v[k];
        float t = tanhf(o);
        float res = t - __bfloat162float(xv[j]);
        dos[p * kDoLd + cc] = __float2bfloat16_rn(res * (1.0f - t * t) * scale);
      }
    }
    named_barrier(1 + wg, 128);

    // conv B backward: dop's fragments from do (tap k is k16 step k; a
    // tap that does not count, and the stale rows, are zeros), KBT as an
    // MN-major B
    float acc[CA / 2];
#pragma unroll
    for (int j = 0; j < CA / 2; ++j) acc[j] = 0.0f;
    {
      uint32_t a[kTaps][4];
      const bf16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int off = (k / 3 - 1) * g + (k % 3 - 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {            // rows r0, r0 + 8
          const int p = r0 + 8 * h;
          const bool counts = p < P && ((taps[p] >> (8 - k)) & 1);
          const bf16* src = dos + (p - off) * kDoLd + c2;
          a[k][h] = counts ? *reinterpret_cast<const uint32_t*>(src)
                           : pack_bf16x2(zero, zero);
          a[k][h + 2] = counts ? *reinterpret_cast<const uint32_t*>(src + 8)
                               : pack_bf16x2(zero, zero);
        }
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        WgmmaRA<CA>::mma(acc, a[k], sw128_desc(wts + k * 16 * 128,
                                               S::kChunk, 1024), k != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // dh1 = bf16(acc) * [h1 > 0], over h1's tile, then out by TMA
    unsigned char* sm = smem_raw + (tile - base);
#pragma unroll
    for (int j = 0; j < CA / 8; ++j) {
      const int c = 8 * j + c2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < P) {
          __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(
              sm + (swz(tile, r, c) - tile));
          const __nv_bfloat162 hv = *q;
          *q = __floats2bfloat162_rn(
              __low2float(hv) > 0.0f ? acc[4 * j + 2 * h] : 0.0f,
              __high2float(hv) > 0.0f ? acc[4 * j + 2 * h + 1] : 0.0f);
        }
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (leader) {
      for (int s = 0; s < kSlabs; ++s)
        tma_store(&map_h1, tile + s * kSlab, 64 * s, m * P);
      bulk_commit();
    }
    __syncwarp();
  }
  if (leader) bulk_wait();
}

}  // namespace convb

// The fused section's tensor maps, encoded once per call.
struct ConvB {
  CUtensorMap h1, w;
  int M, g, ca;
};

// h1 [M, P*ca], kbpt [kpk, ca] (rows 0..143 read) bf16; cb must be 16,
// g*g <= 64, ca one of 64, 128, 192, 256.
inline cudaError_t make_conv_b(ConvB* c, const bf16* h1, const bf16* kbpt,
                               int M, int g, int ca, int cb, int kpk) {
  if (M < 1 || cb != convb::kCb || g < 1 || g * g > convb::kRows ||
      ca < 64 || ca > 256 || ca % 64 || kpk < convb::kN)
    return cudaErrorInvalidValue;
  *c = ConvB{};
  c->M = M;
  c->g = g;
  c->ca = ca;
  cudaError_t e = encode_map(&c->h1, h1, 2, M * g * g, ca, g * g);
  if (e != cudaSuccess) return e;
  return encode_map(&c->w, kbpt, 2, kpk, ca, convb::kN);
}

template <int CA>
inline cudaError_t launch_conv_b_ca(const ConvB& c, const bf16* x,
                                    const float* bb, const float* masks,
                                    float scale, cudaStream_t st) {
  using S = convb::Smem<CA>;
  cudaError_t e = cudaFuncSetAttribute(
      convb::section<CA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kBytes);
  if (e != cudaSuccess) return e;
  const int grid = c.M < sm_count() ? c.M : sm_count();
  convb::section<CA><<<grid, sm90::kThreads, S::kBytes, st>>>(
      c.h1, c.w, x, bb, masks, c.M, c.g, scale);
  return cudaGetLastError();
}

inline cudaError_t launch_conv_b(const ConvB& c, const bf16* x,
                                 const float* bb, const float* masks,
                                 float scale, cudaStream_t st) {
  switch (c.ca) {
    case 64: return launch_conv_b_ca<64>(c, x, bb, masks, scale, st);
    case 128: return launch_conv_b_ca<128>(c, x, bb, masks, scale, st);
    case 192: return launch_conv_b_ca<192>(c, x, bb, masks, scale, st);
    case 256: return launch_conv_b_ca<256>(c, x, bb, masks, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// v3p's fc forward: h0 = relu(bf16(acc) + b1) -> bf16 (the TPU kernel's
// per-pixel blocks are rounded before the bias is added).
struct EpiRoundBiasRelu {
  const float* b1;
  bf16* h;
  int ld;
  static constexpr bool kReads = true, kWarpCollective = false;
  using In = fpk::None;
  using Col = float2;      // b1[c], b1[c + 1]
  using Row = fpk::None;
  __device__ __forceinline__ In in(int, int) const { return {}; }
  __device__ __forceinline__ Col col(int c) const {
    return fpk::load2(b1 + c);
  }
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void operator()(int r, int c, float a0, float a1,
                                             In, Col b, Row) const {
    const float r0 = __bfloat162float(__float2bfloat16_rn(a0));
    const float r1 = __bfloat162float(__float2bfloat16_rn(a1));
    *reinterpret_cast<__nv_bfloat162*>(h + (size_t)r * ld + c) =
        __floats2bfloat162_rn(fmaxf(r0 + b.x, 0.0f), fmaxf(r1 + b.y, 0.0f));
  }
};

// One step chain over rows [0, M) of its buffers: the products' tensor maps
// (encoded once) and the buffers they read and write.
// obf, osec, dosec: v3_diag2.cu's float32 conv B product and its o and do
// cut outputs (set by the caller; unused elsewhere).
struct Chain {
  fpk::Conv3x3 conv_a, conv_at;
  fpk::Gemm fc, fct, conv_b, conv_bt;
  ConvB conv_bf;           // the fused section (fused_conv_b only)
  float *z, *v, *ws, *obf, *osec;
  const bf16* x;
  bf16 *zb, *h0, *h1, *obb, *dop, *dosec;
  const float *b1, *ba, *bb, *masks, *padm;
  int M, K, F, gy, gx, ca, cb, npk, kpk;
  float lr, momentum, scale;
};

// The chain on rows [0, M) of the call's buffers (row strides: K for z,
// v and zb; P*cb for x; P*c0 for h0; P*ca for h1; P*npk, P*kpk for obb and
// dop; splits*K for ws). n_walk: the pixels of `order` conv A writes (0:
// all P). fused_conv_b: conv B's section is the fused kernel (obb, dop
// unused: may be null; cb 16, g*g <= 64, square grid).
inline cudaError_t make_chain(
    Chain* ch, int M, float* z, float* v, const bf16* x, const bf16* w1,
    const bf16* w1t, const float* b1, const bf16* ka, const bf16* kat,
    const float* ba, const bf16* kbp, const bf16* kbpt, const float* bb,
    const float* masks, const int* order, const float* padm, bf16* zb,
    bf16* h0, bf16* h1, bf16* obb, bf16* dop, float* ws, int K, int c0,
    int ca, int cb, int gy, int gx, int npk, int kpk, int splits, float lr,
    float momentum, float scale, int n_walk = 0, bool fused_conv_b = false) {
  const int p2 = gy * gx;
  *ch = Chain{};
  ch->z = z;
  ch->v = v;
  ch->ws = ws;
  ch->x = x;
  ch->zb = zb;
  ch->h0 = h0;
  ch->h1 = h1;
  ch->obb = obb;
  ch->dop = dop;
  ch->b1 = b1;
  ch->ba = ba;
  ch->bb = bb;
  ch->masks = masks;
  ch->padm = padm;
  ch->M = M;
  ch->K = K;
  ch->F = p2 * c0;
  ch->gy = gy;
  ch->gx = gx;
  ch->ca = ca;
  ch->cb = cb;
  ch->npk = npk;
  ch->kpk = kpk;
  ch->lr = lr;
  ch->momentum = momentum;
  ch->scale = scale;
  cudaError_t e = fpk::make_conv3x3(&ch->conv_a, ch->h0, ka, masks, order, M,
                                    gx, c0, ca, 0, 0, gy, n_walk);
  if (e == cudaSuccess)
    e = fpk::make_conv3x3(&ch->conv_at, ch->h1, kat, masks, order, M, gx, ca,
                          c0, 0, 0, gy, n_walk);
  if (e == cudaSuccess)
    e = fpk::make_gemm<bf16>(&ch->fc, ch->zb, w1, M, ch->F, K);
  if (e == cudaSuccess)
    e = fpk::make_gemm<bf16>(&ch->fct, ch->h0, w1t, M, K, ch->F, splits);
  if (e != cudaSuccess) return e;
  if (fused_conv_b)
    return gy == gx ? make_conv_b(&ch->conv_bf, ch->h1, kbpt, M, gx, ca, cb,
                                  kpk)
                    : cudaErrorInvalidValue;
  e = fpk::make_gemm<bf16>(&ch->conv_b, ch->h1, kbp, M * p2, npk, ca);
  if (e == cudaSuccess)
    e = fpk::make_gemm<bf16>(&ch->conv_bt, ch->dop, kbpt, M * p2, ca, kpk);
  return e;
}

// Where `step` may end: after the fc (h0), conv A (h1), conv B (o), the
// tanh gradient (do), conv B's backward (dh1, over h1), conv A's backward
// (dh0, over h0), or the whole step.
enum Cut : int {
  kCutFc,
  kCutConvA,
  kCutConvB,
  kCutGrad,
  kCutConvBBwd,
  kCutConvABwd,
  kCutFull
};

// Conv B's section as three launches (conv B forward, tanh_grad_pack, conv
// B backward), or two for the conv B and tanh-gradient cuts.
template <bool kPadded, bool kF32ConvB>
inline cudaError_t conv_b_launches(const Chain& ch, cudaStream_t st,
                                   int upto) {
  using Ob = typename std::conditional<kF32ConvB, float, bf16>::type;
  const size_t smem = ch.gy * ch.gx * ch.cb * sizeof(bf16);
  cudaError_t e;
  // conv B forward, packed
  const Ob* ob;
  if constexpr (kF32ConvB) {
    ob = ch.obf;
    e = fpk::launch_gemm<bf16>(ch.conv_b, fpk::EpiStoreF32{ch.obf, ch.npk},
                               nullptr, st);
  } else {
    ob = ch.obb;
    e = fpk::launch_gemm<bf16>(ch.conv_b, fpk::EpiStoreBf16{ch.obb, ch.npk},
                               nullptr, st);
  }
  if (e != cudaSuccess) return e;
  // tap sum, tanh gradient: cut there (o and do out), or on to the
  // tap-major pack of do
  if (upto == kCutConvB || upto == kCutGrad) {
    tanh_grad_pack<kPadded, Ob, true><<<ch.M, kPackThreads, smem, st>>>(
        ob, ch.x, ch.bb, ch.masks, ch.padm, nullptr, ch.osec, ch.dosec, ch.gy,
        ch.gx, ch.cb, ch.npk, ch.kpk, ch.scale);
    return cudaGetLastError();
  }
  tanh_grad_pack<kPadded, Ob><<<ch.M, kPackThreads, smem, st>>>(
      ob, ch.x, ch.bb, ch.masks, ch.padm, ch.dop, nullptr, nullptr, ch.gy,
      ch.gx, ch.cb, ch.npk, ch.kpk, ch.scale);
  e = cudaGetLastError();
  // conv B backward, masked by h1, over h1
  if (e == cudaSuccess)
    e = fpk::launch_gemm<bf16>(ch.conv_bt,
                               fpk::EpiReluMask{ch.h1, ch.h1, ch.ca}, nullptr,
                               st);
  return e;
}

// One projection step of a chain: fp_v3_run's seven launches (eight with
// the split-K sum; five and six under kFusedConvB), with the variant's
// changes; cut after section `upto` (under kFusedConvB only after the fc,
// conv A, the fused section or later).
template <bool kPadded, bool kChainBackward, bool kF32ConvB = false,
          bool kPingPong = false, bool kFusedConvB = false>
inline cudaError_t step(const Chain& ch, cudaStream_t st,
                        int upto = kCutFull) {
  constexpr fpk::Sched kConvA = kPingPong ? fpk::kPingPong : fpk::kCoop;
  const int p2 = ch.gy * ch.gx;
  cudaError_t e;
  // fc forward
  if constexpr (kPadded) {
    e = fpk::launch_gemm<bf16>(ch.fc, EpiRoundBiasRelu{ch.b1, ch.h0, ch.F},
                               nullptr, st);
  } else {
    e = fpk::launch_gemm<bf16>(ch.fc, fpk::EpiBiasRelu{ch.b1, ch.h0, ch.F},
                               nullptr, st);
  }
  if (e != cudaSuccess || upto == kCutFc) return e;
  // conv A forward (v3p: the real pixels only)
  e = fpk::launch_conv3x3<fpk::kChain, false, kConvA>(
      ch.conv_a, fpk::EpiConvBiasRelu{ch.ba, ch.h1, p2 * ch.ca}, st);
  if (e != cudaSuccess || upto == kCutConvA) return e;
  if constexpr (kFusedConvB) {
    static_assert(!kPadded && !kF32ConvB, "the fused section is v3's grid");
    // conv B forward, tap sum, tanh gradient, conv B backward over h1
    e = launch_conv_b(ch.conv_bf, ch.x, ch.bb, ch.masks, ch.scale, st);
  } else {
    e = conv_b_launches<kPadded, kF32ConvB>(ch, st, upto);
  }
  if (e != cudaSuccess || upto <= kCutConvBBwd) return e;
  // conv A backward, masked by h0, over h0: each tap rounded, or (packed)
  // the taps in one chain, rounded once
  e = fpk::launch_conv3x3<kChainBackward ? fpk::kChain : fpk::kPerTapBf16,
                          true, kConvA>(ch.conv_at,
                                        fpk::EpiConvReluMask{ch.h0, ch.F}, st);
  if (e != cudaSuccess || upto == kCutConvABwd) return e;
  // fc backward + momentum update
  return fpk::launch_gemm<bf16>(
      ch.fct, fpk::EpiMomentum{ch.z, ch.v, ch.zb, ch.K, ch.momentum, ch.lr},
      ch.ws, st);
}

// The L loop over one chain of all M rows. kPadded: conv A writes only
// the real pixels, so nothing else writes h1's pad column; it is zeroed
// here once, and stays zero: conv B's backward writes dh1 = (dop KBT) *
// [h1 > 0] over h1, which is 0 where h1 is, and conv A's backward reads
// dh1 only at real pixels. h0's pad column is the fc's relu(bf16(0) + 0)
// = 0 every step (W1 and b1 hold zero blocks there), and conv A's backward
// leaves it so (its pad tiles are not issued).
template <bool kPadded, bool kChainBackward, bool kPingPong,
          bool kFusedConvB = false>
inline int run(float* z, float* v, const bf16* x, const bf16* w1,
               const bf16* w1t, const float* b1, const bf16* ka,
               const bf16* kat, const float* ba, const bf16* kbp,
               const bf16* kbpt, const float* bb, const float* masks,
               const int* order, const float* padm, bf16* zb, bf16* h0,
               bf16* h1, bf16* obb, bf16* dop, float* ws, int M, int K,
               int c0, int ca, int cb, int g, int npk, int kpk, int splits,
               int iters, float lr, float momentum, float scale,
               void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int gy = g, gx = kPadded ? g + 1 : g;
  Chain ch;
  cudaError_t e = make_chain(&ch, M, z, v, x, w1, w1t, b1, ka, kat, ba, kbp,
                             kbpt, bb, masks, order, padm, zb, h0, h1, obb,
                             dop, ws, K, c0, ca, cb, gy, gx, npk, kpk, splits,
                             lr, momentum, scale, g * g, kFusedConvB);
  if (e == cudaSuccess && kPadded)
    e = cudaMemsetAsync(h1, 0, sizeof(bf16) * M * gy * gx * ca, st);
  if (e == cudaSuccess) e = fpk::launch_cast_bf16(z, zb, M * K, st);
  for (int it = 0; it < iters && e == cudaSuccess; ++it)
    e = step<kPadded, kChainBackward, false, kPingPong, kFusedConvB>(ch, st);
  return (int)e;
}

}  // namespace v3
}  // namespace fpk
