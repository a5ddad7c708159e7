// The step of the deep loop v3 and its L loop, shared by
// fused_projection_v3.cu (v3), fused_projection_v3_variants.cu (the
// layout experiments v3p, packed and ilp, which change one switch each)
// and v3_diag2.cu (the step cut after one of its sections; see those
// files' headers for the function, the layouts and the design).
//
// A chain is one row range's step: seven launches (eight with the split-K
// sum) over its own buffers, its products' tensor maps encoded once per
// call. `run` builds the chain and issues the L steps. The switches:
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
//                   consumer warpgroups out of phase.
// With all three off it is v3's loop, launch for launch. `step` takes two
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
// all P).
inline cudaError_t make_chain(
    Chain* ch, int M, float* z, float* v, const bf16* x, const bf16* w1,
    const bf16* w1t, const float* b1, const bf16* ka, const bf16* kat,
    const float* ba, const bf16* kbp, const bf16* kbpt, const float* bb,
    const float* masks, const int* order, const float* padm, bf16* zb,
    bf16* h0, bf16* h1, bf16* obb, bf16* dop, float* ws, int K, int c0,
    int ca, int cb, int gy, int gx, int npk, int kpk, int splits, float lr,
    float momentum, float scale, int n_walk = 0) {
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
  if (e == cudaSuccess)
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

// One projection step of a chain: fused_projection_v3.cu's seven launches
// (eight with the split-K sum), with the variant's changes; cut after
// section `upto`.
template <bool kPadded, bool kChainBackward, bool kF32ConvB = false,
          bool kPingPong = false>
inline cudaError_t step(const Chain& ch, cudaStream_t st,
                        int upto = kCutFull) {
  constexpr fpk::Sched kConvA = kPingPong ? fpk::kPingPong : fpk::kCoop;
  using Ob = typename std::conditional<kF32ConvB, float, bf16>::type;
  const int p2 = ch.gy * ch.gx;
  const size_t smem = p2 * ch.cb * sizeof(bf16);
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
  if (e != cudaSuccess || upto == kCutConvBBwd) return e;
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
template <bool kPadded, bool kChainBackward, bool kPingPong>
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
                             lr, momentum, scale, g * g);
  if (e == cudaSuccess && kPadded)
    e = cudaMemsetAsync(h1, 0, sizeof(bf16) * M * gy * gx * ca, st);
  if (e == cudaSuccess) e = fpk::launch_cast_bf16(z, zb, M * K, st);
  for (int it = 0; it < iters && e == cudaSuccess; ++it)
    e = step<kPadded, kChainBackward, false, kPingPong>(ch, st);
  return (int)e;
}

}  // namespace v3
}  // namespace fpk
