// The step of the deep loop v3 and its L loop, shared by
// fused_projection_v3.cu (v3) and fused_projection_v3_variants.cu (the
// layout experiments v3p, packed and ilp, which change one switch each;
// see those files' headers for the function, the layouts and the design).
//
// A chain is one row range's step: seven launches (eight with the split-K
// sum) over its own buffers, its products' tensor maps encoded once per
// call. `run` builds one chain (two with kTwoChains: the rows in two
// halves, the second on a stream of its own, forked from and joined to the
// caller's by events) and issues the L steps, the chains' launches in
// turns. The switches:
//   kPadded         the v3p grid: g rows of g + 1 pixels, the last column a
//                   zero pad; every tap issued (masks all 1), the fc's
//                   product rounded to bf16 before the bias, h1 and do
//                   multiplied by the pad mask;
//   kChainBackward  conv A's backward sums its taps in one chain and rounds
//                   once (v3 rounds each tap);
//   kTwoChains      two independent chains (ilp).
// With all three off it is v3's loop, launch for launch.
#pragma once

#include "conv3x3_sm90.cuh"
#include "gemm_sm90.cuh"

namespace fpk {
namespace v3 {

constexpr int kPackThreads = 256;

// One block per latent m, on a grid of gy rows of gx pixels (P = gy*gx).
// Phase 1: o[p, c] = bb[c] + sum over counted taps of obb[m, p+off_k,
// k*cb + c] (k ascending, f32); t = tanh(o); do[p, c] = bf16((t - x)(1 -
// t^2) * scale), kept in shared memory. Phase 2: dop[m, p, k*cb + c] =
// do[p-off_k, c] where that tap counts, else 0; columns 9*cb .. kpk are
// zero. kPadded = false: v3's tanh_grad_pack (a tap counts where masks
// says its source pixel is in the grid). kPadded = true: a tap counts where
// its source pixel index lies in [0, P), and do is zero on pad pixels
// (padm[p] == 0).
template <bool kPadded>
__global__ void __launch_bounds__(kPackThreads)
    tanh_grad_pack(const bf16* __restrict__ obb, const bf16* __restrict__ x,
                   const float* __restrict__ bb,
                   const float* __restrict__ masks,
                   const float* __restrict__ padm, bf16* __restrict__ dop,
                   int gy, int gx, int cb, int npk, int kpk, float scale) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  bf16* s_do = reinterpret_cast<bf16*>(s_raw);
  const int p2 = gy * gx;
  const size_t m = blockIdx.x;
  const bf16* ob = obb + m * p2 * npk;
  const bf16* xr = x + m * p2 * cb;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < p2 * cb; i += kPackThreads) {
    int p = i / cb, c = i - p * cb;
    float o = bb[c];
    for (int k = 0; k < 9; ++k) {
      int off = (k / 3 - 1) * gx + (k % 3 - 1);
      bool counts = kPadded ? (p + off >= 0 && p + off < p2)
                            : masks[p * 9 + k] != 0.0f;
      if (counts) o += __bfloat162float(ob[(p + off) * npk + k * cb + c]);
    }
    float t = tanhf(o);
    float res = t - __bfloat162float(xr[i]);
    s_do[i] = __float2bfloat16_rn(res * (1.0f - t * t) * scale);
    if (kPadded && padm[p] == 0.0f) s_do[i] = zero;
  }
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

// v3p's conv A forward: h1 = relu(acc + bias[c]) * padm[pixel] -> bf16 at
// out[r, pixel, c] (zero on the pad column).
struct EpiConvBiasReluPad {
  const float* bias;
  const float* padm;
  bf16* out;
  int ld, cout;
  static constexpr bool kReads = false;
  __device__ __forceinline__ void operator()(int r, int c, int pix_off,
                                             float a0, float a1) const {
    const float m = padm[pix_off / cout];
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * ld + pix_off + c) =
        __floats2bfloat162_rn(fmaxf(a0 + bias[c], 0.0f) * m,
                              fmaxf(a1 + bias[c + 1], 0.0f) * m);
  }
};

// One step chain over rows [0, M) of its buffers: the products' tensor maps
// (encoded once) and the buffers they read and write.
struct Chain {
  fpk::Conv3x3 conv_a, conv_at;
  fpk::Gemm fc, fct, conv_b, conv_bt;
  float *z, *v, *ws;
  const bf16* x;
  bf16 *zb, *h0, *h1, *obb, *dop;
  const float *b1, *ba, *bb, *masks, *padm;
  int M, K, F, gy, gx, ca, cb, npk, kpk;
  float lr, momentum, scale;
};

// The chain on rows [r0, r0 + M) of the call's buffers (row strides: K for
// z, v and zb; P*cb for x; P*c0 for h0; P*ca for h1; P*npk, P*kpk for obb
// and dop; splits*K for ws).
inline cudaError_t make_chain(
    Chain* ch, int r0, int M, float* z, float* v, const bf16* x,
    const bf16* w1, const bf16* w1t, const float* b1, const bf16* ka,
    const bf16* kat, const float* ba, const bf16* kbp, const bf16* kbpt,
    const float* bb, const float* masks, const int* order, const float* padm,
    bf16* zb, bf16* h0, bf16* h1, bf16* obb, bf16* dop, float* ws, int K,
    int c0, int ca, int cb, int gy, int gx, int npk, int kpk, int splits,
    float lr, float momentum, float scale) {
  const int p2 = gy * gx;
  const size_t r = static_cast<size_t>(r0);
  *ch = Chain{};
  ch->z = z + r * K;
  ch->v = v + r * K;
  ch->ws = ws + r * splits * K;
  ch->x = x + r * p2 * cb;
  ch->zb = zb + r * K;
  ch->h0 = h0 + r * p2 * c0;
  ch->h1 = h1 + r * p2 * ca;
  ch->obb = obb + r * p2 * npk;
  ch->dop = dop + r * p2 * kpk;
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
                                    gx, c0, ca, 0, 0, gy);
  if (e == cudaSuccess)
    e = fpk::make_conv3x3(&ch->conv_at, ch->h1, kat, masks, order, M, gx, ca,
                          c0, 0, 0, gy);
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

// One projection step of a chain: fused_projection_v3.cu's seven launches
// (eight with the split-K sum), with the variant's changes.
template <bool kPadded, bool kChainBackward>
inline cudaError_t step(const Chain& ch, cudaStream_t st) {
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
  // conv A forward
  if (e == cudaSuccess) {
    if constexpr (kPadded) {
      e = fpk::launch_conv3x3<fpk::kChain, false>(
          ch.conv_a,
          EpiConvBiasReluPad{ch.ba, ch.padm, ch.h1, p2 * ch.ca, ch.ca}, st);
    } else {
      e = fpk::launch_conv3x3<fpk::kChain, false>(
          ch.conv_a, fpk::EpiConvBiasRelu{ch.ba, ch.h1, p2 * ch.ca}, st);
    }
  }
  // conv B forward, packed
  if (e == cudaSuccess)
    e = fpk::launch_gemm<bf16>(ch.conv_b, fpk::EpiStoreBf16{ch.obb, ch.npk},
                               nullptr, st);
  // tap sum, tanh gradient, tap-major pack of do
  if (e == cudaSuccess) {
    tanh_grad_pack<kPadded><<<ch.M, kPackThreads, p2 * ch.cb * sizeof(bf16),
                              st>>>(ch.obb, ch.x, ch.bb, ch.masks, ch.padm,
                                    ch.dop, ch.gy, ch.gx, ch.cb, ch.npk,
                                    ch.kpk, ch.scale);
    e = cudaGetLastError();
  }
  // conv B backward, masked by h1, over h1
  if (e == cudaSuccess)
    e = fpk::launch_gemm<bf16>(ch.conv_bt,
                               fpk::EpiReluMask{ch.h1, ch.h1, ch.ca}, nullptr,
                               st);
  // conv A backward, masked by h0, over h0: each tap rounded, or (packed)
  // the taps in one chain, rounded once
  if (e == cudaSuccess)
    e = fpk::launch_conv3x3<kChainBackward ? fpk::kChain : fpk::kPerTapBf16,
                            true>(ch.conv_at,
                                  fpk::EpiConvReluMask{ch.h0, ch.F}, st);
  // fc backward + momentum update
  if (e == cudaSuccess)
    e = fpk::launch_gemm<bf16>(
        ch.fct, fpk::EpiMomentum{ch.z, ch.v, ch.zb, ch.K, ch.momentum, ch.lr},
        ch.ws, st);
  return e;
}

// The L loop. kTwoChains: the rows in two halves (the first a multiple of
// 64 rows), the second on a stream of its own.
template <bool kPadded, bool kChainBackward, bool kTwoChains>
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
  const int m0 = kTwoChains && M > 64 ? (M / 2 + 63) / 64 * 64 : M;
  Chain ch[2];
  const int n_chains = m0 < M ? 2 : 1;
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < n_chains && e == cudaSuccess; ++i)
    e = make_chain(&ch[i], i ? m0 : 0, i ? M - m0 : m0, z, v, x, w1, w1t, b1,
                   ka, kat, ba, kbp, kbpt, bb, masks, order, padm, zb, h0, h1,
                   obb, dop, ws, K, c0, ca, cb, gy, gx, npk, kpk, splits, lr,
                   momentum, scale);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t streams[2] = {st, nullptr};
  cudaEvent_t fork = nullptr, join = nullptr;
  if (n_chains == 2) {
    e = cudaStreamCreateWithFlags(&streams[1], cudaStreamNonBlocking);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&fork, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&join, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventRecord(fork, st);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(streams[1], fork, 0);
  }
  for (int i = 0; i < n_chains && e == cudaSuccess; ++i)
    e = fpk::launch_cast_bf16(ch[i].z, ch[i].zb, ch[i].M * K, streams[i]);
  for (int it = 0; it < iters && e == cudaSuccess; ++it)
    for (int i = 0; i < n_chains && e == cudaSuccess; ++i)
      e = step<kPadded, kChainBackward>(ch[i], streams[i]);
  if (n_chains == 2) {
    // the caller's stream waits for the second chain whatever happened
    cudaError_t j = join ? cudaEventRecord(join, streams[1])
                         : cudaErrorInvalidResourceHandle;
    if (j == cudaSuccess) j = cudaStreamWaitEvent(st, join, 0);
    if (e == cudaSuccess) e = j;
    if (fork) cudaEventDestroy(fork);
    if (join) cudaEventDestroy(join);
    if (streams[1]) cudaStreamDestroy(streams[1]);
  }
  return (int)e;
}

}  // namespace v3
}  // namespace fpk
