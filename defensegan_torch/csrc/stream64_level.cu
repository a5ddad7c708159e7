// One deconv level of the 64x64 generator, forward and input gradient: the
// stream64 probe's fused block.
//
// Replaces the Pallas TPU kernel
//   scripts/stream64_probe.py::_probe_kernel
// (pallas_call in make_fused_level). A level is a 5x5 stride-2 SAME
// transpose conv with its BatchNorm folded, then relu; packed phase-major
// (experiments/stream64_probe.py::pack_level) it is a 3x3 SAME grid conv
// on the g x g input grid whose 4*co output lanes hold the four output
// phases. Per image, with taps k = (dy+1)*3 + (dx+1), off_k = dy*g + dx:
//
//   h  = sum_k x[p+off_k] @ W_k + b            [g*g, 4co] f32
//   dh = bf16(cot * [h > 0])                   [g*g, 4co] bf16
//   dx = sum_k bf16(dh[p-off_k] @ W_k^T)       [g*g, ci]  f32
//
// (a tap whose source pixel leaves the grid contributes nothing). These are
// the TPU kernel's rounding points: h stays f32 until the relu test, dh is
// bf16 (cot is bf16, so dh is exact), each tap's backward product is
// rounded to bf16 and the taps are summed in f32. The probe's levels are
// celeba.yml's v4 levels 0-2 ((g, ci, 4co) = (4, 512, 1024), (8, 256,
// 512), (16, 128, 256)), so both halves are the Hopper grid conv of the
// multi-level loop (conv3x3_sm90.cuh): the forward sums its taps in one
// chain and its epilogue takes the relu test against cot; the backward
// rounds each tap.
//
// What bounds it on an H100: operations, at 989 TFLOP/s bf16. The level
// itself (a 5x5 stride-2 transpose conv and its input gradient) needs
// 2 x 37.9 / 44.9 / 48.6 M multiply-adds an image at levels 0 / 1 / 2
// (those that land inside the output; 52.4 M each with the window's taps
// past the border); the phase-major form issues 36/25 of the latter, less
// the border taps the conv skips.
// Bytes: x and cot in, dx out (f32), 42 / 84 / 168 MB at batch 512 for
// levels 0 / 1 / 2: a tenth, a fifth and under half of the operations'
// time.
//
// Its design: two launches, the forward and the backward conv; dh goes
// through device memory between them (16.8 / 33.5 / 67 MB at batch 512:
// level 0's stays in the 50 MB L2, levels 1 and 2 round-trip HBM). The TPU
// kernel kept dh in VMEM; here a tile of the backward needs dh at nine
// neighbouring pixels of all its 4co lanes, which a block of the forward
// (one pixel, 128 lanes) never holds. Activations are latent-major and
// flat, [N, g*g*C] in (pixel, channel) order: the NHWC layout itself, so
// the function's interface needs no relayout.

#include "conv3x3_sm90.cuh"

namespace {

using fpk::bf16;

// dh = bf16(cot * [acc + bias[c] > 0]) at dh[r, pixel, c]; cot has dh's
// layout (channels c, c + 1).
struct EpiReluCot {
  const float* bias;
  const bf16* cot;
  bf16* dh;
  int ld;
  static constexpr bool kReads = true;
  __device__ __forceinline__ void prefetch(int r, int c, int pix_off) const {
    fpk::prefetch_l2(cot + (size_t)r * ld + pix_off + c);
  }
  __device__ __forceinline__ void operator()(int r, int c, int pix_off,
                                             float a0, float a1) const {
    const size_t i = (size_t)r * ld + pix_off + c;
    const __nv_bfloat162 cv =
        *reinterpret_cast<const __nv_bfloat162*>(cot + i);
    const bf16 zero = __float2bfloat16_rn(0.0f);
    __nv_bfloat162 out;
    out.x = a0 + bias[c] > 0.0f ? cv.x : zero;
    out.y = a1 + bias[c + 1] > 0.0f ? cv.y : zero;
    *reinterpret_cast<__nv_bfloat162*>(dh + i) = out;
  }
};

// dx = acc (f32) at dx[r, pixel, c].
struct EpiConvStoreF32 {
  float* out;
  int ld;
  static constexpr bool kReads = false;
  __device__ __forceinline__ void operator()(int r, int c, int pix_off,
                                             float a0, float a1) const {
    *reinterpret_cast<float2*>(out + (size_t)r * ld + pix_off + c) =
        float2{a0, a1};
  }
};

}  // namespace

// One level on M images. x: [M, g*g*ci] bf16; cot: [M, g*g*co4] bf16,
// phase-blocked; w: [9*ci, co4] and wt: [9*co4, ci] bf16 (the taps and their
// transposes, stacked on rows); bias: [co4] f32; masks: [g*g, 9] f32 0/1;
// order: [g*g] int32 (the pixels, 9 taps first). Scratch dh: [M, g*g*co4]
// bf16. Out dx: [M, g*g*ci] f32. ci, co4 multiples of 64. Returns the first
// CUDA error, else 0.
extern "C" int fp_stream64_level(const bf16* x, const bf16* cot,
                                 const bf16* w, const bf16* wt,
                                 const float* bias, const float* masks,
                                 const int* order, bf16* dh, float* dx,
                                 int M, int g, int ci, int co4,
                                 void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  fpk::Conv3x3 fwd, bwd;
  cudaError_t e =
      fpk::make_conv3x3(&fwd, x, w, masks, order, M, g, ci, co4);
  if (e == cudaSuccess)
    e = fpk::make_conv3x3(&bwd, dh, wt, masks, order, M, g, co4, ci);
  if (e == cudaSuccess)
    e = fpk::launch_conv3x3<fpk::kChain, false>(
        fwd, EpiReluCot{bias, cot, dh, g * g * co4}, st);
  if (e == cudaSuccess)
    e = fpk::launch_conv3x3<fpk::kPerTapBf16, true>(
        bwd, EpiConvStoreF32{dx, g * g * ci}, st);
  return (int)e;
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
