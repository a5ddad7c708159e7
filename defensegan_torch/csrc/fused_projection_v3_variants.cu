// The three layout experiments on the deep loop v3, each its own L loop:
// the padded grid (v3p), the tap-packed conv A backward (packed) and two
// independent chains (ilp).
//
// Replaces the Pallas TPU kernels
//   scripts/fused_projection_v3p_exp.py::_loop_kernel   (fp_v3p_run)
//   scripts/pallas_v3_packed_exp.py::_loop_kernel_packed (fp_v3_packed_run)
//   scripts/pallas_v3_ilp_exp.py::_ilp_loop_kernel       (fp_v3_ilp_run)
// each the TPU kernel of fused_projection_v3.cu (the JAX package's
// kernels/fused_projection_v3.py::_loop_kernel) with one lever changed. The
// step is v3's, launch for launch (fused_projection_v3_step.cuh, shared
// with fused_projection_v3.cu, whose header gives the function and the
// layouts), with one switch set; what each variant changes:
//
//  * v3p. The 7 x 7 grid gets a zero pad column: 7 rows of gx = 8 pixels,
//    P = 56. An x-edge tap then reads the pad column, a y-edge tap a pixel
//    index outside [0, 56) (TMA's zero fill in the conv, a range test in
//    tanh_grad_pack), so every tap is issued for every pixel and no tap
//    mask exists. The pad pixels are kept at zero as on the TPU: W1 and b1
//    hold zero blocks there (the fc writes h0 = 0), h1 and do are
//    multiplied by the pad mask once per step, and dh1 and dh0 are zero
//    there through the relu masks. The fc rounds its product to bf16
//    before the bias (h0 = relu(bf16(z @ W1) + b1)), as the TPU kernel's
//    per-pixel blocks do. Cost: 56 / 49 more rows in every product, and
//    all 9 x 56 taps of conv A where v3 issues 361.
//  * packed. Conv A's backward sums its nine taps in one chain (one
//    K = 9*ca product on the TPU) and rounds once, by the epilogue; v3
//    rounds each tap. The forward is v3's: already one chain.
//  * ilp. The chunk's rows in two halves, each a whole v3 step chain of
//    its own on its own CUDA stream (forked from and joined to the
//    caller's by events): the halves' launches are issued in turns, step
//    by step, so that one half's non-product launches (tanh_grad_pack,
//    the split-K sum, a conv's tail) overlap the other half's wgmma
//    products. Every row's arithmetic is v3's, so z_final equals v3's bit
//    for bit (a row's sums do not depend on the rows beside it).
//
// What bounds them on an H100: operations, as v3 (37.9 MFLOP per row-step
// of the function). The variants compute the same function, v3p and
// packed up to their rounding changes.

#include "fused_projection_v3_step.cuh"

using fpk::bf16;

// Each entry runs `iters` projection steps on M rows, updating z and v in
// place, with fp_v3_run's arguments (fused_projection_v3.cu): z, v [M, K]
// f32 (v zeroed by the caller); x [M, P*cb] bf16; w1 [K, P*c0], w1t
// [P*c0, K], ka [9*c0, ca], kat [9*ca, c0], kbp [ca, npk], kbpt [kpk, ca]
// bf16; b1 [P*c0], ba [ca], bb [cb], masks [P, 9] f32; order [P] int32;
// scratch zb [M, K], h0 [M, P*c0], h1 [M, P*ca], obb [M, P*npk], dop
// [M, P*kpk] bf16, ws [M, splits*K] f32. P = g*g, except in fp_v3p_run:
// P = g*(g+1), the padded grid (x, w1, w1t and b1 hold its zero pad
// pixels), masks all 1, and padm [P] f32 (0 on the pad column). Returns
// the first CUDA error, else 0.
extern "C" int fp_v3p_run(float* z, float* v, const bf16* x, const bf16* w1,
                          const bf16* w1t, const float* b1, const bf16* ka,
                          const bf16* kat, const float* ba, const bf16* kbp,
                          const bf16* kbpt, const float* bb,
                          const float* masks, const int* order,
                          const float* padm, bf16* zb, bf16* h0, bf16* h1,
                          bf16* obb, bf16* dop, float* ws, int M, int K,
                          int c0, int ca, int cb, int g, int npk, int kpk,
                          int splits, int iters, float lr, float momentum,
                          float scale, void* stream) {
  return fpk::v3::run<true, false, false>(
      z, v, x, w1, w1t, b1, ka, kat, ba, kbp, kbpt, bb, masks, order, padm,
      zb, h0, h1, obb, dop, ws, M, K, c0, ca, cb, g, npk, kpk, splits, iters,
      lr, momentum, scale, stream);
}

extern "C" int fp_v3_packed_run(float* z, float* v, const bf16* x,
                                const bf16* w1, const bf16* w1t,
                                const float* b1, const bf16* ka,
                                const bf16* kat, const float* ba,
                                const bf16* kbp, const bf16* kbpt,
                                const float* bb, const float* masks,
                                const int* order, bf16* zb, bf16* h0,
                                bf16* h1, bf16* obb, bf16* dop, float* ws,
                                int M, int K, int c0, int ca, int cb, int g,
                                int npk, int kpk, int splits, int iters,
                                float lr, float momentum, float scale,
                                void* stream) {
  return fpk::v3::run<false, true, false>(
      z, v, x, w1, w1t, b1, ka, kat, ba, kbp, kbpt, bb, masks, order, nullptr,
      zb, h0, h1, obb, dop, ws, M, K, c0, ca, cb, g, npk, kpk, splits, iters,
      lr, momentum, scale, stream);
}

extern "C" int fp_v3_ilp_run(float* z, float* v, const bf16* x,
                             const bf16* w1, const bf16* w1t, const float* b1,
                             const bf16* ka, const bf16* kat, const float* ba,
                             const bf16* kbp, const bf16* kbpt,
                             const float* bb, const float* masks,
                             const int* order, bf16* zb, bf16* h0, bf16* h1,
                             bf16* obb, bf16* dop, float* ws, int M, int K,
                             int c0, int ca, int cb, int g, int npk, int kpk,
                             int splits, int iters, float lr, float momentum,
                             float scale, void* stream) {
  return fpk::v3::run<false, false, true>(
      z, v, x, w1, w1t, b1, ka, kat, ba, kbp, kbpt, bb, masks, order, nullptr,
      zb, h0, h1, obb, dop, ws, M, K, c0, ca, cb, g, npk, kpk, splits, iters,
      lr, momentum, scale, stream);
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
