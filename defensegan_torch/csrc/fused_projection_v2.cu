// Fused projection loop v2 (bf16) for the wide single-deconv generator.
//
// Replaces the Pallas TPU kernel
//   kernels/fused_projection_v2.py::_loop_kernel of the JAX package
// (pallas_call in fused_projection_dense). Per row of z, for L steps:
//
//   h  = relu(bf16(z) @ W1 + b1)                [M, F]  bf16 out
//   o  = h @ D + bD;  t = tanh(o)               [M, P]
//   do = bf16((t - x)(1 - t^2) * (2 / out_dim))
//   dh = (do @ D^T) * [h > 0]                   [M, F]  bf16 out
//   dz = dh @ W1^T;  v = m*v + dz;  z -= lr*v   [M, k]  f32, in place
//
// bf16 operands, f32 accumulation, bf16 rounding of h / do / dh where the
// Pallas kernel rounds them. The mask is taken from the bf16 h, which is
// positive exactly where the f32 h is (bf16 keeps f32's exponent range).
//
// What bounds it on an H100: the dense products issue 22.88 MFLOP per
// row-step at the flagship (k 128, F 6272, 784 outputs), but D is the
// 5x5/2 deconv unrolled and 97% zeros. The two D products therefore walk
// only the K slabs whose block of D (D^T) holds a nonzero, from slab
// lists built once with the pack (kernels/gemm.py::slab_list; 182 of 686
// and 142 of 637 blocks on the flagship), which leaves 8.5 MFLOP issued
// a row-step. The loop's likely floor is then bytes: do @ D^T reads h and
// writes dh (about 256 MB a step at 10240 rows, ~77 us at 3.35 TB/s),
// h @ D and the fc backward read h and dh again, z @ W1 writes h.
// Its design: the TPU kernel keeps all weights (bf16) plus the [T, F]
// activations resident in VMEM for all L steps of a tile; an SM has
// 227 KB of shared memory, so that does not carry over. Instead each
// step is four launches of the Hopper GEMM (gemm_sm90.cuh: wgmma + TMA,
// persistent, warp-specialized) with the step's elementwise work fused
// into their epilogues; the weights (24.1 MB at P = 832) fit in the 50 MB
// L2, and h / do / dh go through device memory once each way per step
// (about 64 KB a row). The fc backward (N = k = 128) splits its K = F
// into fixed ranges and adds them in one reduction that runs the momentum
// update. The tensor maps are encoded once per call and the L loop runs
// here, so one call from Python runs all L steps of a row chunk.

#include "gemm_sm90.cuh"

using fpk::bf16;

// Runs `iters` projection steps on M rows, updating z and v in place.
// z, v: [M, K] f32 (v zeroed by the caller); x: [M, P] bf16 tanh-space
// targets, zero-padded past out_dim; w1 [K, F], w1t [F, K], d [F, P],
// dt [P, F] bf16; b1 [F], bd [P] f32; d_off / d_idx and dt_off / dt_idx
// int32, the slab lists of d and dt (fpk::sm90::SlabList: per 128-column
// tile, the 64-row slabs whose block holds a nonzero). Scratch: zb
// [M, K], h [M, F], dout [M, P], dh [M, F] bf16; ws [M, splits * K] f32,
// the fc backward's split sums (splits: kernels/gemm.py::split_k_for(F,
// K)). Returns the first CUDA error, else 0.
extern "C" int fp_v2_run(float* z, float* v, const bf16* x, const bf16* w1,
                         const bf16* w1t, const float* b1, const bf16* d,
                         const bf16* dt, const float* bd, const int* d_off,
                         const int* d_idx, const int* dt_off,
                         const int* dt_idx, bf16* zb, bf16* h, bf16* dout,
                         bf16* dh, float* ws, int M, int K, int F, int P,
                         int splits, int iters, float lr, float momentum,
                         float scale, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const fpk::sm90::SlabList d_list{d_off, d_idx}, dt_list{dt_off, dt_idx};
  fpk::Gemm g1, g2, g3, g4;
  cudaError_t e = fpk::make_gemm<bf16>(&g1, zb, w1, M, F, K);
  if (e == cudaSuccess) e = fpk::make_gemm<bf16>(&g2, h, d, M, P, F);
  if (e == cudaSuccess) e = fpk::make_gemm<bf16>(&g3, dout, dt, M, F, P);
  if (e == cudaSuccess)
    e = fpk::make_gemm<bf16>(&g4, dh, w1t, M, K, F, splits);
  if (e == cudaSuccess) e = fpk::launch_cast_bf16(z, zb, M * K, st);
  for (int it = 0; it < iters && e == cudaSuccess; ++it) {
    e = fpk::launch_gemm<bf16>(g1, fpk::EpiBiasRelu{b1, h, F}, nullptr, st);
    if (e == cudaSuccess)
      e = fpk::launch_gemm_listed<bf16>(
          g2, fpk::EpiTanhGrad{bd, x, dout, P, scale}, d_list, st);
    if (e == cudaSuccess)
      e = fpk::launch_gemm_listed<bf16>(g3, fpk::EpiReluMask{h, dh, F},
                                        dt_list, st);
    if (e == cudaSuccess)
      e = fpk::launch_gemm<bf16>(
          g4, fpk::EpiMomentum{z, v, zb, K, momentum, lr}, ws, st);
  }
  return (int)e;
}

// One product on its own, for checking the GEMM against a reference:
// C[M, N] = A[M, K] @ B, A and B bf16 (B [K, N]) or int8 (b = B^T [N, K]),
// then the epilogue `mode` writes `out` (ld N):
//   0 store            f32 sums (bf16) / int32 sums (int8)
//   1 bias_relu        bf16(relu(C + bias))                         bf16
//   2 bias_relu_amax   relu(C + bias) f32, row amax into amax       bf16
//   3 tanh_grad        bf16 tanh gradient of C + bias against x     bf16
//   4 relu_mask        bf16(C) where h (bf16) > 0, else 0           bf16
//   5 momentum         v = m*v + C; z -= lr*v; zb = bf16(z) in place bf16
//   6 tanh_grad_int8   f32 tanh gradient of C * (rs[r] cs[c]) + bias
//                      against x, row amax into amax                int8
//   7 relu_mask_int8   bf16(C * (rs[r] cs[c])) where h (f32) > 0    int8
// bf16 products split K into `splits` ranges through ws [M, splits * N];
// int8 takes splits = 1. amax [M] must hold zeros. A slab list (list_off,
// list_idx: fpk::sm90::SlabList of b) walks only its slabs, in bf16 with
// splits = 1 and modes 0, 3 and 4 (v2's D products); null walks every
// slab. Returns the CUDA error, else 0.
extern "C" int fp_gemm(const void* a, const void* b, void* out,
                       const float* bias, const bf16* x, const void* h,
                       const float* rs, const float* cs, unsigned* amax,
                       float* z, float* v, bf16* zb, float* ws,
                       const int* list_off, const int* list_idx, int M,
                       int N, int K, int int8, int splits, int mode,
                       float scale, float lr, float momentum,
                       void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  fpk::Gemm g;
  cudaError_t e;
  if (list_off != nullptr) {
    if (int8) return (int)cudaErrorInvalidValue;
    e = fpk::make_gemm<bf16>(&g, static_cast<const bf16*>(a),
                             static_cast<const bf16*>(b), M, N, K, splits);
    if (e != cudaSuccess) return (int)e;
    const fpk::sm90::SlabList list{list_off, list_idx};
    switch (mode) {
      case 0:
        return (int)fpk::launch_gemm_listed<bf16>(
            g, fpk::EpiStoreF32{static_cast<float*>(out), N}, list, st);
      case 3:
        return (int)fpk::launch_gemm_listed<bf16>(
            g, fpk::EpiTanhGrad{bias, x, static_cast<bf16*>(out), N, scale},
            list, st);
      case 4:
        return (int)fpk::launch_gemm_listed<bf16>(
            g,
            fpk::EpiReluMask{static_cast<const bf16*>(h),
                             static_cast<bf16*>(out), N},
            list, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (int8) {
    e = fpk::make_gemm<int8_t>(&g, static_cast<const int8_t*>(a),
                               static_cast<const int8_t*>(b), M, N, K,
                               splits);
    if (e != cudaSuccess) return (int)e;
    switch (mode) {
      case 0:
        return (int)fpk::launch_gemm<int8_t>(
            g, fpk::EpiStoreI32{static_cast<int*>(out), N}, ws, st);
      case 6:
        return (int)fpk::launch_gemm<int8_t>(
            g,
            fpk::EpiTanhGradI8{rs, cs, bias, x, static_cast<float*>(out),
                               amax, N, scale},
            ws, st);
      case 7:
        return (int)fpk::launch_gemm<int8_t>(
            g,
            fpk::EpiReluMaskI8{rs, cs, static_cast<const float*>(h),
                               static_cast<bf16*>(out), N},
            ws, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  e = fpk::make_gemm<bf16>(&g, static_cast<const bf16*>(a),
                           static_cast<const bf16*>(b), M, N, K, splits);
  if (e != cudaSuccess) return (int)e;
  switch (mode) {
    case 0:
      return (int)fpk::launch_gemm<bf16>(
          g, fpk::EpiStoreF32{static_cast<float*>(out), N}, ws, st);
    case 1:
      return (int)fpk::launch_gemm<bf16>(
          g, fpk::EpiBiasRelu{bias, static_cast<bf16*>(out), N}, ws, st);
    case 2:
      return (int)fpk::launch_gemm<bf16>(
          g, fpk::EpiBiasReluAmax{bias, static_cast<float*>(out), amax, N},
          ws, st);
    case 3:
      return (int)fpk::launch_gemm<bf16>(
          g, fpk::EpiTanhGrad{bias, x, static_cast<bf16*>(out), N, scale},
          ws, st);
    case 4:
      return (int)fpk::launch_gemm<bf16>(
          g,
          fpk::EpiReluMask{static_cast<const bf16*>(h),
                           static_cast<bf16*>(out), N},
          ws, st);
    case 5:
      return (int)fpk::launch_gemm<bf16>(
          g, fpk::EpiMomentum{z, v, zb, N, momentum, lr}, ws, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
