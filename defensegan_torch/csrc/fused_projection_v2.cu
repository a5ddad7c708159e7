// Fused projection loop v2 (bf16) for the wide single-deconv generator.
//
// Replaces the Pallas TPU kernel
//   kernels/fused_projection_v2.py::_loop_kernel of the JAX package
// (pallas_call in fused_projection_dense). Per row of z, for L steps:
//
//   h  = relu(bf16(z) @ W1 + b1)                [M, F]  bf16 out
//   o  = h @ D + bD;  t = tanh(o)               [M, P]
//   do = (t - x) * (1 - t^2) * (2 / out_dim)    bf16 out
//   dh = (do @ D^T) * [h > 0]                   [M, F]  bf16 out
//   dz = dh @ W1^T;  v = m*v + dz;  z -= lr*v   [M, k]  f32, in place
//
// bf16 operands, f32 accumulation, bf16 rounding of h / do / dh where the
// Pallas kernel rounds them. The mask is taken from the bf16 h, which is
// positive exactly where the f32 h is (bf16 keeps f32's exponent range).
//
// What bounds it on an H100: the four products, 22.88 MFLOP per row-step
// at the flagship (k 128, F 6272, 784 outputs) -- compute, at 989 TFLOP/s
// bf16. The D products run over P = 832 columns (784 padded to the 64-wide
// tile), 6% more operations than the function needs.
// Its design: the TPU kernel keeps all weights (bf16) plus the
// [T, F] activations resident in VMEM for all L steps of a tile; an SM
// has 227 KB of shared memory, so that does not carry over. Instead each
// step is four tensor-core GEMM launches (wmma_gemm.cuh) with the step's
// elementwise work fused into their epilogues; the weights (24.1 MB at
// P = 832) fit in the 50 MB L2, and h / do / dh go through device memory
// once each way per step. The L loop runs here on the host side of the
// library, so one call from Python runs all L steps of a row chunk.
// Launch overhead (4 launches per step) and the h / dh round trips are
// what a persistent or graph-captured later version removes.

#include "wmma_gemm.cuh"

namespace {

using fpk::bf16;

// o = acc + bD; t = tanh(o); do = (t - x)(1 - t^2) * scale -> bf16.
// Padded output columns have D = 0, bD = 0, x = 0, so do = 0 there.
struct EpiTanhGrad {
  const float* bd;
  const bf16* x;
  bf16* dout;
  int ld;
  float scale;
  __device__ __forceinline__ void operator()(int r, int c, float acc) const {
    size_t i = (size_t)r * ld + c;
    float t = tanhf(acc + bd[c]);
    float res = t - __bfloat162float(x[i]);
    dout[i] = __float2bfloat16_rn(res * (1.0f - t * t) * scale);
  }
};

}  // namespace

// Runs `iters` projection steps on M rows, updating z and v in place.
// z, v: [M, K] f32 (v zeroed by the caller); x: [M, P] bf16 tanh-space
// targets, zero-padded past out_dim; w1 [K, F], w1t [F, K], d [F, P],
// dt [P, F] bf16; b1 [F], bd [P] f32. Scratch: zb [M, K], h [M, F],
// dout [M, P], dh [M, F] bf16. Returns the first CUDA error, else 0.
extern "C" int fp_v2_run(float* z, float* v, const bf16* x, const bf16* w1,
                         const bf16* w1t, const float* b1, const bf16* d,
                         const bf16* dt, const float* bd, bf16* zb, bf16* h,
                         bf16* dout, bf16* dh, int M, int K, int F, int P,
                         int iters, float lr, float momentum, float scale,
                         void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = fpk::launch_cast_bf16(z, zb, M * K, st);
  if (e != cudaSuccess) return (int)e;
  for (int it = 0; it < iters; ++it) {
    e = fpk::launch_gemm<bf16>(zb, K, w1, F, M, F, K,
                               fpk::EpiBiasRelu<bf16>{b1, h, F}, st);
    if (e != cudaSuccess) return (int)e;
    e = fpk::launch_gemm<bf16>(h, F, d, P, M, P, F,
                               EpiTanhGrad{bd, x, dout, P, scale}, st);
    if (e != cudaSuccess) return (int)e;
    e = fpk::launch_gemm<bf16>(dout, P, dt, F, M, F, P,
                               fpk::EpiReluMask{h, dh, F}, st);
    if (e != cudaSuccess) return (int)e;
    e = fpk::launch_gemm<bf16>(dh, F, w1t, K, M, K, F,
                               fpk::EpiMomentum{z, v, zb, K, momentum, lr},
                               st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
