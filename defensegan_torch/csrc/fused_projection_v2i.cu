// Fused projection loop v2i: the v2 loop with both D products in int8.
//
// Replaces the Pallas TPU kernel
//   kernels/fused_projection_v2i.py::_loop_kernel_int8 of the JAX package
// (pallas_call in fused_projection_dense_int8). Per row of z, for L steps:
//
//   h   = relu(bf16(z) @ W1 + b1)                      f32  [M, F]
//   hq  = rint(h / sh), sh = max(amax_row|h|, 1e-30) / 127   int8
//   o   = f32(hq @ Dq) * (sh * sD) + bD;  t = tanh(o)  int32 accumulation
//   do  = (t - x) * (1 - t^2) * (2 / out_dim)          f32  [M, P]
//   gq  = rint(do / sg), sg per row as above           int8
//   dh  = (f32(gq @ DTq) * (sg * sDT)) * [h > 0]       bf16 [M, F]
//   dz  = dh @ W1^T;  v = m*v + dz;  z -= lr*v         f32, in place
//
// Dq / DTq are D / D^T quantized once per column at pack time (scale
// colmax / 127, guarded 1.0 for zero columns). Row quantization rounds half
// to even (rintf) and clips to +-127, as jnp.rint + clip do. The z-side
// products stay bf16.
//
// What bounds it on an H100: at the flagship (784 outputs) 19.67 M int8
// operations (1,979 TOP/s) plus 3.21 MFLOP bf16 (989 TFLOP/s) per
// row-step -- compute. Its design: as v2 (see fused_projection_v2.cu),
// one launch of the Hopper GEMM (gemm_sm90.cuh) per product with the
// elementwise work in its epilogue. The D products run on s8 wgmma, whose
// B operand must be K-major: the pack carries Dq^T [P, F] and DTq^T
// [F, P] (the same codes, transposed). The epilogue that produces h, and
// the one that produces do, also takes each row's |max| (an atomic max on
// the bits of a non-negative float: exact, and the same in any order), so
// the quantize step reads each f32 row once.

#include "gemm_sm90.cuh"

namespace {

using fpk::bf16;

constexpr int kQuantThreads = 256;

// One block per row: s = max(amax, 1e-30) / 127; q = clip(rint(a / s)),
// four values a thread at a time (cols % 4 == 0). The row's amax is then
// set back to zero for the next step's epilogue.
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows(const float* __restrict__ a, int cols,
               unsigned* __restrict__ amax, int8_t* __restrict__ q,
               float* __restrict__ s) {
  const size_t r = blockIdx.x;
  const float sc = fmaxf(__uint_as_float(amax[r]), 1e-30f) / 127.0f;
  const float4* row = reinterpret_cast<const float4*>(a + r * cols);
  char4* qrow = reinterpret_cast<char4*>(q + r * cols);
  for (int c = threadIdx.x; c < cols / 4; c += kQuantThreads) {
    const float4 v = row[c];
    auto code = [sc](float x) {
      return static_cast<signed char>(
          fminf(fmaxf(rintf(x / sc), -127.0f), 127.0f));
    };
    qrow[c] = make_char4(code(v.x), code(v.y), code(v.z), code(v.w));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s[r] = sc;
    amax[r] = 0u;
  }
}

}  // namespace

// Runs `iters` int8 projection steps on M rows, updating z and v in place.
// Arguments as fp_v2_run's, with the K-major codes dqk = Dq^T [P, F] and
// dtqk = DTq^T [F, P] int8 and the column scales sd [P] / sdt [F] f32.
// Scratch: zb [M, K] bf16, h [M, F] f32, hq [M, F] int8, sh [M] f32,
// dout [M, P] f32, gq [M, P] int8, sg [M] f32, dh [M, F] bf16, amax_h and
// amax_g [M] u32, ws [M, splits * K] f32. Returns the first CUDA error,
// else 0.
extern "C" int fp_v2i_run(float* z, float* v, const bf16* x,
                          const bf16* w1, const bf16* w1t, const float* b1,
                          const int8_t* dqk, const float* sd,
                          const int8_t* dtqk, const float* sdt,
                          const float* bd, bf16* zb, float* h, int8_t* hq,
                          float* sh, float* dout, int8_t* gq, float* sg,
                          bf16* dh, unsigned* amax_h, unsigned* amax_g,
                          float* ws, int M, int K, int F, int P, int splits,
                          int iters, float lr, float momentum, float scale,
                          void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (F % 4 || P % 4) return (int)cudaErrorInvalidValue;
  fpk::Gemm g1, g2, g3, g4;
  cudaError_t e = fpk::make_gemm<bf16>(&g1, zb, w1, M, F, K);
  if (e == cudaSuccess) e = fpk::make_gemm<int8_t>(&g2, hq, dqk, M, P, F);
  if (e == cudaSuccess) e = fpk::make_gemm<int8_t>(&g3, gq, dtqk, M, F, P);
  if (e == cudaSuccess)
    e = fpk::make_gemm<bf16>(&g4, dh, w1t, M, K, F, splits);
  if (e == cudaSuccess) e = cudaMemsetAsync(amax_h, 0, M * 4, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(amax_g, 0, M * 4, st);
  if (e == cudaSuccess) e = fpk::launch_cast_bf16(z, zb, M * K, st);
  for (int it = 0; it < iters && e == cudaSuccess; ++it) {
    e = fpk::launch_gemm<bf16>(g1, fpk::EpiBiasReluAmax{b1, h, amax_h, F},
                               nullptr, st);
    if (e == cudaSuccess) {
      quant_rows<<<M, kQuantThreads, 0, st>>>(h, F, amax_h, hq, sh);
      e = cudaGetLastError();
    }
    if (e == cudaSuccess)
      e = fpk::launch_gemm<int8_t>(
          g2, fpk::EpiTanhGradI8{sh, sd, bd, x, dout, amax_g, P, scale},
          nullptr, st);
    if (e == cudaSuccess) {
      quant_rows<<<M, kQuantThreads, 0, st>>>(dout, P, amax_g, gq, sg);
      e = cudaGetLastError();
    }
    if (e == cudaSuccess)
      e = fpk::launch_gemm<int8_t>(g3, fpk::EpiReluMaskI8{sg, sdt, h, dh, F},
                                   nullptr, st);
    if (e == cudaSuccess)
      e = fpk::launch_gemm<bf16>(
          g4, fpk::EpiMomentum{z, v, zb, K, momentum, lr}, ws, st);
  }
  return (int)e;
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
