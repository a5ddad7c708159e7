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
// row-step -- compute; the int8 products run over P = 832 columns. Its
// design: as v2 (see fused_projection_v2.cu), one tensor-core GEMM launch
// per product with the elementwise work in its epilogue, plus
// one row-quantization launch before each int8 product: a block per row
// takes the row's |max| from the f32 values (exact, deterministic: no
// atomics) and writes the int8 row and its scale. WMMA's int8 path is the
// pre-Hopper mma.sync rate; wgmma is the later PR's work.

#include "wmma_gemm.cuh"

namespace {

using fpk::bf16;

constexpr int kQuantThreads = 256;

// One block per row: s = max(amax, 1e-30) / 127; q = clip(rint(a / s)).
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows(const float* __restrict__ a, int cols,
               int8_t* __restrict__ q, float* __restrict__ s) {
  __shared__ float red[kQuantThreads / 32];
  const float* row = a + (size_t)blockIdx.x * cols;
  float m = 0.0f;
  for (int c = threadIdx.x; c < cols; c += kQuantThreads)
    m = fmaxf(m, fabsf(row[c]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, red[w]);
  const float sc = fmaxf(m, 1e-30f) / 127.0f;
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
  int8_t* qrow = q + (size_t)blockIdx.x * cols;
  for (int c = threadIdx.x; c < cols; c += kQuantThreads) {
    float r = fminf(fmaxf(rintf(row[c] / sc), -127.0f), 127.0f);
    qrow[c] = static_cast<int8_t>(r);
  }
}

// o = f32(acc) * (sh[r] * sd[c]) + bd[c]; t = tanh(o);
// do = (t - x)(1 - t^2) * scale, kept f32 for the row quantization.
struct EpiTanhGradI8 {
  const float* sh;
  const float* sd;
  const float* bd;
  const bf16* x;
  float* dout;
  int ld;
  float scale;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    size_t i = (size_t)r * ld + c;
    float t = tanhf(static_cast<float>(acc) * (sh[r] * sd[c]) + bd[c]);
    float res = t - __bfloat162float(x[i]);
    dout[i] = res * (1.0f - t * t) * scale;
  }
};

// dh = f32(acc) * (sg[r] * sdt[c]), masked by h > 0 (f32 h) -> bf16.
struct EpiReluMaskI8 {
  const float* sg;
  const float* sdt;
  const float* h;
  bf16* dh;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, int acc) const {
    size_t i = (size_t)r * ld + c;
    float g = static_cast<float>(acc) * (sg[r] * sdt[c]);
    dh[i] = __float2bfloat16_rn(h[i] > 0.0f ? g : 0.0f);
  }
};

}  // namespace

// Runs `iters` int8 projection steps on M rows, updating z and v in place.
// Arguments as fp_v2_run's, with dq [F, P] / dtq [P, F] int8 and their
// column scales sd [P] / sdt [F] f32. Scratch: zb [M, K] bf16, h [M, F]
// f32, hq [M, F] int8, sh [M] f32, dout [M, P] f32, gq [M, P] int8,
// sg [M] f32, dh [M, F] bf16. Returns the first CUDA error, else 0.
extern "C" int fp_v2i_run(float* z, float* v, const bf16* x,
                          const bf16* w1, const bf16* w1t, const float* b1,
                          const int8_t* dq, const float* sd,
                          const int8_t* dtq, const float* sdt,
                          const float* bd, bf16* zb, float* h, int8_t* hq,
                          float* sh, float* dout, int8_t* gq, float* sg,
                          bf16* dh, int M, int K, int F, int P, int iters,
                          float lr, float momentum, float scale,
                          void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = fpk::launch_cast_bf16(z, zb, M * K, st);
  if (e != cudaSuccess) return (int)e;
  for (int it = 0; it < iters; ++it) {
    e = fpk::launch_gemm<bf16>(zb, K, w1, F, M, F, K,
                               fpk::EpiBiasRelu<float>{b1, h, F}, st);
    if (e != cudaSuccess) return (int)e;
    quant_rows<<<M, kQuantThreads, 0, st>>>(h, F, hq, sh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = fpk::launch_gemm<int8_t>(hq, F, dq, P, M, P, F,
                                 EpiTanhGradI8{sh, sd, bd, x, dout, P, scale},
                                 st);
    if (e != cudaSuccess) return (int)e;
    quant_rows<<<M, kQuantThreads, 0, st>>>(dout, P, gq, sg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = fpk::launch_gemm<int8_t>(gq, P, dtq, F, M, F, P,
                                 EpiReluMaskI8{sg, sdt, h, dh, F}, st);
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
