// v3's step, cut after one of its seven sections.
//
// Replaces the Pallas TPU kernel
//   scripts/pallas_v3_diag2.py::build_kernel (its `kern`, pallas_call in
// main): the JAX package's v3 step (kernels/fused_projection_v3.py) at
// L = 1, lr 10, momentum 0.7 and v = 0, truncated after fc (h0), + conv A
// (h1), + conv B (o), + the tanh gradient (do), + conv B's backward (dh1),
// + conv A's backward (dh0), or whole. A cut kernel returns
// z_out = z + 0 * sum(section) -- z itself unless the section holds an inf
// or a NaN -- and the whole step z_out = z - 10 * dz. Two roundings differ
// from v3's (fused_projection_v3.cu): conv B's packed product stays
// float32 (v3 rounds it to bf16 before the tap sum), and conv A's backward
// sums its nine taps in float32 and rounds once (v3 rounds each tap).
//
// The design: the step is v3's own (fused_projection_v3_step.cuh), with
// kChainBackward (the packed experiment's chained conv A backward) and
// kF32ConvB (conv B stored by EpiStoreF32, tanh_grad_pack reading float32)
// set, ended after the section by the step's `upto`; the conv B and
// tanh-gradient cuts take o and do out of tanh_grad_pack's first phase.
// The sum is a two-pass reduction in float32 (one block a row of the
// section, then one block over the rows' sums in row order, which also
// writes z + 0 * sum): a fixed order, so the result does not depend on
// the run. Every section stays in device memory, where the caller reads
// it: a cut is a profile of v3's step as much as a compile probe.
//
// What bounds it on an H100: operations. The full cut is one step of v3's
// loop at 64 latents: 37.9 MFLOP a latent of the function, 2.5 us at 989
// TFLOP/s bf16, above its weights' 4.6 MB at 3.35 TB/s (1.4 us). At that
// size its nine launches and the wrapper's host work take far longer.

#include "fused_projection_v3_step.cuh"

using fpk::bf16;

namespace fpk {
namespace diag2 {

constexpr int kSumThreads = 256;

// Sum of kSumThreads values, one a thread, in a fixed tree order; every
// thread gets it.
__device__ __forceinline__ float block_sum(float s, float* red) {
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

__device__ __forceinline__ float as_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// part[r] = the float32 sum of row r of a [rows, cols]; a block a row.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    row_sums(const T* __restrict__ a, int cols, float* __restrict__ part) {
  __shared__ float red[kSumThreads];
  const T* row = a + (size_t)blockIdx.x * cols;
  float s = 0.0f;
  for (int c = threadIdx.x; c < cols; c += kSumThreads) s += as_f32(row[c]);
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// total = sum of part [rows]; z[i] = z[i] + 0 * total for i < n. One block.
__global__ void __launch_bounds__(kSumThreads)
    add_zero_sum(const float* __restrict__ part, int rows,
                 float* __restrict__ total, float* __restrict__ z, int n) {
  __shared__ float red[kSumThreads];
  float s = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kSumThreads) s += part[r];
  s = block_sum(s, red);
  if (threadIdx.x == 0) *total = s;
  const float zero = 0.0f * s;
  for (int i = threadIdx.x; i < n; i += kSumThreads) z[i] = z[i] + zero;
}

template <typename T>
cudaError_t cut_sum(const T* section, int cols, float* part, float* total,
                    float* z, int M, int K, cudaStream_t st) {
  row_sums<T><<<M, kSumThreads, 0, st>>>(section, cols, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  add_zero_sum<<<1, kSumThreads, 0, st>>>(part, M, total, z, M * K);
  return cudaGetLastError();
}

}  // namespace diag2
}  // namespace fpk

// One cut step on M rows, z updated in place: z + 0 * sum(section) for
// upto < 6 (fpk::v3::Cut), the whole step (z -= lr * (m * v + dz), v =
// m * v + dz) for upto = 6. Arguments as fp_v3_run's (fused_projection_v3
// .cu: z, v [M, K] f32 with v zeroed; x [M, P*cb] bf16; the bf16 pack, b1,
// ba, bb, masks, order; scratch zb, h0, h1, dop, ws), except the packed
// conv B product obf [M, P*npk] in float32. Cut outputs: osec [M, P*cb]
// f32 (o, the conv B cut) and dosec [M, P*cb] bf16 (do, the tanh-gradient
// cut); part [M] and total [1] f32, the sum's row sums and the sum. The
// section stays where the step wrote it: h0 (fc), h1 (conv A), osec,
// dosec, h1 (dh1), h0 (dh0), z and v (the whole step). Returns the first
// CUDA error, else 0.
extern "C" int fp_v3_diag2_run(
    float* z, float* v, const bf16* x, const bf16* w1, const bf16* w1t,
    const float* b1, const bf16* ka, const bf16* kat, const float* ba,
    const bf16* kbp, const bf16* kbpt, const float* bb, const float* masks,
    const int* order, bf16* zb, bf16* h0, bf16* h1, float* obf, bf16* dop,
    float* ws, float* osec, bf16* dosec, float* part, float* total, int M,
    int K, int c0, int ca, int cb, int g, int npk, int kpk, int splits,
    int upto, float lr, float momentum, float scale, void* stream_ptr) {
  namespace v3 = fpk::v3;
  using fpk::diag2::cut_sum;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (upto < v3::kCutFc || upto > v3::kCutFull)
    return (int)cudaErrorInvalidValue;
  const int p2 = g * g;
  v3::Chain ch;
  cudaError_t e = v3::make_chain(
      &ch, 0, M, z, v, x, w1, w1t, b1, ka, kat, ba, kbp, kbpt, bb, masks,
      order, nullptr, zb, h0, h1, nullptr, dop, ws, K, c0, ca, cb, g, g, npk,
      kpk, splits, lr, momentum, scale);
  if (e != cudaSuccess) return (int)e;
  ch.obf = obf;
  ch.osec = osec;
  ch.dosec = dosec;
  e = fpk::launch_cast_bf16(z, zb, M * K, st);
  if (e == cudaSuccess) e = v3::step<false, true, true>(ch, st, upto);
  if (e != cudaSuccess) return (int)e;
  switch (upto) {
    case v3::kCutFc:
    case v3::kCutConvABwd:
      return (int)cut_sum(h0, p2 * c0, part, total, z, M, K, st);
    case v3::kCutConvA:
    case v3::kCutConvBBwd:
      return (int)cut_sum(h1, p2 * ca, part, total, z, M, K, st);
    case v3::kCutConvB:
      return (int)cut_sum(osec, p2 * cb, part, total, z, M, K, st);
    case v3::kCutGrad:
      return (int)cut_sum(dosec, p2 * cb, part, total, z, M, K, st);
    default:
      return 0;
  }
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
