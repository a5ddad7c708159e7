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
// size a cut's ten launches (the inputs' load, the cast, up to seven of
// the step and the split-K sum, or the two of the cut's sum) and the host
// work around them take far longer, so the
// launch path is made once: a plan (fp_v3_diag2_plan) keeps the chain with
// its tensor maps encoded once, and the first run of each cut on a plan
// captures the cut's launches after the load into a CUDA graph (on a
// stream of the plan's own) that every later run of that cut replays: a
// run is the load kernel (z = z0, v = 0, x to bf16, on the caller's
// stream: the inputs' pointers change from run to run) and one graph
// launch, from one call. A failed capture, replay or launch returns its
// error; nothing falls back to the uncaptured launches, which only a plan
// made for a single run takes (graph = 0: nothing to replay later).

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

// A run's fresh state: z [M, K] = z0 [n, k] in its first n rows and k
// columns, else 0; v = 0; xb [M, xc] = bf16(x [n, xc]) in its first n
// rows, else 0.
__global__ void __launch_bounds__(kSumThreads)
    load_inputs(const float* __restrict__ z0, const float* __restrict__ x,
                float* __restrict__ z, float* __restrict__ v,
                bf16* __restrict__ xb, int n, int k, int M, int K, int xc) {
  const int nz = M * K, nx = M * xc;
  for (int i = blockIdx.x * kSumThreads + threadIdx.x; i < nz + nx;
       i += gridDim.x * kSumThreads) {
    if (i < nz) {
      const int r = i / K, c = i - r * K;
      z[i] = r < n && c < k ? z0[(size_t)r * k + c] : 0.0f;
      v[i] = 0.0f;
    } else {
      const int j = i - nz;
      xb[j] = __float2bfloat16_rn(j < n * xc ? x[j] : 0.0f);
    }
  }
}

// One cut on M rows of its buffers: the chain (tensor maps encoded once),
// the cut outputs and sums, and the graphs of its cuts, captured at first
// use on `capture`.
struct Plan {
  fpk::v3::Chain ch;
  float *z, *v, *part, *total;
  bf16* xb;
  int M, K, n, k, xc, c0, ca, cb;
  cudaStream_t capture = nullptr;
  cudaGraphExec_t graphs[fpk::v3::kCutFull + 1] = {};
};

// Everything a run launches after the load: z to bf16, the step up to the
// cut, the cut's sum into z (z + 0 * sum) before the whole step.
inline cudaError_t cut_launches(const Plan& p, int upto, cudaStream_t st) {
  namespace v3 = fpk::v3;
  const int p2 = p.ch.gy * p.ch.gx, M = p.M, K = p.K;
  cudaError_t e = fpk::launch_cast_bf16(p.z, p.ch.zb, M * K, st);
  if (e == cudaSuccess) e = v3::step<false, true, true>(p.ch, st, upto);
  if (e != cudaSuccess) return e;
  switch (upto) {
    case v3::kCutFc:
    case v3::kCutConvABwd:
      return cut_sum(p.ch.h0, p2 * p.c0, p.part, p.total, p.z, M, K, st);
    case v3::kCutConvA:
    case v3::kCutConvBBwd:
      return cut_sum(p.ch.h1, p2 * p.ca, p.part, p.total, p.z, M, K, st);
    case v3::kCutConvB:
      return cut_sum(p.ch.osec, p2 * p.cb, p.part, p.total, p.z, M, K, st);
    case v3::kCutGrad:
      return cut_sum(p.ch.dosec, p2 * p.cb, p.part, p.total, p.z, M, K, st);
    default:
      return cudaSuccess;
  }
}

// The cut's graph, captured on the plan's stream at its first use.
inline cudaError_t graph_of(Plan* p, int upto, cudaGraphExec_t* exec) {
  if (p->graphs[upto] == nullptr) {
    cudaError_t e = cudaSuccess;
    if (p->capture == nullptr)
      e = cudaStreamCreateWithFlags(&p->capture, cudaStreamNonBlocking);
    if (e == cudaSuccess)
      e = cudaStreamBeginCapture(p->capture, cudaStreamCaptureModeRelaxed);
    if (e != cudaSuccess) return e;
    const cudaError_t launched = cut_launches(*p, upto, p->capture);
    cudaGraph_t graph = nullptr;
    e = cudaStreamEndCapture(p->capture, &graph);
    if (launched != cudaSuccess) e = launched;
    if (e == cudaSuccess)
      e = cudaGraphInstantiate(&p->graphs[upto], graph, 0);
    if (graph != nullptr) cudaGraphDestroy(graph);
    if (e != cudaSuccess) return e;
  }
  *exec = p->graphs[upto];
  return cudaSuccess;
}

}  // namespace diag2
}  // namespace fpk

using fpk::diag2::Plan;

// A plan for the cut steps of n latents on M rows (n <= M, a multiple of
// 64), written to *out. Arguments as fp_v3_run's (fused_projection_v3.cu:
// z, v [M, K] f32; x [M, P*cb] bf16; the bf16 pack, b1, ba, bb, masks,
// order; scratch zb, h0, h1, dop, ws), except the packed conv B product
// obf [M, P*npk] in float32. Cut outputs: osec [M, P*cb] f32 (o, the conv B
// cut) and dosec [M, P*cb] bf16 (do, the tanh-gradient cut); part [M] and
// total [1] f32, the sum's row sums and the sum; k: z0's columns. The
// buffers stay the caller's and must outlive the plan. Returns the first
// CUDA error, else 0.
extern "C" int fp_v3_diag2_plan(
    void** out, float* z, float* v, bf16* x, const bf16* w1, const bf16* w1t,
    const float* b1, const bf16* ka, const bf16* kat, const float* ba,
    const bf16* kbp, const bf16* kbpt, const float* bb, const float* masks,
    const int* order, bf16* zb, bf16* h0, bf16* h1, float* obf, bf16* dop,
    float* ws, float* osec, bf16* dosec, float* part, float* total, int M,
    int K, int c0, int ca, int cb, int g, int npk, int kpk, int splits, int n,
    int k, float lr, float momentum, float scale) {
  *out = nullptr;
  if (n < 1 || n > M || k < 1 || k > K) return (int)cudaErrorInvalidValue;
  Plan* p = new Plan;
  cudaError_t e = fpk::v3::make_chain(
      &p->ch, M, z, v, x, w1, w1t, b1, ka, kat, ba, kbp, kbpt, bb, masks,
      order, nullptr, zb, h0, h1, nullptr, dop, ws, K, c0, ca, cb, g, g, npk,
      kpk, splits, lr, momentum, scale);
  if (e != cudaSuccess) {
    delete p;
    return (int)e;
  }
  p->ch.obf = obf;
  p->ch.osec = osec;
  p->ch.dosec = dosec;
  p->z = z;
  p->v = v;
  p->xb = x;
  p->part = part;
  p->total = total;
  p->M = M;
  p->K = K;
  p->n = n;
  p->k = k;
  p->xc = g * g * cb;
  p->c0 = c0;
  p->ca = ca;
  p->cb = cb;
  *out = p;
  return 0;
}

// One cut step of the plan's latents, z updated in place: z + 0 *
// sum(section) for upto < 6 (fpk::v3::Cut), the whole step (z -= lr * (m
// * v + dz), v = m * v + dz) for upto = 6, from z0 [n, k] f32 and x [n,
// P*cb] f32 (bf16 values). graph != 0: the cut's graph (captured at its
// first run on this plan); 0: the same launches issued one by one (a plan
// made for one run). The section stays where the step wrote it: h0 (fc),
// h1 (conv A), osec, dosec, h1 (dh1), h0 (dh0), z and v (the whole step).
// Returns the first CUDA error, else 0.
extern "C" int fp_v3_diag2_plan_run(void* plan, const float* z0,
                                    const float* x, int upto, int graph,
                                    void* stream_ptr) {
  namespace v3 = fpk::v3;
  Plan* p = static_cast<Plan*>(plan);
  if (p == nullptr || upto < v3::kCutFc || upto > v3::kCutFull)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int items = p->M * (p->K + p->xc);
  const int blocks = (items + fpk::diag2::kSumThreads - 1) /
                     fpk::diag2::kSumThreads;
  fpk::diag2::load_inputs<<<blocks < 1024 ? blocks : 1024,
                            fpk::diag2::kSumThreads, 0, st>>>(
      z0, x, p->z, p->v, p->xb, p->n, p->k, p->M, p->K, p->xc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!graph) return (int)fpk::diag2::cut_launches(*p, upto, st);
  cudaGraphExec_t exec;
  e = fpk::diag2::graph_of(p, upto, &exec);
  if (e == cudaSuccess) e = cudaGraphLaunch(exec, st);
  return (int)e;
}

// Frees a plan: its graphs and its capture stream (work in flight ends
// first).
extern "C" void fp_v3_diag2_plan_free(void* plan) {
  Plan* p = static_cast<Plan*>(plan);
  if (p == nullptr) return;
  for (cudaGraphExec_t g : p->graphs)
    if (g != nullptr) cudaGraphExecDestroy(g);
  if (p->capture != nullptr) cudaStreamDestroy(p->capture);
  delete p;
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
