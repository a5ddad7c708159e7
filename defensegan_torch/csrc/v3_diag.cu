// The ten construct probes of the v3 kernel, at its shapes.
//
// Replaces the Pallas TPU kernels of
//   scripts/pallas_v3_diag.py::run_case (pallas_call), cases k1 .. k10
// of its main(): micro-kernels that each compile one construct of the JAX
// package's kernels/fused_projection_v3.py (ROWS = 49 * 128 rows, C0 128,
// CA 256, CB 16), run once, summed. With roll(v, s)[r] = v[(r - s) mod R]
// (pltpu.roll, np.roll) and shift(v, s)[r] = v[r + s] where r + s lies in
// [0, R), else 0 (the script's shift_rows):
//
//   k1  matmul                a[R, C0] @ b[C0, CA]                   -> f32
//   k2  concat-sublanes-49    out[p*T + t, c] = (z @ w[:, p*C0 ..])[t, c]
//   k3  roll-bf16             f32(roll(a, 5376))
//   k4  mask-lane-slice       a * m[:, 3]
//   k5  concat-lanes-9x16     lanes 16k .. 16k + 15 = roll(a, 128k)  bf16
//   k6  narrow-elementwise    (tanh a - b)(1 - tanh^2 a) * 2/784     f32
//   k7  fori-roll-matmul      4 x acc = bf16(roll(acc, 128)) @ b     f32
//   k8  shift-slice-concat    f32(shift(a, 1024)) + f32(shift(a, -768))
//   k9  concat-lanes-norolls  9 copies of a on lanes                 bf16
//   k10 fori-shift-matmul     4 x acc = bf16(shift(acc, 128)) @ b    f32
//
// What bounds them on an H100: bytes (3.35 TB/s) for the copies, the mask
// product and k6; the products of k1, k2, k7 and k10 are a few MFLOP to
// 0.8 GFLOP, under 1 us at 989 TFLOP/s bf16, so they too are bytes and
// launches. The design:
//   * every product runs on the port's wgmma GEMM (gemm_sm90.cuh, the one
//     under the fused loops) with an epilogue that puts each row where the
//     case wants it: k2's 49 column blocks of z @ w become row blocks in
//     the store (EpiBlocksToRows), and the row move of k7 / k10 is done by
//     the store of the product before it (EpiMoveRowsBf16: acc[r] rounded
//     to bf16 and written at the row that the next product reads it from,
//     ping-ponged between two buffers), so a chain of four products is one
//     cast-and-move pass and four GEMM launches;
//   * the copies, the mask product and the tanh chain are one elementwise
//     pass each, a thread per element (per pair of bf16 lanes where the
//     row width is even), the row moves as index arithmetic on the read.

#include "gemm_sm90.cuh"

using fpk::bf16;

namespace fpk {
namespace diag {

constexpr int kThreads = 256;

// source row of roll(v, s) and of shift(v, s) at row r of R; -1: zero
__device__ __forceinline__ int roll_src(int r, int s, int rows) {
  int q = (r - s) % rows;
  return q < 0 ? q + rows : q;
}
__device__ __forceinline__ int shift_src(int r, int s, int rows) {
  const int q = r + s;
  return q >= 0 && q < rows ? q : -1;
}
__device__ __forceinline__ int move_src(int r, int s, int rows, bool wrap) {
  return wrap ? roll_src(r, s, rows) : shift_src(r, s, rows);
}

// k2: column c of row r of z @ w [m, blocks*blk] goes to row (c / blk) * m
// + r, column c % blk of out [blocks*m, blk] (blk even).
struct EpiBlocksToRows {
  float* out;
  int m, blk;
  static constexpr bool kReads = false, kWarpCollective = false;
  __device__ __forceinline__ void operator()(int r, int c, float a0,
                                             float a1) const {
    const int p = c / blk;
    *reinterpret_cast<float2*>(out + ((size_t)p * m + r) * blk + c - p * blk) =
        float2{a0, a1};
  }
};

// k7 / k10: acc[r] -> bf16 at the row of `out` that reads it when `out` is
// the move (by `shift`, wrapped or zero-filled) of acc: (r + shift) mod m
// for the roll, r - shift for the shift (rows whose source leaves [0, m)
// are not written: the caller keeps them zero).
struct EpiMoveRowsBf16 {
  bf16* out;
  int ld, m, shift;
  bool wrap;
  static constexpr bool kReads = false, kWarpCollective = false;
  __device__ __forceinline__ void operator()(int r, int c, float a0,
                                             float a1) const {
    int d = r - shift;
    if (wrap) {
      d = (r + shift) % m;
      if (d < 0) d += m;
    } else if (d < 0 || d >= m) {
      return;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)d * ld + c) =
        __floats2bfloat162_rn(a0, a1);
  }
};

// k3: out[r, c] = f32(a[roll_src(r)]).
__global__ void __launch_bounds__(kThreads)
    roll_to_f32(const bf16* __restrict__ a, float* __restrict__ out,
                int rows, int cols, int shift) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = static_cast<int>(i / cols), c = static_cast<int>(i % cols);
  out[i] = __bfloat162float(a[(size_t)roll_src(r, shift, rows) * cols + c]);
}

// k4: out[r, c] = a[r, c] * mask[r, col].
__global__ void __launch_bounds__(kThreads)
    mask_col(const float* __restrict__ a, const float* __restrict__ mask,
             float* __restrict__ out, int rows, int cols, int mask_cols,
             int col) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = static_cast<int>(i / cols);
  out[i] = a[i] * mask[(size_t)r * mask_cols + col];
}

// k5 / k9: out[r, j*cols + c] = a[roll_src(r, j*step), c], j < copies; a
// thread per pair of lanes (cols even).
__global__ void __launch_bounds__(kThreads)
    lane_concat(const bf16* __restrict__ a, bf16* __restrict__ out, int rows,
                int cols, int copies, int step) {
  const int pairs = cols / 2 * copies;
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)rows * pairs) return;
  const int r = static_cast<int>(i / pairs);
  const int q = static_cast<int>(i % pairs);
  const int j = q / (cols / 2), c = 2 * (q % (cols / 2));
  const int src = roll_src(r, (int)(((long long)j * step) % rows), rows);
  *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * cols * copies +
                                     j * cols + c) =
      *reinterpret_cast<const __nv_bfloat162*>(a + (size_t)src * cols + c);
}

// k6: t = tanh(a); out = (t - b)(1 - t^2) * scale.
__global__ void __launch_bounds__(kThreads)
    tanh_grad_narrow(const float* __restrict__ a, const bf16* __restrict__ b,
                     float* __restrict__ out, long long n, float scale) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const float t = tanhf(a[i]);
  out[i] = (t - __bfloat162float(b[i])) * (1.0f - t * t) * scale;
}

// k8: out[r, c] = f32(shift(a, s1)[r, c]) + f32(shift(a, s2)[r, c]).
__global__ void __launch_bounds__(kThreads)
    shift_sum(const bf16* __restrict__ a, float* __restrict__ out, int rows,
              int cols, int s1, int s2) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = static_cast<int>(i / cols), c = static_cast<int>(i % cols);
  const int r1 = shift_src(r, s1, rows), r2 = shift_src(r, s2, rows);
  const float v1 = r1 < 0 ? 0.0f : __bfloat162float(a[(size_t)r1 * cols + c]);
  const float v2 = r2 < 0 ? 0.0f : __bfloat162float(a[(size_t)r2 * cols + c]);
  out[i] = v1 + v2;
}

// k7 / k10, before the first product: out0 = bf16(move(a)) whole, and the
// rows of out1 that no product's store reaches (a zero-filled move's) zero.
__global__ void __launch_bounds__(kThreads)
    move_cast(const float* __restrict__ a, bf16* __restrict__ out0,
              bf16* __restrict__ out1, int rows, int cols, int shift,
              bool wrap) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = static_cast<int>(i / cols), c = static_cast<int>(i % cols);
  const int src = move_src(r, shift, rows, wrap);
  const bf16 zero = __float2bfloat16_rn(0.0f);
  out0[i] = src < 0 ? zero : __float2bfloat16_rn(a[(size_t)src * cols + c]);
  if (src < 0) out1[i] = zero;
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace diag
}  // namespace fpk

using namespace fpk::diag;

// Every entry returns the first CUDA error, else 0, and launches on
// `stream`. Tensors row-major, contiguous.

// k1 (blk = 0): out [m, n] f32 = a [m, k] @ b [k, n], bf16. k2 (blk > 0,
// n a multiple of blk): out [(n / blk) * m, blk] holds the product's
// column blocks as row blocks. n a multiple of 64, k of 8.
extern "C" int fp_diag_matmul(const bf16* a, const bf16* b, float* out, int m,
                              int n, int k, int blk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fpk::Gemm g;
  cudaError_t e = fpk::make_gemm<bf16>(&g, a, b, m, n, k);
  if (e != cudaSuccess) return (int)e;
  if (blk > 0) {
    if (n % blk || blk % 2) return (int)cudaErrorInvalidValue;
    return (int)fpk::launch_gemm<bf16>(g, EpiBlocksToRows{out, m, blk},
                                       nullptr, st);
  }
  return (int)fpk::launch_gemm<bf16>(g, fpk::EpiStoreF32{out, n}, nullptr,
                                     st);
}

// k3: out [rows, cols] f32 = roll(a, shift), a bf16.
extern "C" int fp_diag_roll_f32(const bf16* a, float* out, int rows, int cols,
                                int shift, void* stream) {
  roll_to_f32<<<blocks_for((long long)rows * cols), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, out, rows, cols,
                                                     shift);
  return (int)cudaGetLastError();
}

// k4: out [rows, cols] = a * mask[:, col], mask [rows, mask_cols], f32.
extern "C" int fp_diag_mask_col(const float* a, const float* mask, float* out,
                                int rows, int cols, int mask_cols, int col,
                                void* stream) {
  mask_col<<<blocks_for((long long)rows * cols), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(a, mask, out, rows, cols,
                                                  mask_cols, col);
  return (int)cudaGetLastError();
}

// k5 (step 128) and k9 (step 0): out [rows, copies * cols] bf16, copy j
// = roll(a, j * step); cols even.
extern "C" int fp_diag_lane_concat(const bf16* a, bf16* out, int rows,
                                   int cols, int copies, int step,
                                   void* stream) {
  if (cols % 2) return (int)cudaErrorInvalidValue;
  lane_concat<<<blocks_for((long long)rows * (cols / 2) * copies), kThreads,
                0, static_cast<cudaStream_t>(stream)>>>(a, out, rows, cols,
                                                        copies, step);
  return (int)cudaGetLastError();
}

// k6: out [n] = (tanh a - b)(1 - tanh^2 a) * scale; a f32, b bf16.
extern "C" int fp_diag_tanh_grad(const float* a, const bf16* b, float* out,
                                 long long n, float scale, void* stream) {
  tanh_grad_narrow<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, b, out, n,
                                                          scale);
  return (int)cudaGetLastError();
}

// k8: out [rows, cols] f32 = shift(a, s1) + shift(a, s2), a bf16.
extern "C" int fp_diag_shift_sum(const bf16* a, float* out, int rows,
                                 int cols, int s1, int s2, void* stream) {
  shift_sum<<<blocks_for((long long)rows * cols), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(a, out, rows, cols, s1,
                                                   s2);
  return (int)cudaGetLastError();
}

// k7 (wrap = 1: roll) and k10 (wrap = 0: shift): acc = a [rows, cols] f32;
// `steps` times acc = bf16(move(acc, shift)) @ b [cols, cols] bf16; out =
// acc f32. Scratch s0, s1 [rows, cols] bf16. cols a multiple of 64.
extern "C" int fp_diag_chain(const float* a, const bf16* b, float* out,
                             bf16* s0, bf16* s1, int rows, int cols,
                             int steps, int shift, int wrap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps < 1) return (int)cudaErrorInvalidValue;
  bf16* buf[2] = {s0, s1};
  fpk::Gemm g[2];
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 2 && e == cudaSuccess; ++i)
    e = fpk::make_gemm<bf16>(&g[i], buf[i], b, rows, cols, cols);
  if (e != cudaSuccess) return (int)e;
  move_cast<<<blocks_for((long long)rows * cols), kThreads, 0, st>>>(
      a, s0, s1, rows, cols, shift, wrap != 0);
  e = cudaGetLastError();
  for (int i = 0; i < steps && e == cudaSuccess; ++i) {
    if (i + 1 < steps) {
      e = fpk::launch_gemm<bf16>(
          g[i % 2],
          EpiMoveRowsBf16{buf[(i + 1) % 2], cols, rows, shift, wrap != 0},
          nullptr, st);
    } else {
      e = fpk::launch_gemm<bf16>(g[i % 2], fpk::EpiStoreF32{out, cols},
                                 nullptr, st);
    }
  }
  return (int)e;
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
