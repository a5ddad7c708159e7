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
// product and k6, 0.3 to 2 us each; the products of k1, k2, k7 and k10
// are a few MFLOP to 0.8 GFLOP, under 1 us at 989 TFLOP/s bf16, so they
// too are bytes. At these sizes a call's host work (the wrapper, ctypes,
// the launch) costs more than the card's work: the Python side binds every
// entry once and checks little (experiments/v3_diag.py). The design:
//   * every product runs on the port's wgmma GEMM (gemm_sm90.cuh, the one
//     under the fused loops) with an epilogue that puts each row where the
//     case wants it: k2's 49 column blocks of z @ w become row blocks in
//     the store (EpiBlocksToRows), and the row move of k7 / k10 is done by
//     the store of the product before it (EpiMoveRowsBf16: acc[r] rounded
//     to bf16 and written at the row that the next product reads it from,
//     ping-ponged between two buffers), so a chain of four products is one
//     cast-and-move pass and four GEMM launches;
//   * the copies, the mask product, the tanh chain and the chains' first
//     move are one pass each in which a thread writes 16 bytes of output
//     (4 float32 or 8 bf16 of one row) from the 8- or 16-byte pieces of
//     the source rows that land there: a roll or a shift of whole rows is a
//     change of source row, found once per vector with 32-bit arithmetic
//     and no modulo (the shift comes in normalised), and a warp's loads
//     and stores are contiguous runs of a row; the grid is at most eight
//     256-thread blocks an SM (132 SMs), walked grid-stride.

#include "gemm_sm90.cuh"

using fpk::bf16;

namespace fpk {
namespace diag {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2048 resident threads an SM

// blocks for n work items, one a thread, capped at kBlocksPerSm an SM of
// the current device (the kernels walk grid-stride)
inline unsigned grid_for(int n) {
  const int want = (n + kThreads - 1) / kThreads;
  const int cap = kBlocksPerSm * sm_count();
  return static_cast<unsigned>(want < cap ? want : cap);
}

// source row of roll(v, s) and of shift(v, s) at row r of R, s in [0, R)
// for the roll; -1: zero
__device__ __forceinline__ int roll_src(int r, int s, int rows) {
  const int q = r - s;
  return q < 0 ? q + rows : q;
}
__device__ __forceinline__ int shift_src(int r, int s, int rows) {
  const int q = r + s;
  return q >= 0 && q < rows ? q : -1;
}

__device__ __forceinline__ float4 bf16x4_to_f32(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint32_t f32x2_to_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
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
// for the roll (shift in [0, m)), r - shift for the shift (rows whose
// source leaves [0, m) are not written: the caller keeps them zero).
struct EpiMoveRowsBf16 {
  bf16* out;
  int ld, m, shift;
  bool wrap;
  static constexpr bool kReads = false, kWarpCollective = false;
  __device__ __forceinline__ void operator()(int r, int c, float a0,
                                             float a1) const {
    int d = r - shift;
    if (wrap) {
      d = r + shift;
      if (d >= m) d -= m;
    } else if (d < 0 || d >= m) {
      return;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)d * ld + c) =
        __floats2bfloat162_rn(a0, a1);
  }
};

// In every pass below, item i is 16 bytes of output: vector v = i % vecs
// of row r = i / vecs (vecs vectors a row).

// k3: out[r, c] = f32(a[roll_src(r)]); 4 columns an item.
__global__ void __launch_bounds__(kThreads)
    roll_to_f32(const bf16* __restrict__ a, float* __restrict__ out,
                int rows, int vecs, int shift) {
  const int n = rows * vecs;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int r = i / vecs, v = i - r * vecs;
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(a) +
                          (size_t)roll_src(r, shift, rows) * vecs + v);
    reinterpret_cast<float4*>(out)[i] = bf16x4_to_f32(x);
  }
}

// k4: out[r, c] = a[r, c] * mask[r, col]; 4 columns an item.
__global__ void __launch_bounds__(kThreads)
    mask_col(const float* __restrict__ a, const float* __restrict__ mask,
             float* __restrict__ out, int rows, int vecs, int mask_cols,
             int col) {
  const int n = rows * vecs;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int r = i / vecs;
    const float m = __ldg(mask + (size_t)r * mask_cols + col);
    float4 x = __ldg(reinterpret_cast<const float4*>(a) + i);
    x.x *= m;
    x.y *= m;
    x.z *= m;
    x.w *= m;
    reinterpret_cast<float4*>(out)[i] = x;
  }
}

// k5 / k9: out[r, j*cols + c] = a[roll_src(r, j*step), c], j < copies; 8
// lanes an item (cols a multiple of 8, cpv = cols / 8 items a copy).
__global__ void __launch_bounds__(kThreads)
    lane_concat(const bf16* __restrict__ a, bf16* __restrict__ out, int rows,
                int cpv, int copies, int step) {
  const int vecs = cpv * copies, n = rows * vecs;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int r = i / vecs, q = i - r * vecs;
    const int j = q / cpv, h = q - j * cpv;
    // j * step < copies * rows: reduce it into [0, rows) by subtraction
    int s = j * step;
    while (s >= rows) s -= rows;
    reinterpret_cast<uint4*>(out)[i] =
        __ldg(reinterpret_cast<const uint4*>(a) +
              (size_t)roll_src(r, s, rows) * cpv + h);
  }
}

// k6: t = tanh(a); out = (t - b)(1 - t^2) * scale; 4 elements an item.
__global__ void __launch_bounds__(kThreads)
    tanh_grad_narrow(const float* __restrict__ a, const bf16* __restrict__ b,
                     float* __restrict__ out, int n4, float scale) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += gridDim.x * kThreads) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(a) + i);
    const float4 y = bf16x4_to_f32(__ldg(reinterpret_cast<const uint2*>(b) + i));
    float4 o;
    float t = tanhf(x.x);
    o.x = (t - y.x) * (1.0f - t * t) * scale;
    t = tanhf(x.y);
    o.y = (t - y.y) * (1.0f - t * t) * scale;
    t = tanhf(x.z);
    o.z = (t - y.z) * (1.0f - t * t) * scale;
    t = tanhf(x.w);
    o.w = (t - y.w) * (1.0f - t * t) * scale;
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

// k8: out[r, c] = f32(shift(a, s1)[r, c]) + f32(shift(a, s2)[r, c]); 4
// columns an item.
__global__ void __launch_bounds__(kThreads)
    shift_sum(const bf16* __restrict__ a, float* __restrict__ out, int rows,
              int vecs, int s1, int s2) {
  const int n = rows * vecs;
  const uint2* src = reinterpret_cast<const uint2*>(a);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int r = i / vecs, v = i - r * vecs;
    const int r1 = shift_src(r, s1, rows), r2 = shift_src(r, s2, rows);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 x = r1 < 0 ? zero
                            : bf16x4_to_f32(__ldg(src + (size_t)r1 * vecs + v));
    const float4 y = r2 < 0 ? zero
                            : bf16x4_to_f32(__ldg(src + (size_t)r2 * vecs + v));
    reinterpret_cast<float4*>(out)[i] =
        make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
}

// k7 / k10, before the first product: out0 = bf16(move(a)) whole, and the
// rows of out1 that no product's store reaches (a zero-filled move's) zero;
// 8 columns an item (a: two float4 of the source row).
__global__ void __launch_bounds__(kThreads)
    move_cast(const float* __restrict__ a, bf16* __restrict__ out0,
              bf16* __restrict__ out1, int rows, int vecs, int shift,
              bool wrap) {
  const int n = rows * vecs;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int r = i / vecs, v = i - r * vecs;
    const int src = wrap ? roll_src(r, shift, rows) : shift_src(r, shift, rows);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);   // bf16 zeros
    if (src >= 0) {
      const float4* p = reinterpret_cast<const float4*>(a) +
                        2 * ((size_t)src * vecs + v);
      const float4 x = __ldg(p), y = __ldg(p + 1);
      o = make_uint4(f32x2_to_bf16x2(x.x, x.y), f32x2_to_bf16x2(x.z, x.w),
                     f32x2_to_bf16x2(y.x, y.y), f32x2_to_bf16x2(y.z, y.w));
    } else {
      reinterpret_cast<uint4*>(out1)[i] = o;
    }
    reinterpret_cast<uint4*>(out0)[i] = o;
  }
}

// the card's floor: a kernel that does nothing, and one thread that spins
// for `ns` nanoseconds of the global timer (queued first, it lets the host
// enqueue a run of launches that the card then takes back to back, for
// CUDA-event times)
__global__ void empty_kernel() {}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void spin_kernel(long long ns) {
  const long long t0 = global_ns();
  while (global_ns() - t0 < ns) {
  }
}

// rows * cols elements of a pass, within the int range its index takes
inline bool fits(int rows, int cols) {
  return rows > 0 && cols > 0 && (long long)rows * cols < (1ll << 31);
}

// every base on a 16-byte boundary (the passes' vectors)
inline bool aligned16() { return true; }
template <typename P, typename... Ps>
inline bool aligned16(const P* p, const Ps*... ps) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && aligned16(ps...);
}

}  // namespace diag
}  // namespace fpk

using namespace fpk::diag;

// A case's scalar arguments, made once by the caller and passed by
// address: one ctypes argument in place of up to five (ctypes converts
// every argument on every call, and a call's host time is what the probes
// measure). Each entry says which fields it reads.
struct DiagDims {
  int rows, cols;
  int a, b, c;
  float scale;
};

// Every entry returns the first CUDA error, else 0, and launches on
// `stream`. Tensors row-major, contiguous, 16-byte aligned.

// k1 (blk = 0): out [m, n] f32 = a [m, k] @ b [k, n], bf16. k2 (blk > 0,
// n a multiple of blk): out [(n / blk) * m, blk] holds the product's
// column blocks as row blocks. n a multiple of 64, k of 8. dims: rows m,
// cols n, a k, b blk.
extern "C" int fp_diag_matmul(const bf16* a, const bf16* b, float* out,
                              const DiagDims* dims, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = dims->rows, n = dims->cols, k = dims->a, blk = dims->b;
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

// k3: out [rows, cols] f32 = roll(a, shift), a bf16; cols a multiple of 4.
// dims: rows, cols, a shift.
extern "C" int fp_diag_roll_f32(const bf16* a, float* out,
                                const DiagDims* dims, void* stream) {
  const int rows = dims->rows, cols = dims->cols;
  if (!fits(rows, cols) || cols % 4 || !aligned16(a, out))
    return (int)cudaErrorInvalidValue;
  int shift = dims->a % rows;
  if (shift < 0) shift += rows;
  const int vecs = cols / 4;
  roll_to_f32<<<grid_for(rows * vecs), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, out, rows, vecs,
                                                     shift);
  return (int)cudaGetLastError();
}

// k4: out [rows, cols] = a * mask[:, col], mask [rows, mask_cols], f32;
// cols a multiple of 4. dims: rows, cols, a mask_cols, b col.
extern "C" int fp_diag_mask_col(const float* a, const float* mask, float* out,
                                const DiagDims* dims, void* stream) {
  const int rows = dims->rows, cols = dims->cols;
  const int mask_cols = dims->a, col = dims->b;
  if (!fits(rows, cols) || cols % 4 || col < 0 || col >= mask_cols ||
      !aligned16(a, out))
    return (int)cudaErrorInvalidValue;
  const int vecs = cols / 4;
  mask_col<<<grid_for(rows * vecs), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(a, mask, out, rows, vecs,
                                                  mask_cols, col);
  return (int)cudaGetLastError();
}

// k5 (step 128) and k9 (step 0): out [rows, copies * cols] bf16, copy j
// = roll(a, j * step); cols a multiple of 8. dims: rows, cols (a's), a
// copies, b step.
extern "C" int fp_diag_lane_concat(const bf16* a, bf16* out,
                                   const DiagDims* dims, void* stream) {
  const int rows = dims->rows, cols = dims->cols, copies = dims->a;
  if (copies < 1 || !fits(rows, cols * copies) || cols % 8 ||
      !aligned16(a, out))
    return (int)cudaErrorInvalidValue;
  int step = dims->b % rows;
  if (step < 0) step += rows;
  const int cpv = cols / 8;
  lane_concat<<<grid_for(rows * cpv * copies), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, out, rows, cpv,
                                                     copies, step);
  return (int)cudaGetLastError();
}

// k6: out [rows, cols] = (tanh a - b)(1 - tanh^2 a) * scale; a f32, b
// bf16; rows * cols a multiple of 4. dims: rows, cols, scale.
extern "C" int fp_diag_tanh_grad(const float* a, const bf16* b, float* out,
                                 const DiagDims* dims, void* stream) {
  const int rows = dims->rows, cols = dims->cols;
  if (!fits(rows, cols) || (rows * cols) % 4 || !aligned16(a, b, out))
    return (int)cudaErrorInvalidValue;
  const int n4 = rows * cols / 4;
  tanh_grad_narrow<<<grid_for(n4), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, b, out, n4,
                                                          dims->scale);
  return (int)cudaGetLastError();
}

// k8: out [rows, cols] f32 = shift(a, s1) + shift(a, s2), a bf16; cols a
// multiple of 4. dims: rows, cols, a s1, b s2.
extern "C" int fp_diag_shift_sum(const bf16* a, float* out,
                                 const DiagDims* dims, void* stream) {
  const int rows = dims->rows, cols = dims->cols;
  if (!fits(rows, cols) || cols % 4 || !aligned16(a, out))
    return (int)cudaErrorInvalidValue;
  const int vecs = cols / 4;
  shift_sum<<<grid_for(rows * vecs), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(a, out, rows, vecs,
                                                   dims->a, dims->b);
  return (int)cudaGetLastError();
}

// k7 (wrap = 1: roll) and k10 (wrap = 0: shift): acc = a [rows, cols] f32;
// `steps` times acc = bf16(move(acc, shift)) @ b [cols, cols] bf16; out =
// acc f32. Scratch s0, s1 [rows, cols] bf16. cols a multiple of 64. dims:
// rows, cols, a steps, b shift, c wrap.
extern "C" int fp_diag_chain(const float* a, const bf16* b, float* out,
                             bf16* s0, bf16* s1, const DiagDims* dims,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = dims->rows, cols = dims->cols, steps = dims->a;
  const bool wrap = dims->c != 0;
  int shift = dims->b;
  if (steps < 1 || !fits(rows, cols) || cols % 8 || !aligned16(a, s0, s1))
    return (int)cudaErrorInvalidValue;
  bf16* buf[2] = {s0, s1};
  fpk::Gemm g[2];
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < 2 && e == cudaSuccess; ++i)
    e = fpk::make_gemm<bf16>(&g[i], buf[i], b, rows, cols, cols);
  if (e != cudaSuccess) return (int)e;
  // every move reads row r - shift (roll: the shift taken mod rows) or
  // r + shift (shift)
  if (wrap) {
    shift %= rows;
    if (shift < 0) shift += rows;
  }
  const int vecs = cols / 8;
  move_cast<<<grid_for(rows * vecs), kThreads, 0, st>>>(a, s0, s1, rows,
                                                       vecs, shift, wrap);
  e = cudaGetLastError();
  for (int i = 0; i < steps && e == cudaSuccess; ++i) {
    if (i + 1 < steps) {
      e = fpk::launch_gemm<bf16>(
          g[i % 2], EpiMoveRowsBf16{buf[(i + 1) % 2], cols, rows, shift, wrap},
          nullptr, st);
    } else {
      e = fpk::launch_gemm<bf16>(g[i % 2], fpk::EpiStoreF32{out, cols},
                                 nullptr, st);
    }
  }
  return (int)e;
}

// The launch path's floor, for the timing of chip_smoke.py phase 11: a
// call that does nothing (the ctypes call alone), one empty kernel, and a
// spin of `ns` nanoseconds on one thread.
extern "C" int fp_diag_nop() { return 0; }

extern "C" int fp_diag_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" int fp_diag_spin(long long ns, void* stream) {
  spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ns);
  return (int)cudaGetLastError();
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
