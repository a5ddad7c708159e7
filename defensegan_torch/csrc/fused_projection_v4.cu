// Fused projection loop v4 (bf16) for multi-deconv generators: the 64x64
// stacks (celeba, celeba_wide, imagenet64) and, as the edge case, the
// two-deconv MNIST deep topology.
//
// Replaces the Pallas TPU kernel
//   kernels/fused_projection_v4.py::_v4_kernel of the JAX package
// (pallas_call in fused_projection_v4). The generator z -> fc -> g0 x g0 x
// c0 -> [deconv 5x5/2 + BN + relu]* -> deconv 5x5/2 -> tanh is packed as a
// chain of 3x3 SAME convs on grids (kernels/fused_projection_v4.py of the
// port): a mid level maps [g, g, ci] to blocked [g, g, 4*co] (the deconv
// followed by space-to-depth) and, unless it is the last mid level, its
// output is interleaved to the fine grid [2g, 2g, co]; the out level maps
// the last mid level's blocked output to double-blocked [g, g, 16*out_c]
// (the last interleave and the out deconv folded into one conv). For
// celeba.yml: fc [128, 16*512], then (g, ci -> co) = (4, 512 -> 1024),
// (8, 256 -> 512), (16, 128 -> 256), out (16, 256 -> 48, padded to 64).
// Per row of z, for L steps, taps k = (dy+1)*3 + (dx+1), off_k = dy*g + dx:
//
//   h0  = relu(bf16(z) @ W1 + b1)                          bf16
//   a_i = relu(sum_k h[p+off_k] @ W_i,k + b_i)             bf16, stored in
//         fine order where level i interleaves
//   d   = (tanh(a_out) - x)(1 - tanh(a_out)^2) * scale     bf16, tanh of
//         the f32 sum
//   d_i = (sum_k bf16(d[p-off_k] @ W_i,k^T)) * [a_(i-1) > 0]  bf16, over
//         a_(i-1) in place
//   dz  = d_0 @ W1^T;  v = m*v + dz;  z -= lr*v            f32
//
// A tap whose source pixel leaves the grid contributes nothing. bf16
// operands, f32 accumulation, bf16 roundings exactly where the Pallas
// kernel has them (each tap's product of every backward conv is rounded
// before the sum); the plain version (v4_loop_plain) rounds at the same
// points. The relu masks are taken from the stored bf16 activations, which
// are positive exactly where their f32 values were, so the gradients
// overwrite the activations in place.
//
// What bounds it on an H100: operations, at 989 TFLOP/s bf16. The function
// itself (fc and the 5x5 stride-2 deconvs, forward and input gradient,
// only the multiply-adds that land inside the output) needs 548 MFLOP per
// row-step for celeba.yml; the dense grid-conv form counts 1023 MFLOP (the
// zero taps of the space-to-depth kernels), of which this kernel issues
// 884 (border taps skipped, the out level padded from 48 to 64 lanes). Per
// step every activation also makes one round trip through device memory
// (about 280 KB written per row), well under the compute time.
//
// Its design: the TPU kernel keeps a tile's activations pixel-major in
// on-chip memory, shifts rows by slice + concat for every tap and copies
// 4*g*g slices for every interleave. Here every activation stays
// latent-major and flat, [M, g*g*C] in (pixel, channel) order, as in v3:
//   * fc forward / backward are v2's first and last products, on the
//     Hopper GEMM (gemm_sm90.cuh); the backward (N = k = 128, K = 8192 for
//     celeba.yml: 8 tiles at 1024 rows) splits its K into fixed ranges,
//     one reduction adds them and runs the momentum update;
//   * every level, forward and backward, is the Hopper grid conv
//     (conv3x3_sm90.cuh): persistent blocks of two wgmma consumer
//     warpgroups and a TMA producer, a tile of 128 latents x 128 (the out
//     level: 64) channels of one pixel, a tap a change of the TMA box's
//     coordinates, 64-deep slabs through a 6-stage ring; a forward conv's
//     taps are summed one by one in float32 (the tensor cores' running sum
//     drifts with the length of its chain), a backward conv's rounded to
//     bf16 one by one;
//   * the interleave is a permutation of runs within a row, so a level
//     that interleaves stores straight into fine order and its backward
//     reads the gradient back through the same map: no launch, no copy;
//   * the out level's epilogue takes the tanh gradient of the f32
//     accumulator against x (padded lanes have zero weights, bias and
//     targets, so d = 0 there).
// 3 + 2 per level launches per step (11 for celeba.yml); the L loop runs
// here, so one call from Python runs all L steps of a row chunk, and the
// level list comes in as host arrays, so one library serves 2 to 4 levels.
// The tensor maps of every product are encoded once per call. celeba.yml's
// weights (29 MB with the transposes) fit the 50 MB L2, imagenet64.yml's
// (69 MB) do not.

#include "conv3x3_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

using fpk::bf16;

constexpr int kMaxLevels = 4;

// o = acc + bias[c]; t = tanh(o); d = (t - x)(1 - t^2) * scale -> bf16 at
// dout[r, pixel, c] (channels c, c + 1); x has dout's layout.
struct EpiConvTanhGrad {
  const float* bias;
  const bf16* x;
  bf16* dout;
  int ld;
  float scale;
  static constexpr bool kReads = true;
  __device__ __forceinline__ void prefetch(int r, int c, int pix_off) const {
    fpk::prefetch_l2(x + (size_t)r * ld + pix_off + c);
  }
  __device__ __forceinline__ float grad(float acc, float b, float xv) const {
    float t = tanhf(acc + b);
    return (t - xv) * (1.0f - t * t) * scale;
  }
  __device__ __forceinline__ void operator()(int r, int c, int pix_off,
                                             float a0, float a1) const {
    size_t i = (size_t)r * ld + pix_off + c;
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + i);
    *reinterpret_cast<__nv_bfloat162*>(dout + i) = __floats2bfloat162_rn(
        grad(a0, bias[c], __low2float(xv)),
        grad(a1, bias[c + 1], __high2float(xv)));
  }
};

struct Level {
  int g, ci, co, fine;
  const bf16* w;
  const bf16* wt;
  const float* b;
  const float* masks;
  const int* order;
  fpk::Conv3x3 fwd, bwd;   // tensor maps of the forward and backward conv
};

}  // namespace

// Runs `iters` projection steps on M rows, updating z and v in place.
// z, v: [M, K] f32 (v zeroed by the caller); x: [M, g*g*co] bf16
// tanh-space targets in the out level's double-blocked order. w1
// [K, g0*g0*c0], w1t [g0*g0*c0, K] bf16; b1 [g0*g0*c0] f32. The level list
// is two HOST arrays, read before this returns: level_ptrs holds, per
// level, the device pointers w [9*ci, co], wt [9*co, ci] (bf16), b [co],
// masks [g*g, 9] (f32), order [g*g] (int32: the pixels, 9 taps first);
// level_dims holds g, ci, co and the fine lane count of the level's
// interleave (0: none). The last level is the out level (tanh gradient,
// no relu); every other level has a relu. Scratch (bf16): zb [M, K];
// acts [M * (g0*g0*c0 + sum of g*g*co)], h0 and every level's output one
// after the other; ws [M, splits * K] f32, the fc backward's split sums
// (splits: kernels/gemm.py::split_k_for(g0*g0*c0, K)). M, K, c0, every ci
// and co multiples of 64; a level's ci equals the lanes its predecessor
// hands on. Returns the first CUDA error, else 0.
extern "C" int fp_v4_run(float* z, float* v, const bf16* x, const bf16* w1,
                         const bf16* w1t, const float* b1,
                         const void* const* level_ptrs,
                         const int* level_dims, bf16* zb, bf16* acts,
                         float* ws, int M, int K, int c0, int g0,
                         int n_levels, int splits, int iters,
                         float lr, float momentum, float scale,
                         void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (n_levels < 2 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Level lv[kMaxLevels];
  bf16* act[kMaxLevels + 1];
  int cols[kMaxLevels + 1];
  const int F = g0 * g0 * c0;
  act[0] = acts;
  cols[0] = F;
  for (int i = 0; i < n_levels; ++i) {
    Level& l = lv[i];
    l.g = level_dims[4 * i];
    l.ci = level_dims[4 * i + 1];
    l.co = level_dims[4 * i + 2];
    l.fine = level_dims[4 * i + 3];
    l.w = static_cast<const bf16*>(level_ptrs[5 * i]);
    l.wt = static_cast<const bf16*>(level_ptrs[5 * i + 1]);
    l.b = static_cast<const float*>(level_ptrs[5 * i + 2]);
    l.masks = static_cast<const float*>(level_ptrs[5 * i + 3]);
    l.order = static_cast<const int*>(level_ptrs[5 * i + 4]);
    bool widths = l.ci % 64 == 0 && l.co % 64 == 0 &&
                  l.g * l.g * l.ci == cols[i] &&
                  (l.fine == 0 || (l.fine % 64 == 0 && 4 * l.fine == l.co));
    if (!widths || (i == n_levels - 1 && l.fine != 0))
      return (int)cudaErrorInvalidValue;
    cols[i + 1] = l.g * l.g * l.co;
    act[i + 1] = act[i] + (size_t)M * cols[i];
    // forward: act[i] -> act[i + 1]; backward: the gradient in act[i + 1]
    // (read in fine order where the level interleaves) -> over act[i]
    cudaError_t e = fpk::make_conv3x3(&l.fwd, act[i], l.w, l.masks, l.order,
                                      M, l.g, l.ci, l.co, 0, l.fine);
    if (e == cudaSuccess)
      e = fpk::make_conv3x3(&l.bwd, act[i + 1], l.wt, l.masks, l.order, M,
                            l.g, l.co, l.ci, l.fine, 0);
    if (e != cudaSuccess) return (int)e;
  }
  fpk::Gemm fc, fct;
  cudaError_t e = fpk::make_gemm<bf16>(&fc, zb, w1, M, F, K);
  if (e == cudaSuccess)
    e = fpk::make_gemm<bf16>(&fct, act[0], w1t, M, K, F, splits);
  if (e == cudaSuccess) e = fpk::launch_cast_bf16(z, zb, M * K, st);
  for (int it = 0; it < iters && e == cudaSuccess; ++it) {
    // fc forward
    e = fpk::launch_gemm<bf16>(fc, fpk::EpiBiasRelu{b1, act[0], F}, nullptr,
                               st);
    if (e != cudaSuccess) return (int)e;
    // the levels forward; the out level ends in the tanh gradient
    for (int i = 0; i < n_levels; ++i) {
      const Level& l = lv[i];
      if (i + 1 < n_levels) {
        e = fpk::launch_conv3x3<fpk::kPerTap, false>(
            l.fwd, fpk::EpiConvBiasRelu{l.b, act[i + 1], cols[i + 1]}, st);
      } else {
        e = fpk::launch_conv3x3<fpk::kPerTap, false>(
            l.fwd, EpiConvTanhGrad{l.b, x, act[i + 1], cols[i + 1], scale},
            st);
      }
      if (e != cudaSuccess) return (int)e;
    }
    // the levels backward: each tap rounded, masked by the input
    // activation's relu, written over it
    for (int i = n_levels - 1; i >= 0; --i) {
      const Level& l = lv[i];
      e = fpk::launch_conv3x3<fpk::kPerTapBf16, true>(
          l.bwd, fpk::EpiConvReluMask{act[i], cols[i]}, st);
      if (e != cudaSuccess) return (int)e;
    }
    // fc backward + momentum update
    e = fpk::launch_gemm<bf16>(
        fct, fpk::EpiMomentum{z, v, zb, K, momentum, lr}, ws, st);
  }
  return (int)e;
}

// One grid conv on its own, for checking the conv against a reference.
// in: [M, g*g*cin] (fine order where in_fine), w: [9*cin, cout], out:
// [M, g*g*cout] (fine order where out_fine). mode 0: forward, one chain,
// out = bf16(relu(acc + bias)); 1: the same, taps summed one by one; 2:
// forward per tap, out = the tanh gradient of acc + bias against x (out's
// layout) times scale; 3: backward, each tap rounded, out = bf16(acc) where
// out > 0, else 0, written over out. Returns the CUDA error, else 0.
extern "C" int fp_conv3x3(const bf16* in, const bf16* w, const float* bias,
                          const float* masks, const int* order,
                          const bf16* x, bf16* out, int M, int g, int cin,
                          int cout, int in_fine, int out_fine, int mode,
                          float scale, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  fpk::Conv3x3 c;
  cudaError_t e = fpk::make_conv3x3(&c, in, w, masks, order, M, g, cin, cout,
                                    in_fine, out_fine);
  if (e != cudaSuccess) return (int)e;
  const int ld = g * g * cout;
  switch (mode) {
    case 0:
      e = fpk::launch_conv3x3<fpk::kChain, false>(
          c, fpk::EpiConvBiasRelu{bias, out, ld}, st);
      break;
    case 1:
      e = fpk::launch_conv3x3<fpk::kPerTap, false>(
          c, fpk::EpiConvBiasRelu{bias, out, ld}, st);
      break;
    case 2:
      if (out_fine) return (int)cudaErrorInvalidValue;
      e = fpk::launch_conv3x3<fpk::kPerTap, false>(
          c, EpiConvTanhGrad{bias, x, out, ld, scale}, st);
      break;
    case 3:
      if (out_fine) return (int)cudaErrorInvalidValue;
      e = fpk::launch_conv3x3<fpk::kPerTapBf16, true>(
          c, fpk::EpiConvReluMask{out, ld}, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
