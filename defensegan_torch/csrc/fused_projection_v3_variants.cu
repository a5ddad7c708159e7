// The three layout experiments on the deep loop v3, each its own L loop:
// the padded grid (v3p), the tap-packed conv A backward (packed) and the
// two independent row chains of each conv A tile out of phase (ilp).
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
//    P = 56. On the TPU that drops the tap masks: an x-edge tap reads the
//    pad column, a y-edge tap a row index outside the grid, both zero. On
//    the H100 a tap mask costs nothing (the grid conv skips a masked
//    tap's slabs before any copy is issued), while a tap that reads only
//    zeros costs a whole slab of products. So conv A keeps the padded
//    layout but issues only what can be nonzero: the caller's masks count
//    a tap where its source is a real pixel (in [0, 56) and off the pad
//    column: v3's taps, 361 a direction) and its order walks the 49 real
//    pixels, so no pad pixel's tile is issued either way. The pad pixels
//    stay zero as on the TPU: W1 and b1 hold zero blocks there (the fc
//    writes h0 = 0), h1's pad column is zeroed once per call and never
//    written again (fused_projection_v3_step.cuh, `run`), do is
//    multiplied by the pad mask, and dh1 and dh0 are zero there through
//    the relu masks. A skipped tap's products were exact zeros, so z_final
//    is the all-taps design's bit for bit. The fc rounds its product to
//    bf16 before the bias (h0 = relu(bf16(z @ W1) + b1)), as the TPU
//    kernel's per-pixel blocks do. Still 56 / 49 wide: the fc, conv B and
//    tanh_grad_pack (later work: a tile mask in the GEMM).
//  * packed. Conv A's backward sums its nine taps in one chain (one
//    K = 9*ca product on the TPU) and rounds once, by the epilogue; v3
//    rounds each tap. The forward is v3's: already one chain. Its conv B
//    section (conv B forward, tanh_grad_pack, conv B backward: three
//    launches passing obb and dop through device memory in v3's
//    fp_v3_run) is one kernel, fused_projection_v3_step.cuh's
//    convb::section, as in v3's fp_v3_fused_run: a consumer
//    warpgroup takes a latent whole, both products against KBT resident
//    in shared memory, obb and dop only in shared memory and registers;
//    the same function with the same rounding points and summation
//    orders, so z_final is the three launches' bit for bit. Five launches
//    a step (six with the split-K sum).
//  * ilp. The TPU kernel runs two independent 32-latent subtiles per grid
//    step, so that one's vector stages hide under the other's matrix
//    products. On the H100 that lever lives inside a block: conv A, both
//    ways, runs on the grid conv's ping-pong schedule (conv3x3_sm90.cuh,
//    kPingPong): the two consumer warpgroups of a 128-row tile (two
//    independent 64-row chains) out of phase by about a tap, handed over
//    by an ordered pair of named barriers per tap, so that one's fold and
//    epilogue fall while the other's products are queued. (Two chains on
//    two CUDA streams tied v3: each persistent launch holds every SM, so
//    the other stream's launches queued behind it.) Every output element
//    sees v3's wgmma sequence, so z_final equals v3's bit for bit. Conv A
//    proved bound by its L2 feed forward and by its issue backward, not by
//    the in-phase stalls, so this ties v3 (PERF.md).
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
// [M, P*kpk] bf16, ws [M, splits*K] f32 (fp_v3_packed_run reads neither
// obb nor dop: they may be null). P = g*g, except in fp_v3p_run:
// P = g*(g+1), the padded grid (x, w1, w1t and b1 hold its zero pad
// pixels), masks [P, 9] counting a tap where its source is a real pixel,
// order [g*g] the real pixels, and padm [P] f32 (0 on the pad column).
// Returns the first CUDA error, else 0.
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
  return fpk::v3::run<false, true, false, true>(
      z, v, x, w1, w1t, b1, ka, kat, ba, kbp, kbpt, bb, masks, order, nullptr,
      zb, h0, h1, obb, dop, ws, M, K, c0, ca, cb, g, npk, kpk, splits, iters,
      lr, momentum, scale, stream);
}

// The packed loop with conv B's section as v3's three launches (conv B
// forward, tanh_grad_pack, conv B backward: the design before the fused
// section), for holding the fused section against it bit for bit.
extern "C" int fp_v3_packed_launches_run(
    float* z, float* v, const bf16* x, const bf16* w1, const bf16* w1t,
    const float* b1, const bf16* ka, const bf16* kat, const float* ba,
    const bf16* kbp, const bf16* kbpt, const float* bb, const float* masks,
    const int* order, bf16* zb, bf16* h0, bf16* h1, bf16* obb, bf16* dop,
    float* ws, int M, int K, int c0, int ca, int cb, int g, int npk, int kpk,
    int splits, int iters, float lr, float momentum, float scale,
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

// Conv A alone, as the loops launch it, for holding the ping-pong schedule
// against v3's and for measuring the conv's ceilings. in [M, g*g*cin], w
// [9*cin, cout] bf16; masks [g*g, 9], order [g*g]: v3's. backward 0: out
// = bf16(relu(in * w + bias)), one chain; 1: each tap rounded, out =
// bf16(acc) where out > 0, else 0, written over out; 2: as 1 with the taps
// in one chain, rounded once (packed's). pingpong 0: v3's
// schedule; 1: ilp's. probe 0: the conv; 1: the feed alone (no wgmma,
// zeros stored); 2: the products alone (no copies, out undefined).
// Returns the CUDA error, else 0.
template <fpk::Sched kSched, fpk::Probe kProbe>
static cudaError_t conv_a(const fpk::Conv3x3& c, const float* bias,
                          bf16* out, int backward, cudaStream_t st) {
  const int ld = c.g * c.g * c.cout;
  if (backward == 2)
    return fpk::launch_conv3x3<fpk::kChain, true, kSched, kProbe>(
        c, fpk::EpiConvReluMask{out, ld}, st);
  if (backward)
    return fpk::launch_conv3x3<fpk::kPerTapBf16, true, kSched, kProbe>(
        c, fpk::EpiConvReluMask{out, ld}, st);
  return fpk::launch_conv3x3<fpk::kChain, false, kSched, kProbe>(
      c, fpk::EpiConvBiasRelu{bias, out, ld}, st);
}

extern "C" int fp_conv_a(const bf16* in, const bf16* w, const float* bias,
                         const float* masks, const int* order, bf16* out,
                         int M, int g, int cin, int cout, int backward,
                         int pingpong, int probe, void* stream_ptr) {
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  fpk::Conv3x3 c;
  cudaError_t e = fpk::make_conv3x3(&c, in, w, masks, order, M, g, cin,
                                    cout);
  if (e != cudaSuccess) return (int)e;
  if (backward < 0 || backward > 2 || pingpong < 0 || pingpong > 1 ||
      probe < 0 || probe > 2)
    return (int)cudaErrorInvalidValue;
  using Fn = cudaError_t (*)(const fpk::Conv3x3&, const float*, bf16*, int,
                             cudaStream_t);
  static const Fn kRuns[3][2] = {
      {conv_a<fpk::kCoop, fpk::kWhole>, conv_a<fpk::kPingPong, fpk::kWhole>},
      {conv_a<fpk::kCoop, fpk::kFeedOnly>,
       conv_a<fpk::kPingPong, fpk::kFeedOnly>},
      {conv_a<fpk::kCoop, fpk::kMathOnly>,
       conv_a<fpk::kPingPong, fpk::kMathOnly>}};
  return (int)kRuns[probe][pingpong](c, bias, out, backward, st);
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
