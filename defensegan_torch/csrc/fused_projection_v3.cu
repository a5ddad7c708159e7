// Fused projection loop v3 (bf16) for the deep two-deconv generator in
// space-to-depth form.
//
// Replaces the Pallas TPU kernel
//   kernels/fused_projection_v3.py::_loop_kernel of the JAX package
// (pallas_call in fused_projection_s2d). The generator z -> fc -> 7x7xc0
// -> deconv -> 14x14 -> deconv -> 28x28 -> tanh is packed on the constant
// g x g grid (g = 7, P2 = 49 pixels): both stride-2 deconvs are 3x3 SAME
// convs with wide channels (c0 128 -> ca 256 -> cb 16). Per row of z, for
// L steps, with taps k = (dy+1)*3 + (dx+1), off_k = dy*g + dx:
//
//   h0  = relu(bf16(z) @ W1 + b1)                       [M, P2*c0] bf16
//   h1  = relu(sum_k h0[p+off_k] @ KA_k + ba)           [M, P2*ca] bf16
//   obb = h1[p] @ [KB_0 .. KB_8]                        [M, P2*npk] bf16
//   o   = bb + sum_k obb[p+off_k][k*cb : (k+1)*cb]      [P2*cb]
//   do  = (tanh(o) - x)(1 - tanh(o)^2) * scale          bf16
//   dop = [do[p-off_0] .. do[p-off_8]]                  [M, P2*kpk] bf16
//   dh1 = (dop[p] @ KBT) * [h1 > 0]                     bf16, over h1
//   dh0 = (sum_k bf16(dh1[p-off_k] @ KA_k^T)) * [h0>0]  bf16, over h0
//   dz  = dh0 @ W1^T;  v = m*v + dz;  z -= lr*v         [M, K] f32
//
// A tap whose source pixel leaves the grid contributes nothing. bf16
// operands, f32 accumulation, bf16 roundings exactly where the Pallas
// kernel has them, its two layout artefacts included (obb is rounded
// before the tap slices are summed; conv A's backward rounds each tap's
// product before the sum): the plain version (kernels/
// fused_projection_v3.py::s2d_loop_plain) rounds at the same points. The
// relu masks are taken from the stored bf16 activations, which are
// positive exactly where their f32 values were (bf16 keeps f32's exponent
// range), so the gradients overwrite the activations in place.
//
// What bounds it on an H100: operations, at 989 TFLOP/s bf16. The function
// itself (fc, the 5x5 stride-2 deconvs, forward and input gradient) needs
// 37.9 MFLOP per row-step; the dense s2d form counts 68.2 MFLOP (the s2d
// kernels' zero taps), of which this kernel computes 61.8 (border taps
// skipped; conv B stored 192 / 160 wide for its 144 lanes and issued 256
// wide / 192 deep, the GEMM's 128-column tile and 64-deep slab, the
// rest of each zero-filled). Per step the activations
// also make one round trip through device memory each (about 70 KB
// written per row), well under the compute time.
//
// Its design: the TPU kernel keeps activations pixel-major [49*T, C] in
// VMEM and shifts rows by slice + concat for every tap. Here every
// activation stays latent-major and flat, [M, P2*C] in (pixel, channel)
// order -- exactly what the fc product writes -- so no relayout exists:
//   * fc forward / backward are v2's first and last products, on the
//     Hopper GEMM (gemm_sm90.cuh: wgmma + TMA, persistent); the backward
//     (N = k = 128) splits its K = P2*c0 into fixed ranges, one reduction
//     adds them and runs the momentum update;
//   * conv A forward and backward are the Hopper grid conv
//     (conv3x3_sm90.cuh): persistent blocks of two wgmma consumer
//     warpgroups and a TMA producer, a tile of 128 latents x 128 channels
//     of one pixel, a tap a change of the TMA box's coordinates, 64-deep
//     slabs through a 6-stage ring; the forward sums its taps in one
//     chain, the backward rounds each tap's sum to bf16;
//   * conv B (16 channels per pixel, under a tile's width) is packed as
//     on the TPU: one product [M*P2, ca] @ [ca, 9*cb -> npk] on the GEMM
//     (the flat layout IS that matrix), then tanh_grad_pack, one block per
//     latent, sums the nine shifted slices, takes the tanh gradient into
//     shared memory and writes do packed tap-major [M*P2, 9*cb -> kpk],
//     which one GEMM product with KBT [kpk, ca] turns into dh1.
// Seven launches per step (eight with the split reduction); the tensor
// maps are encoded once per call and the L loop runs here, so one call
// from Python runs all L steps of a row chunk. The weights (4.6 MB) stay
// in L2. A fused conv B is later work.

#include "fused_projection_v3_step.cuh"

using fpk::bf16;

// Runs `iters` projection steps on M rows, updating z and v in place.
// z, v: [M, K] f32 (v zeroed by the caller); x: [M, P2*cb] bf16 tanh-space
// targets in s2d-flat order. Weights: w1 [K, P2*c0], w1t [P2*c0, K],
// ka [9*c0, ca], kat [9*ca, c0], kbp [ca, npk] (columns past 9*cb zero),
// kbpt [kpk, ca] (rows past 9*cb zero) bf16; b1 [P2*c0], ba [ca], bb [cb],
// masks [P2, 9] f32, order [P2] int32 (the pixels, 9 taps first).
// Scratch (bf16): zb [M, K], h0 [M, P2*c0], h1 [M, P2*ca], obb
// [M, P2*npk], dop [M, P2*kpk]; ws [M, splits * K] f32, the fc backward's
// split sums (splits: kernels/gemm.py::split_k_for(P2*c0, K)). M, K, c0,
// ca, npk multiples of 64; kpk of 8. Returns the first CUDA error, else 0.
extern "C" int fp_v3_run(float* z, float* v, const bf16* x, const bf16* w1,
                         const bf16* w1t, const float* b1, const bf16* ka,
                         const bf16* kat, const float* ba, const bf16* kbp,
                         const bf16* kbpt, const float* bb,
                         const float* masks, const int* order, bf16* zb,
                         bf16* h0, bf16* h1, bf16* obb, bf16* dop, float* ws,
                         int M, int K, int c0, int ca, int cb, int g, int npk,
                         int kpk, int splits, int iters, float lr,
                         float momentum, float scale, void* stream_ptr) {
  return fpk::v3::run<false, false, false>(
      z, v, x, w1, w1t, b1, ka, kat, ba, kbp, kbpt, bb, masks, order,
      nullptr, zb, h0, h1, obb, dop, ws, M, K, c0, ca, cb, g, npk, kpk,
      splits, iters, lr, momentum, scale, stream_ptr);
}

extern "C" const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
