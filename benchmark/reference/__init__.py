"""Plain reference of what a benchmark cell serves, in PyTorch and float32.

Written from the published semantics, independent of the program under
test: it imports nothing of `defensegan_torch` (nor JAX), and takes
weights in the flax layout of the repository's weight exports (the
format both sides are handed), never the program's packed forms.

  generator   the DCGAN-style WGAN generator, wide or deep, with flax's
              SAME stride-2 transpose convolutions
  projection  R restarts x L momentum-GD steps on the per-image MSE in
              tanh space, the best restart's G(z*) (Defense-GAN)
  encoder     the amortized-inversion encoder E(x) that starts restart 0
              of an encoder-initialised projection (flax SAME
              convolutions, LeakyReLU, NHWC flatten)
  classifier  model A of the Defense-GAN paper's appendix (flax SAME
              convolutions, NHWC flatten)
  detector    the two-sided reconstruction-error detector
  numerics    the precision contexts: float32 with TF32 off, and the
              fp8 control (every product's operands rounded to e4m3)
"""
