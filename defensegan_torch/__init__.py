"""PyTorch/CUDA port of Defense-GAN for NVIDIA Hopper.

A second package beside the JAX one, the reference it is held against;
it imports nothing of it. Layout mirrors the JAX package:
configs/, ckpt/, data/, models/, defense/, gan/, eval/, attacks/, cli/,
utils/, kernels/, and csrc/ for the hand-written CUDA sources of the
fused projection loops.
"""
