"""The port of the JAX package's Pallas experiments under scripts/.

Each module holds an experiment's kernel wrapper (a hand-written CUDA
kernel under defensegan_torch/csrc/), its plain PyTorch version and the
functions its script drives; the scripts themselves are thin:

  stream64_probe       one fused deconv level of the 64x64 generator,
                       forward and input gradient, against cuDNN
                       (scripts/stream64_probe.py ->
                       scripts/stream64_probe_torch.py)
  fused_projection_v3p the deep loop on a padded 7 x 8 grid
                       (scripts/fused_projection_v3p_exp.py)
  v3_packed            the deep loop with conv A's backward as one chain
                       (scripts/pallas_v3_packed_exp.py)
  v3_ilp               the deep loop as two independent chains
                       (scripts/pallas_v3_ilp_exp.py)
  v3_variants          the A/B of the three against v3
                       (scripts/pallas_v3p_bench.py and the two scripts'
                       main -> scripts/pallas_v3_variants_torch.py)
  v3_diag              the ten construct probes of the v3 kernel
                       (scripts/pallas_v3_diag.py ->
                       scripts/pallas_v3_diag_torch.py)
  v3_diag2             v3's step cut after each of its sections
                       (scripts/pallas_v3_diag2.py ->
                       scripts/pallas_v3_diag2_torch.py)

Nothing on the served path imports them.
"""
