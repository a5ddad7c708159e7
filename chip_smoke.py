#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three served paths and holds every kernel of them
against its plain PyTorch version, then the white-box evaluation path
(phase 6), training (phase 7), the black-box path (phase 8), several
devices (phase 9), the ported Pallas experiments of scripts/ (phase 10)
and its two compile probes (phase 11):

  - the flagship (configs/gans/mnist_fast.yml: wide generator, k 128,
    F 6272, 784 outputs padded to P 832; trained step-20000 weights from
    the committed numpy export) on kernels v2 (bf16) and v2i (int8);
  - the reference-depth deep generator (configs/gans/mnist.yml: k 128,
    fc -> 7x7x128 -> deconv -> 14x14x64 -> deconv -> 28x28, R 10, L 200)
    on kernel v3. No trained deep checkpoint is in the repository: its
    weights are the seeded init, with every BatchNorm's scale, bias,
    running mean and variance set from a seeded generator so that the BN
    fold is not the identity. No accuracy is stated for it.
  - the 64x64 generator (configs/gans/celeba.yml: k 128, fc -> 4x4x512 ->
    three 5x5/2 deconvs -> 32x32x64 -> deconv -> 64x64x3, R 2, L 200) on
    kernel v4, requested as PROJECTION_KERNEL pallas_v4 (opt-in: auto stays
    on the generic path). Seeded weights like the deep model's: no trained
    64x64 checkpoint is in the repository. celeba_wide.yml (three levels)
    and imagenet64.yml (k 256, widths of 96) run one step each against the
    plain version, and the deep MNIST model runs through v4 once as its
    two-level edge case.

  1. device: the card's name and power limit; builds the CUDA kernels
     from csrc/ (one nvcc per source, concurrently)
  2. load: DefenseGAN on cuda, the flagship from output/gans/mnist_fast/
     export, the deep and the 64x64 ones seeded
  3. kernels vs plain versions at full width:
       a. z_final after L = 1 and L = 5 steps at 512 rows, elementwise
          (v3 and v4 row by row, beside the plain version's own float32
          against float64 drift); and 192-row chunks (the last one short)
          bit for bit against one chunk; v4 also at L = 1, 128 rows, on
          celeba_wide.yml and imagenet64.yml
       a''. every grid conv of v3 and v4 (the Hopper conv, celeba.yml's
          levels and v3's conv A, forward and backward) on its own at 256
          rows against its plain version, within one bf16 ulp of the
          output plus one of every rounded tap
       a'''. every product of v2 and v2i (the Hopper GEMM under all four
          loops) on its own at the flagship's shapes and 512 rows, with
          the loop's epilogue, against its plain version: bf16 within
          gemm.rounding_excess, the int8 products' int32 sums bit for
          bit; the fc backward (split K) also at 10240 rows and at v4's
          K 8192 x 1024 rows
       b. L = 200 at the timed shapes (R 10, 1024 images; v4: R 2, 512
          images), half clean and half with +-0.1 noise: [B, R] final
          losses by the tie-aware measure, each kernel against its own
          plain version; int8 against the fp32 plain path with the bf16
          kernel as the control (the int8_gate.json criterion); v3 and v4
          also by the relative error of the final losses (seeded weights
          can leave the tie-aware gate vacuous, which the line then says);
          v4 against the fp32 generic path (kernel="xla") with its plain
          version as the control
  4. serving, all launch counters set to 0 just before: DefendedPipeline
     (classifier E, seeded random init: no trained classifier is in the
     repository) calibrate + predict on the flagship with
     PROJECTION_KERNEL auto (-> v2), pallas_int8 (-> v2i) and
     rec_init=encoder, on the deep model with auto (-> v3), and on the
     64x64 model with pallas_v4 (-> v4; a two-class classifier, the
     requests as uint8); direct reconstructs of 100 images (auto on the
     64x64 model must report xla and launch nothing); one AuditedPipeline
     (serve R 2 x L 50 encoder init, audit R 10 x L 200, audit_prob 0.1)
     on the flagship; every kernel's counter must have risen
  5. timing at 1024 images x R 10 x L 200 (v4: 512 images x R 2 x L 200),
     median of 3, synchronized: each kernel, its plain version (v4's: one
     run after the warm-up), the library yardstick (the same loop on
     torch.matmul / torch._int_mm / cuDNN convolutions, which the port
     never calls), the fp32 plain path of the flagship and the generic
     path (kernel="xla") of the 64x64 model in fp32 and in its own bf16
  6. the white-box path on the trained flagship (chip_smoke.whitebox_phase):
       a. the exact d/dx of the summed defended logits (classifier A,
          seeded; L 5, 16 images of the replay set, R 10) on the card
          against the same function on the CPU, both float32, within
          GRAD_REL_MAX; the BPDA gradient against the classifier's
          gradient at G(z*); the cosine of the served bf16 model's
          gradient to the fp32 one (reported)
       b. one exact-mode gradient at L 50 and L 200 on 64 images (the bf16
          model): seconds and peak memory above the inputs
       c. whitebox_torch.main end to end at R 10, L 200, classifier A
          trained one epoch on the synthetic stand-in data: FGSM (BPDA) on
          256 images, FGSM (exact) on 64 (one attack batch: each is one
          exact gradient at L 200), PGD (BPDA, 10 steps) on 256, SPSA (2
          iterations, --detect) on 256; the defended evaluation, the
          detector and SPSA's queries must report `last_kernel` pallas (v2)
       d. the --load_adv replay gate: output/advsets/flagship_conf_l300.npz
          through v2 and through v2i (PROJECTION_KERNEL pallas_int8) with
          --detect, held by distribution against the JAX package's
          output/detstats/flagship_conf_l300.npz (REPLAY_* bounds);
          flagship_spsa_l300.npz through v2, its AUC printed beside JAX's
       launch counters set to 0 before c and read after: v2 and v2i must
       have run
  7. training (chip_smoke.training_phase; files under a temporary
     directory, never under output/gans/):
       a. one full train step (DISC_ITERS 5 critic updates + the generator
          update, BATCH_SIZE 64) of mnist_fast.yml, mnist.yml (deep) and
          celeba.yml (4-level critic, 64x64x3) at full width, seeded, on
          the card and on the CPU in float32 with TF32 off: losses,
          gradients and BatchNorm running statistics within the TRAIN_*
          bounds; and each family's generator steps/s in its own bf16
       b. train_torch.py --is_train on mnist_fast.yml (bf16, the synthetic
          stand-in) for TRAIN_STEPS (1500) from the seeded init: the
          medians of wasserstein and gp over its logged steps within the
          committed JAX curve's interquartile range over the same steps;
          then test
          mode on its export (v2 at R 10, L 200) beside the committed
          step-20000 generator's mean best-restart loss (a path check)
       c. train_torch.py --train_encoder for 300 steps against a temporary
          copy of the committed flagship: img_mse and z_cycle at the first
          and the last log (the objective must fall), s a step, and the
          export read back
       launch counters set to 0 before b and read after its test mode:
       v2 must have run
  8. the black-box path (chip_smoke.blackbox_phase): jacobian_augmentation
     on the card against the CPU (JACOBIAN_* bounds), then
     blackbox_torch.py on the committed flagship (--bb_model A --sub_model
     B --data_aug 6 --num_tests 256 --classifier_epochs 1 --detect, R 10,
     L 200): every key of the JAX row, the defended phases and the
     detector on v2 (counters set to 0 just before, v2 must have run);
     phase times and accuracies (path checks)
  9. several devices (chip_smoke.parallel_phase), from the repository's
     root:
       a. the flagship at full width (1024 images x R 10 x L 200, v2)
          through ShardedDefenseGAN over [cuda:0] and over [cuda:0,
          cuda:0] (two shards on the card), each equal bit for bit to the
          single-device calls on its shards with the folded seeds; a
          DefendedPipeline over the two-shard GAN; the sharded call at one
          shard against the bare call, in turns (the wrapper's overhead);
          counters set to 0 before the sharded calls and read after: v2
          must have run, once a shard
       b. a process group of one NCCL rank (file:// rendezvous in a
          temporary directory): the explicit DP step and the global-batch
          step on mnist_fast.yml at full width, B 64, given the plain
          step's draws, equal to it bit for bit (cuDNN's deterministic
          algorithms, a second plain step as the control); steps/s of each
       c. multichip_torch.dryrun_multichip(1) on the card and
          dryrun_multichip(4, device="cpu")
       d. scripts/int8_validate_torch.py on the committed flagship (the
          stamp into a temporary directory; it must pass) and
          scripts/serving_bench_torch.py --batches 1 16 256 1024 4096
          --repeats 3 (classifier A from phase 6's cache, else a seeded one
          in a temporary cache); counters set to 0 before and read after:
          v2 and v2i must have run
 10. the experiments' kernels (chip_smoke.experiments_phase):
       a. the stream64 level (the 64x64 generator's deconv levels 0-2 at
          batch 512) against its plain version, half by half
       b. each v3 variant (v3p, packed, ilp) on mnist.yml against its plain
          version at L = 1 and 5 on 512 rows as 3a; the two-chain loop
          also bit for bit against the v3 kernel
       c. counters set to 0, then the experiments' entry points:
          stream64_probe.run_probe at each level (batch 512, the JAX
          probe's tiles, 50 steps, median of 3: kernel, cuDNN, plain;
          per-level and geomean speedup beside the pre-registered rule)
          and v3_variants.ab_variant for each variant (1024 images x R 10
          x L 200: the gate against the v3 kernel, ilp bit for bit; loop
          and recon times in turns with v3's, median of 3); every
          experiment's counter must have risen
       d. the variants' plain versions at that shape, one run each
 11. the compile probes (chip_smoke.probes_phase):
       a. the ten cases of scripts/pallas_v3_diag.py at its shapes, each
          kernel against its plain version (v3_diag.check)
       b. the seven cuts of scripts/pallas_v3_diag2.py on mnist.yml
          (seeded) at 64 latents: each section against the plain
          version's from the kernel's own earlier sections, z_out equal to
          z0 before `full`, `full` row by row as v3 at L 1; then with one
          NaN in x, the NaN patterns of every cut; one plan
          (v3_diag2.prepare) through every cut, clean and NaN, its
          graphs replayed, bit for bit against the fresh calls (a pack
          alone: the same launches issued one by one)
       c. counters set to 0, then the two scripts' runs
          (v3_diag.run_cases, v3_diag2.run_cuts: each case and cut
          checked, then timed on the host clock, 20 calls in a row, the
          median of PROBE_REPEATS rounds (a cut: 3) in turns with the
          plain version and the library composition, and on the card by
          CUDA events: a cut on its plan, with its device profile);
          both counters must have risen; the launch path's floor
          (v3_diag.launch_costs: a bare ctypes call, an empty kernel, a
          torch op); no case may be slower than its PyTorch composition:
          the median over the rounds of the kernel's host time over the
          composition's, both writing into the same given output (the
          launch path against torch's dispatch; the allocating calls'
          ratio is recorded beside it)
       d. v3's z_final at 512 rows x L 5 and 10240 x L 200 against the
          digests of scripts/torch_v3_zfinal.py; a card or torch build
          with no recorded digest fails the phase
 12. the `kernels` line (the four loops, the four experiments and the two
     probes), then {"ok": true, "device": {...}} last.

Every phase prints one JSON line; any failed check exits nonzero. There is
no CPU fallback: without a CUDA device the script exits 2 and prints no
result. The full record also goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "output", "gans", "mnist_fast")
CFG_DIR = os.path.join(ROOT, "defensegan_torch", "configs", "gans")
DEEP_CFG = os.path.join(CFG_DIR, "mnist.yml")

# Published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# (a) elementwise tolerance on z_final, relative to how far the plain
# version moved z: kernel and plain version differ only in f32 summation
# order, which flips a bf16 rounding of an intermediate (one bf16 ulp is
# 2^-8 = 3.9e-3 relative) in a small share of elements; lr = 10 momentum
# steps carry the flips forward, so the bound grows with L.
ELEMENTWISE_TOL = {1: 4e-3, 5: 2e-2}
# The deep loop (v3) has two relu masks and seven rounding points per
# step: in a few rows of 512 a pre-activation within float32 noise of zero
# takes the other side of its relu, which switches a whole gradient
# element (about 1% of that row's step; two float32 summation orders of
# the plain version itself drift as far apart, the `control` on the line:
# float32 against exact float64 products). So v3 is held row by row: the
# MEDIAN row's error relative to its step within the bound above (a
# misplaced tap or mask moves every row by tens of percent), and the worst
# row within the looser bound below.
V3_WORST_ROW_TOL = {1: 5e-2, 5: 1e-1}
# v4 is held the same way, relative to the same control. A row of
# celeba.yml holds 139264 activations over four levels, each a sum of up to
# 9 x 512 products (9 x 768 for imagenet64.yml), so every row carries some
# flipped bf16 roundings and the control itself moves the MEDIAN row: by
# 1.4e-3 of its step at L = 1 and 7.7e-3 at L = 5 on celeba.yml, 2.3e-3 at
# L = 1 on imagenet64.yml. Over three models, three seeds and 128 or 512
# rows the kernel's median row moved 1.1 to 2.1 times as far as the
# control's (at most 2.2e-3 on celeba.yml, 4.9e-3 on imagenet64.yml) and
# its worst row 0.7 to 2.2 times (scripts/torch_v4_row_drift.py; NVIDIA
# H100 80GB HBM3, 700.00 W). So v4's median row is held to the larger of
# the elementwise bound above and 3 times the control's median row, its
# worst row to the larger of v3's bound and 3 times the control's worst
# row. A misplaced tap, lane or interleave moves every row by tens of
# percent (v4_row_bounds below).
# (b) restart selection of a kernel against its own plain version:
# material disagreement and best-loss p95 |delta| (the bf16 tie tau)
MATERIAL_MAX = 0.03
P95_MAX = 2e-3
# (b) for v3 and v4 also the relative error of the kernel's final [B, R]
# losses against the plain version's: median and 95th percentile
V3_LOSS_REL_P50_MAX = 1e-2
V3_LOSS_REL_P95_MAX = 1e-1
# (4) mean best-restart tanh-space MSE on clean G(z) requests: an
# unrelated digit scores ~0.3 (printed beside it), a recovered one ~1e-3
CLEAN_LOSS_MAX = 0.02
# (6) white-box phase. The exact d/dx of the summed defended logits (L 5,
# 16 images, R 10) on the card against the same function on the CPU, both
# in float32 with TF32 off: max |difference| within this share of the
# CPU gradient's largest element. On the CPU the float32 gradient sits
# 4.3e-7 of it from the float64 one; a relu pre-activation within float32
# noise of zero that takes the other side on the card moves an element
# by ~1e-4; a missing step or term of the second-order pass moves it by
# percent.
GRAD_REL_MAX = 1e-3
# BPDA: the gradient of the straight-through target is the classifier's
# gradient at x + (G(z*) - x), the same function evaluated twice
BPDA_REL_MAX = 1e-5
# The --load_adv replay of output/advsets/flagship_conf_l300.npz (the first
# 128 images of the synthetic stand-in's test split, as the JAX package
# crafted it, and their detection-aware SPSA attacks) through v2 and v2i
# at R 10, L 200, held by distribution against the JAX package's
# statistics of the same set (output/detstats/flagship_conf_l300.npz,
# R 10, L 200): the two packages draw different z0, so the medians of the
# clean and the adversarial rec errors within 5% relative, and the
# clean-vs-adversarial AUC within 0.05. The JAX package's own 8 passes over
# the set (flagship_conf_l300_k8.npz) spread by 0.9% and 0.3% in these
# medians and from 0.525 to 0.555 in the AUC (std 0.009; the difference of
# two independent passes has std 0.013, and 0.05 is 4 of those).
REPLAY_MEDIAN_REL_MAX = 0.05
REPLAY_AUC_ABS_MAX = 0.05
ADVSET = os.path.join(ROOT, "output", "advsets", "flagship_conf_l300.npz")
ADVSET_SPSA = os.path.join(ROOT, "output", "advsets",
                           "flagship_spsa_l300.npz")
DETSTATS = os.path.join(ROOT, "output", "detstats", "flagship_conf_l300.npz")
DETSTATS_SPSA = os.path.join(ROOT, "output", "detstats",
                             "flagship_spsa_l300.npz")

# (7) training. 7a: one full step (DISC_ITERS 5 critic updates + the
# generator update, BATCH_SIZE 64) of each model family at full width, on
# the card and on the CPU, same seeded weights, batch and draws, float32
# with TF32 off. Both run the port's code; they differ in summation order
# and in the convolution algorithms (cuDNN against the CPU's): 1e-6
# relative per operation, which this gate holds, so TF32 or a wrong
# algorithm (1e-3 and more on every tensor) shows. But the critic's leaky
# ReLU and the generator's ReLU are not differentiable at 0: a
# pre-activation within float32 noise of 0 can take the other side on the
# card, which changes its derivative (1 against 0.2, or 0) and moves a few
# elements of a gradient tensor by up to percent of the tensor's largest
# one (the input gradient of the critic sums few terms per pixel). The
# line counts
# those pre-activations (`sign_flips`).
#   - At the same weights (the step's first critic update and a generator
#     update, both from the initial weights): the losses within 1e-4 of
#     their value (of 1e-2 where smaller: the penalty holds the critic's
#     input gradient too). Each parameter tensor's max |card - CPU| within
#     1e-4 of that tensor's largest gradient element when no pre-activation
#     took the other side; else within 5e-2 (one or two flips moved
#     mnist.yml's worst tensor by 2.9e-3 to 4.0e-3, fifteen moved
#     celeba.yml's by 7.2e-4 at the median and 4.9e-3 at worst). A tensor
#     whose exact gradient is 0 (the deconv biases before a BatchNorm, the
#     critic's output bias) below 1e-4 of the module's largest gradient
#     on both sides.
#   - After the full step: the losses of its last critic update and of its
#     generator update within 1e-3, and the BatchNorm running statistics
#     within 1e-4 of each vector's largest element (one update, by the
#     generator step's batch: a second update by a critic forward would
#     move the mean by 1%). Adam's steps are lr g / (|g| + eps) per
#     element, so a flipped gradient element steps differently on the
#     card: the step's later gradients are reported, not gated.
# This PR's first chip runs gated every tensor without counting flips:
# after the step within 1e-2 (celeba.yml's generator fc_in measured
# 1.2e-2 to 1.3e-2), then at the same weights within 1e-3 (mnist.yml's
# critic conv_1 measured 2.9e-3, its median tensor 6.9e-7, one flip). On
# mnist_fast.yml no pre-activation flipped and every tensor agreed within
# 4.2e-6.
TRAIN_SAME_LOSS_REL_MAX = 1e-4
TRAIN_GRAD_REL_MAX = 1e-4
TRAIN_GRAD_FLIP_REL_MAX = 5e-2
TRAIN_ZERO_GRAD_REL_MAX = 1e-4
TRAIN_LOSS_REL_MAX = 1e-3
TRAIN_STATS_REL_MAX = 1e-4
# 7b: train_torch.py --is_train on mnist_fast.yml (bf16, as configured;
# the synthetic stand-in data, as the committed run) for TRAIN_STEPS
# generator steps from the seeded init, logged every 100 steps: about a
# minute at the 23.71 generator steps/s this PR's first 5000-step run on
# the card measured. The medians of `wasserstein` and `gp` over its logged
# steps are held against the medians of the committed JAX curve
# (output/gans/mnist_fast/metrics.jsonl, its last run: one line every 100
# steps to 20000) over the same steps, within that window's own
# interquartile range on the JAX curve (at 1500 steps: wasserstein
# 5.2488 +- 0.4053, gp 0.0529 +- 0.0166). The port draws other random
# numbers, so the curves agree by distribution, not step by step; the
# JAX package's own four other runs in that file put their window
# medians at 5.32, 6.09, 5.35, 5.25 (wasserstein) and 0.057, 0.083,
# 0.054, 0.053 (gp).
TRAIN_STEPS = 1500
JAX_CURVE = os.path.join(RUN_DIR, "metrics.jsonl")
# 8: jacobian_augmentation on the card against the CPU, the same seeded
# substitute (model B) and images: equal wherever the CPU's input gradient
# is farther than 1e-4 of its largest element from 0 (the two sides' float32
# gradients differ by ~1e-6 of it); nearer to 0 the sign is the
# rounding's, and at most 1e-3 of the elements may differ there
JACOBIAN_NOISE_REL = 1e-4
JACOBIAN_FLIP_SHARE_MAX = 1e-3
# the JAX black-box CLI's results row (defensegan_tpu/cli/blackbox.py)
BLACKBOX_KEYS = (
    "script", "dataset", "bb_model", "sub_model", "defense", "fgsm_eps",
    "data_aug", "lmbda", "train_on_recs", "sub_from_scratch", "num_tests",
    "clean_acc", "sub_agreement", "clean_defended_acc",
    "adv_acc_no_defense", "defended_acc", "detection_auc",
    "detection_tpr_at_fpr05", "detection_auc_two_sided",
    "detection_tpr_at_fpr05_two_sided", "detection_auc_combined",
    "detection_tpr_at_fpr05_combined", "undetected_success_rate",
    "undetected_success_rate_two_sided", "undetected_success_rate_combined",
    "rec_err_clean_mean", "rec_err_adv_mean", "phases")

RECORD: dict = {}


def v4_row_bounds(steps: int, control: dict):
    """(median-row bound, worst-row bound) of v4 against its plain version,
    given the plain version's float32-against-float64 row errors."""
    return (max(ELEMENTWISE_TOL[steps], 3.0 * control["row_rel_p50"]),
            max(V3_WORST_ROW_TOL[steps], 3.0 * control["row_rel_max"]))


def emit(phase: str, **kw) -> None:
    RECORD[phase] = kw
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def median_ms(fn, repeats: int = 3) -> float:
    """Median host time of `repeats` synchronized calls after one warm-up
    call (which also takes the first-use build)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def library_loop_v2(pack, x_pad, z0, *, rec_iters, rec_lr, momentum):
    """The v2 loop on torch.matmul in bf16 (cuBLAS): the yardstick only."""
    import torch
    bf = torch.bfloat16
    z = z0.clone()
    v = torch.zeros_like(z)
    x = x_pad.float()
    scale = 2.0 / pack.out_dim
    for _ in range(rec_iters):
        h = torch.relu(torch.matmul(z.to(bf), pack.w1).float() + pack.b1)
        t = torch.tanh(torch.matmul(h.to(bf), pack.d).float() + pack.bd)
        do = ((t - x) * (1.0 - t * t) * scale).to(bf)
        dh = torch.where(h > 0, torch.matmul(do, pack.dt).float(), 0.0)
        v = momentum * v + torch.matmul(dh.to(bf), pack.w1t).float()
        z = z - rec_lr * v
    return z


def library_loop_v2i(pack, x_pad, z0, *, rec_iters, rec_lr, momentum):
    """The v2i loop with torch._int_mm for the D products: yardstick."""
    import torch
    from defensegan_torch.kernels.fused_projection_v2i import _quant_rows
    base, bf = pack.base, torch.bfloat16
    z = z0.clone()
    v = torch.zeros_like(z)
    x = x_pad.float()
    scale = 2.0 / base.out_dim
    for _ in range(rec_iters):
        h = torch.relu(torch.matmul(z.to(bf), base.w1).float() + base.b1)
        hq, sh = _quant_rows(h)
        o = torch._int_mm(hq, pack.dq).float() * (sh * pack.sd) + base.bd
        t = torch.tanh(o)
        gq, sg = _quant_rows((t - x) * (1.0 - t * t) * scale)
        dh = torch._int_mm(gq, pack.dtq).float() * (sg * pack.sdt)
        dh = torch.where(h > 0, dh, 0.0).to(bf)
        v = momentum * v + torch.matmul(dh, base.w1t).float()
        z = z - rec_lr * v
    return z


def library_loop_v3(pack, x_s2d, z0, *, rec_iters, rec_lr, momentum):
    """The v3 loop on the library's calls, in bf16: torch.matmul for the
    fc and F.conv2d (cuDNN) for the two 3x3 grid convs and their input
    gradients (the convolution with the flipped, transposed kernel). The
    yardstick only; it rounds where bf16 tensors round, not where the
    kernel does."""
    import torch
    import torch.nn.functional as F
    bf, cl = torch.bfloat16, torch.channels_last
    g, c0, ca, cb = pack.grid_hw, pack.c0, pack.ca, pack.cb
    n = z0.shape[0]
    wa = pack.ka.reshape(3, 3, c0, ca).permute(3, 2, 0, 1)   # OIHW
    wb = pack.kbp.reshape(ca, 3, 3, cb).permute(3, 0, 1, 2)
    wat = wa.flip(2, 3).transpose(0, 1).contiguous(memory_format=cl)
    wbt = wb.flip(2, 3).transpose(0, 1).contiguous(memory_format=cl)
    wa, wb = (w.contiguous(memory_format=cl) for w in (wa, wb))
    b1 = pack.b1.reshape(1, -1)
    ba, bb = (b.reshape(1, -1, 1, 1) for b in (pack.ba, pack.bb))
    x = x_s2d.float().reshape(n, g, g, cb).permute(0, 3, 1, 2)
    scale = 2.0 / (g * g * cb)
    z = z0.clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        h0 = torch.relu(torch.matmul(z.to(bf), pack.w1).float() + b1)
        h0 = h0.reshape(n, g, g, c0).permute(0, 3, 1, 2)   # NCHW view
        h1 = torch.relu(F.conv2d(h0.to(bf), wa, padding=1).float() + ba)
        t = torch.tanh(F.conv2d(h1.to(bf), wb, padding=1).float() + bb)
        do = ((t - x) * (1.0 - t * t) * scale).to(bf)
        dh1 = torch.where(h1 > 0, F.conv2d(do, wbt, padding=1).float(), 0.0)
        dh0 = torch.where(h0 > 0,
                          F.conv2d(dh1.to(bf), wat, padding=1).float(), 0.0)
        dh0 = dh0.to(bf).permute(0, 2, 3, 1).reshape(n, -1)
        v = momentum * v + torch.matmul(dh0, pack.w1t).float()
        z = z - rec_lr * v
    return z


def library_loop_v4(pack, x_flat, z0, *, rec_iters, rec_lr, momentum):
    """The v4 loop on the library's calls, in bf16: torch.matmul for the
    fc, F.conv2d (cuDNN, channels-last) for every level's 3x3 grid conv and
    its input gradient, the interleaves as reshapes. The yardstick only; it
    rounds where bf16 tensors round, not where the kernel does."""
    import torch
    import torch.nn.functional as F
    from defensegan_torch.defense.fastgen import _s2d, _s2d_inv
    bf, cl = torch.bfloat16, torch.channels_last
    n, g0, c0, fg = z0.shape[0], pack.base_hw, pack.c0, pack.final_g
    convs = []
    for lv in pack.levels:
        w = lv.w.reshape(3, 3, lv.ci, lv.co).permute(3, 2, 0, 1)   # OIHW
        convs.append((w.contiguous(memory_format=cl),
                      w.flip(2, 3).transpose(0, 1).contiguous(
                          memory_format=cl), lv.b.reshape(1, -1, 1, 1)))

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    b1 = pack.b1.reshape(1, -1)
    x = nchw(x_flat.float().reshape(n, fg, fg, pack.out_lanes))
    scale = 2.0 / pack.out_dim
    z = z0.clone()
    v = torch.zeros_like(z)
    for _ in range(rec_iters):
        h0 = torch.relu(torch.matmul(z.to(bf), pack.w1).float() + b1)
        acts = [nchw(h0.reshape(n, g0, g0, c0))]
        h = acts[0].to(bf)
        for lv, (w, _, b) in zip(pack.levels, convs):
            a = F.conv2d(h, w, padding=1).float() + b
            acts.append(torch.relu(a) if lv.relu else a)
            h = acts[-1].to(bf)
            if lv.interleave_after is not None:
                h = nchw(_s2d_inv(nhwc(h), 2, lv.interleave_after))
        t = torch.tanh(acts[-1])
        d = ((t - x) * (1.0 - t * t) * scale).to(bf)
        for i in range(len(pack.levels) - 1, -1, -1):
            lv = pack.levels[i]
            if lv.interleave_after is not None:
                d = nchw(_s2d(nhwc(d), 2))
            if lv.relu:
                d = torch.where(acts[i + 1] > 0, d, 0.0)
            d = F.conv2d(d, convs[i][1], padding=1)
        dh0 = nhwc(torch.where(acts[0] > 0, d, 0.0)).reshape(n, -1)
        v = momentum * v + torch.matmul(dh0, pack.w1t).float()
        z = z - rec_lr * v
    return z


def bounds(name: str, pack, n: int, iters: int) -> dict:
    """Least time for the loop at this shape: max(bytes / HBM rate,
    operations / peak rate per type). Inputs read once (weights, x, z0),
    output z written once. Counted at the function's true output width
    (784), not the kernel's padded P."""
    base = pack if name == "fused_projection_v2" else pack.base
    k, f = base.w1.shape
    p = base.out_dim
    z_bytes = 2 * n * k * 4 + n * p * 2          # z0 + z_final, bf16 x
    if name == "fused_projection_v2":
        w_bytes = 2 * k * f * 2 + 2 * f * p * 2 + (f + p) * 4
        t_ops = n * iters * 4 * (k * f + f * p) / PEAK_BF16
    else:
        w_bytes = 2 * k * f * 2 + 2 * f * p + 2 * (f + p) * 4 + f * 4
        t_ops = (n * iters * 4 * k * f / PEAK_BF16
                 + n * iters * 4 * f * p / PEAK_INT8)
    t_bytes = (w_bytes + z_bytes) / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def deconv_macs(h: int, cin: int, cout: int, k: int = 5, s: int = 2) -> int:
    """Multiply-adds of one SAME stride-s k x k transpose conv on an h x h
    input that land inside its (s*h) x (s*h) output: input pixel i and tap
    m meet output lo + s*i - m, kept when it is in range."""
    from defensegan_torch.models.layers import conv_transpose_pads
    lo, _ = conv_transpose_pads(k, s)
    per_axis = sum(1 for i in range(h) for m in range(k)
                   if 0 <= lo + s * i - m < s * h)
    return per_axis * per_axis * cin * cout


def bounds_v3(generator, pack, n: int, iters: int) -> dict:
    """As `bounds`, for the deep loop. The operations are the FUNCTION's
    own -- fc, deconv_0 and deconv_out as 5x5 stride-2 transpose convs,
    forward and input gradient -- not the dense s2d form's, whose zero
    taps and padding the kernel computes on top (kernel_mflop: the tap
    products the kernel really computes, skipped border taps left out)."""
    k, hw = generator.latent_dim, generator.base_hw
    c0, c1 = generator.channels
    macs = (k * hw * hw * c0 + deconv_macs(hw, c0, c1)
            + deconv_macs(2 * hw, c1, generator.out_channels))
    t_ops = n * iters * 4 * macs / PEAK_BF16
    out_dim = hw * hw * pack.cb
    w_bytes = sum(t.numel() * t.element_size() for t in pack
                  if hasattr(t, "numel"))
    t_bytes = (w_bytes + 2 * n * k * 4 + n * out_dim * 2) / PEAK_BYTES
    p2, taps = hw * hw, int(pack.masks.sum().item())
    nine_cb = 9 * pack.cb
    dense = 4 * (k * p2 * c0 + p2 * 9 * pack.c0 * pack.ca
                 + p2 * pack.ca * nine_cb)
    # conv B as the GEMM issues it: its forward N (9*cb) in whole 128-column
    # tiles, its backward K (9*cb padded to 32) in whole 64-deep slabs
    computed = (4 * k * p2 * c0 + 4 * taps * pack.c0 * pack.ca
              + 2 * p2 * pack.ca * (-(-nine_cb // 128) * 128)
              + 2 * p2 * pack.ca * (-(-(-(-nine_cb // 32) * 32) // 64) * 64))
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "function_mflop": 4 * macs / 1e6, "s2d_dense_mflop": dense / 1e6,
            "kernel_mflop": computed / 1e6}


def bounds_v4(generator, pack, n: int, iters: int) -> dict:
    """As `bounds_v3`, for the multi-level loop: the operations are the
    function's own (fc and every 5x5 stride-2 transpose conv, forward and
    input gradient, only the multiply-adds that land inside the output);
    the dense grid-conv form counts the zero taps of the space-to-depth
    kernels on top, and the kernel issues that form less the skipped
    border taps plus its padding (kernel_mflop)."""
    from defensegan_torch.kernels.fused_projection_v3 import _tap_masks
    from defensegan_torch.kernels.fused_projection_v4 import padded_v4
    k, hw = generator.latent_dim, generator.base_hw
    chans = list(generator.channels) + [generator.out_channels]
    macs = k * hw * hw * chans[0]
    for i in range(len(chans) - 1):
        macs += deconv_macs(hw << i, chans[i], chans[i + 1])
    t_ops = n * iters * 4 * macs / PEAK_BF16
    tensors = [pack.w1, pack.w1t, pack.b1] + [
        t for lv in pack.levels for t in (lv.w, lv.wt, lv.b)]
    w_bytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = (w_bytes + 2 * n * k * 4 + n * pack.out_dim * 2) / PEAK_BYTES
    fc = k * hw * hw * chans[0]
    dense = 4 * (fc + sum(lv.g ** 2 * 9 * lv.ci * lv.co
                          for lv in pack.levels))
    pp = padded_v4(pack)
    computed = 4 * (pp.z_dim * hw * hw * pp.c0 + sum(
        int(_tap_masks(lv.g).sum()) * lv.ci * lv.co for lv in pp.levels))
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "function_mflop": 4 * macs / 1e6, "s2d_dense_mflop": dense / 1e6,
            "kernel_mflop": computed / 1e6, "weight_mbytes": w_bytes / 1e6}


def seeded_gan(cfg_path: str, running_stats: bool = False):
    """A model on cuda with seeded weights, as this smoke serves the ones
    that have no trained checkpoint in the repository: seeded init with
    every BatchNorm's scale, bias, running mean and variance drawn from a
    seeded generator, so that the BN fold is not the identity.

    running_stats=True centres each BatchNorm's mean and variance draws on
    the statistics of the activations it normalises (over 256 seeded
    latents, layer by layer), as the running averages of a trained network
    are. A stride-2 5x5 transpose conv meets only a quarter of its taps per
    output, so under the plain init each level shrinks its activations: a
    four-deconv stack with unit variances then generates nearly constant
    images whose projection gradient is close to zero. With running
    statistics the seeded generator has contrast and about half of every
    relu mask set, which is what the loop has to get right.
    """
    import torch
    from defensegan_torch.configs import load_config
    from defensegan_torch.gan import DefenseGAN
    cfg = load_config(cfg_path)
    gan = DefenseGAN(cfg)
    gb = torch.Generator(device=gan.device).manual_seed(cfg.seed + 7)
    z = torch.randn(256, cfg.latent_dim, device=gan.device, generator=gb) \
        if running_stats else None
    for name, bn in gan.generator.named_children():
        if not name.startswith("bn_"):
            continue

        def draw(scale, kind=torch.randn):
            return scale * kind(bn.scale.shape, device=gan.device,
                                generator=gb)
        bn.scale.copy_(1.0 + draw(0.3))
        bn.bias.copy_(draw(0.2))
        bn.mean.copy_(draw(0.2))
        bn.var.copy_(0.5 + draw(1.0, torch.rand))
        if running_stats:
            seen = []
            hook = bn.register_forward_pre_hook(
                lambda mod, args: seen.append(args[0].float()))
            with torch.no_grad():
                gan.generator(z)
            hook.remove()
            var, mean = torch.var_mean(seen[0], dim=(0, 2, 3))
            bn.mean.copy_(mean + bn.mean * var.sqrt())
            bn.var.copy_(bn.var * var)
    return gan


def seeded_deep_gan():
    """The deep mnist.yml model (bn_in, bn_0), seeded."""
    return seeded_gan(DEEP_CFG)


def seeded_celeba_gan(name: str = "celeba"):
    """A 64x64 model, seeded: celeba (fc -> 4x4x512, four deconvs),
    celeba_wide (fc -> 8x8x256, three) or imagenet64 (k 256, widths of
    96)."""
    return seeded_gan(os.path.join(CFG_DIR, name + ".yml"),
                      running_stats=True)


def row_errors(got, ref, z0) -> dict:
    """Error of z_final against a reference, relative to the step taken:
    over the whole batch (max |err| / max |step|) and row by row."""
    import torch
    err = (got - ref).abs().amax(1)
    step = (ref - z0).abs().amax(1)
    rel = (err / step).float().cpu()
    return {"max_abs_err": err.max().item(), "moved": step.max().item(),
            "rel": (err.max() / step.max()).item(),
            "row_rel_p50": torch.quantile(rel, 0.5).item(),
            "row_rel_max": rel.max().item()}


def whitebox_phase(build) -> dict:
    """Phase 6: the white-box evaluation path on the trained flagship.

    Gradients through the projection on the card, the white-box CLI end to
    end (FGSM, PGD and SPSA through the defense; the defended evaluation,
    the detector and SPSA's queries on v2), and the --load_adv replay gate
    of the committed adversarial sets through v2 and v2i. Launch counters
    are set to 0 just before and read just after; v2 and v2i must have
    run."""
    import numpy as np
    import torch

    import whitebox_torch
    from defensegan_torch.attacks import make_attack_target
    from defensegan_torch.configs import load_config
    from defensegan_torch.eval.detect import roc_auc
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.models import build_classifier

    dev = torch.device("cuda")
    out = {}
    cfg = load_config(RUN_DIR).replace(output_dir=RUN_DIR)
    cfg32 = cfg.replace(compute_dtype="float32")
    with np.load(ADVSET) as d:
        x_set = d["x_clean"]
    clf_cpu = build_classifier("A", gen=torch.Generator().manual_seed(5)) \
        .requires_grad_(False)
    clf_dev = build_classifier("A", gen=torch.Generator().manual_seed(5)) \
        .to(dev).requires_grad_(False)
    z0 = torch.randn(16, cfg.rec_rr, cfg.latent_dim,
                     generator=torch.Generator().manual_seed(6))

    def exact_grad(gan, clf, x, z0, iters, grad_mode="exact"):
        tgt = make_attack_target(gan, clf, gan.cfg, rec_iters=iters,
                                 grad_mode=grad_mode,
                                 z0_fn=lambda xx, key: z0.to(xx.device))
        xx = x.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(tgt(xx, 0).sum(), xx)
        return g

    # ---- 6a. the exact gradient on the card against the CPU, float32
    x16 = torch.from_numpy(x_set[:16])
    g_cpu = exact_grad(DefenseGAN(cfg32, device="cpu").load(), clf_cpu,
                       x16, z0, 5)
    gan32 = DefenseGAN(cfg32).load()
    g_dev = exact_grad(gan32, clf_dev, x16.to(dev), z0, 5).cpu()
    scale = float(g_cpu.abs().max())
    err = float((g_dev - g_cpu).abs().max())
    gan = DefenseGAN(cfg).load()                 # the served bf16 model
    g_bf = exact_grad(gan, clf_dev, x16.to(dev), z0, 5).cpu()
    cos = float(torch.nn.functional.cosine_similarity(
        g_bf.flatten(), g_cpu.flatten(), dim=0))
    # BPDA: identity through the projection, so d/dx sum logits is the
    # classifier's gradient at u = x + (G(z*) - x)
    xd = x16.to(dev)
    g_bpda = exact_grad(gan32, clf_dev, xd, z0, 5, "bpda")
    with torch.no_grad():
        res = gan32.reconstruct(xd, kernel="xla", rec_iters=5,
                                z0=z0.to(dev))
    u = (xd + (res.x_hat - xd)).requires_grad_(True)
    (g_u,) = torch.autograd.grad(clf_dev(u).sum(), u)
    bpda_err = float((g_bpda - g_u).abs().max())
    bpda_scale = float(g_u.abs().max())
    out["grad"] = dict(
        images=16, rr=cfg.rec_rr, iters=5, max_abs_err=err,
        cpu_max_abs=scale, rel=err / scale, bound_rel=GRAD_REL_MAX,
        bf16_card_cos_vs_fp32_cpu=cos, bpda_max_abs_err=bpda_err,
        bpda_rel=bpda_err / bpda_scale, bpda_bound_rel=BPDA_REL_MAX)
    if not (err <= GRAD_REL_MAX * scale and scale > 0
            and bpda_err <= BPDA_REL_MAX * bpda_scale
            and torch.isfinite(g_bf).all()):
        fail(f"white-box gradients: {out['grad']}")

    # ---- 6b. one exact-mode gradient at L 200 on 64 images (bf16 model)
    x64 = torch.from_numpy(x_set[:64]).to(dev)
    z64 = torch.randn(64, cfg.rec_rr, cfg.latent_dim,
                      generator=torch.Generator().manual_seed(7))
    timing = {}
    for iters in (50, 200):
        exact_grad(gan, clf_dev, x64, z64, iters)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        g64 = exact_grad(gan, clf_dev, x64, z64, iters)
        torch.cuda.synchronize()
        timing[f"L{iters}"] = dict(
            s=time.perf_counter() - t0,
            peak_extra_mib=(torch.cuda.max_memory_allocated() - base)
            / 2 ** 20, finite=bool(torch.isfinite(g64).all()))
    out["exact_grad_64_images"] = dict(rr=cfg.rec_rr, **timing)
    if not all(t["finite"] for t in timing.values()):
        fail(f"exact gradient at L 200: {timing}")
    emit("whitebox_grad", **out)

    # ---- 6c. the CLI end to end, then the replay gate
    res_dir = os.path.join(ROOT, "chiprun_out", "whitebox_torch")
    base_args = ["--cfg", os.path.join(CFG_DIR, "mnist_fast.yml"),
                 "--output_dir", RUN_DIR, "--model", "A",
                 "--classifier_epochs", "1", "--rec_rr", "10",
                 "--rec_iters", "200", "--defense_type", "defense_gan",
                 "--results_dir", res_dir]
    build.reset_launches()
    runs = {}

    def cli(label, extra, num_tests=256, path="pallas"):
        t0 = time.perf_counter()
        rec = whitebox_torch.main(base_args + ["--num_tests",
                                               str(num_tests)] + extra)
        torch.cuda.synchronize()
        runs[label] = dict(
            s=time.perf_counter() - t0, num_tests=rec["num_tests"],
            attack_batches=rec["attack_batches"],
            s_per_attack_batch=(rec["attack_time_s"]
                                / max(rec["attack_batches"], 1)),
            last_kernel=rec["last_kernel"],
            clean_acc=rec["clean_acc"],
            clean_defended_acc=rec["clean_defended_acc"],
            adv_acc_no_defense=rec["adv_acc_no_defense"],
            defended_acc=rec["defended_acc"],
            detection_auc=rec["detection_auc"], phases=rec["phases"])
        if set(rec["last_kernel"].values()) != {path}:
            fail(f"{label}: the defended evaluation ran "
                 f"{rec['last_kernel']}, not {path}")
        return rec

    cli("fgsm_bpda", ["--attack_type", "fgsm", "--attack_grad", "bpda",
                      "--retrain_classifier"])
    cli("fgsm_exact", ["--attack_type", "fgsm"], num_tests=64)
    cli("pgd_bpda", ["--attack_type", "pgd", "--pgd_iters", "10",
                     "--attack_grad", "bpda"])
    cli("spsa", ["--attack_type", "spsa", "--spsa_iters", "2", "--detect"])
    replay = {}
    for label, advset, detstats, kernel in (
            ("conf_v2", ADVSET, DETSTATS, "pallas"),
            ("conf_v2i", ADVSET, DETSTATS, "pallas_int8"),
            ("spsa_v2", ADVSET_SPSA, DETSTATS_SPSA, "pallas")):
        npz = os.path.join(res_dir, f"replay_{label}.npz")
        cli(f"replay_{label}", ["--attack_type", "none", "--load_adv",
                                advset, "--detect", "--detect_save", npz,
                                "--override", f"PROJECTION_KERNEL={kernel}"],
            num_tests=128, path=kernel)
        with np.load(npz) as got, np.load(detstats) as ref:
            med = {k: (float(np.median(got[k])), float(np.median(ref[k])))
                   for k in ("errs_clean", "errs_adv")}
            auc = (roc_auc(got["errs_clean"], got["errs_adv"]),
                   roc_auc(ref["errs_clean"], ref["errs_adv"]))
        replay[label] = dict(
            median_errs_clean=med["errs_clean"],
            median_errs_adv=med["errs_adv"], auc=auc,
            median_rel_gap={k: abs(a - b) / b for k, (a, b) in med.items()},
            auc_abs_gap=abs(auc[0] - auc[1]))
        if label.startswith("conf") and (
                max(replay[label]["median_rel_gap"].values())
                > REPLAY_MEDIAN_REL_MAX
                or replay[label]["auc_abs_gap"] > REPLAY_AUC_ABS_MAX):
            fail(f"replay gate {label}: {replay[label]}")
    launches = dict(build.LAUNCHES)
    emit("whitebox", runs=runs, replay=replay, launches=launches,
         replay_bounds=dict(median_rel=REPLAY_MEDIAN_REL_MAX,
                            auc_abs=REPLAY_AUC_ABS_MAX),
         note="accuracies are path checks: the classifier trains one "
         "epoch on the synthetic stand-in data (no MNIST files in the "
         "repository), not on MNIST")
    if launches["fused_projection_v2"] <= 0 or \
            launches["fused_projection_v2i"] <= 0:
        fail(f"the white-box path did not run v2 and v2i: {launches}")
    out.update(runs=runs, replay=replay, launches=launches)
    return out


def jax_curve(max_step: int) -> list:
    """The committed JAX training curve's last run (the file holds every
    run appended), up to max_step."""
    runs, prev = [[]], -1
    with open(JAX_CURVE) as f:
        for line in f:
            r = json.loads(line)
            if r["step"] <= prev:
                runs.append([])
            runs[-1].append(r)
            prev = r["step"]
    return [r for r in runs[-1] if r["step"] <= max_step]


def _grad_errors(cpu: dict, dev: dict) -> dict:
    """Per tensor max |card - CPU| over the CPU gradient's largest element
    (its median and worst over the tensors), and the exact-zero tensors
    against their module's largest gradient."""
    import statistics
    scale = {mod: max(float(t.abs().max()) for n, t in cpu.items()
                      if n.startswith(mod)) for mod in ("generator", "critic")}
    rel, zero = {}, {}
    for n, gc in cpu.items():
        gd = dev[n]
        if (n.startswith("generator.deconv_") and n.endswith(".bias")
                and not n.startswith("generator.deconv_out")) \
                or float(gc.abs().max()) == 0.0:
            zero[n] = max(float(gc.abs().max()), float(gd.abs().max())) \
                / scale[n.split(".")[0]]
        else:
            rel[n] = float((gd - gc).abs().max() / gc.abs().max())
    worst = max(rel, key=rel.get)
    return dict(median_rel=statistics.median(rel.values()),
                worst_rel=rel[worst], worst=worst,
                exact_zero_rel_max=max(zero.values(), default=0.0))


def _loss_error(cpu: dict, dev: dict) -> float:
    # wasserstein = d_real - d_fake cancels: its terms are held instead
    return max(abs(dev[n] - v) / max(abs(v), 1e-2)
               for n, v in cpu.items() if n != "wasserstein")


def train_step_pair(cfg_path: str, seed: int) -> dict:
    """7a: the config's model at full width on the card and on the CPU
    (float32, same seeded weights, batch and draws): the losses and
    gradients of a critic and a generator update at the same weights, then
    one full train step's losses and running statistics."""
    import torch
    from defensegan_torch.configs import load_config
    from defensegan_torch.data.synthetic import make_synthetic
    from defensegan_torch.gan.losses import critic_loss_fn, \
        generator_loss_fn
    from defensegan_torch.gan.train import (Draws, init_gan_state,
                                            make_train_step)
    from defensegan_torch.models import (critic_for, from_image_space,
                                         generator_for)
    from defensegan_torch.models.layers import BatchNorm, Conv

    cfg = load_config(cfg_path)
    di, b, k = cfg.disc_iters, cfg.batch_size, cfg.latent_dim
    x, _ = make_synthetic(di * b, cfg.image_size, cfg.channels,
                          cfg.num_classes, seed=seed)
    real = torch.from_numpy(x).reshape((di, b) + cfg.image_shape)
    g = torch.Generator().manual_seed(seed)
    draws = Draws(torch.randn(di, b, k, generator=g),
                  torch.rand(di, b, generator=g), torch.randn(b, k,
                                                              generator=g))
    side = {}
    for dev in ("cpu", "cuda"):
        gen = generator_for(cfg.type, cfg.gen_dim, torch.float32,
                            cfg.gen_arch, k,
                            gen=torch.Generator().manual_seed(seed)).to(dev)
        crit = critic_for(cfg.type, cfg.disc_dim, torch.float32,
                          gen=torch.Generator().manual_seed(seed + 1)).to(dev)
        state = init_gan_state(gen, crit, gen_lr=cfg.gen_learning_rate,
                               disc_lr=cfg.disc_learning_rate,
                               beta1=cfg.beta1, beta2=cfg.beta2)
        r, d = real.to(dev), Draws(*(t.to(dev) for t in draws[:3]))
        # the same weights: a critic and a generator update's losses and
        # gradients, with every (leaky) ReLU's pre-activation kept
        pre = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: pre.append(out.detach().cpu()))
            for m in list(crit.children()) + list(gen.children())
            if isinstance(m, (Conv, BatchNorm))]
        with torch.no_grad():
            fake = gen(d.z_critic[0], train=True)
        d_loss, aux = critic_loss_fn(crit, from_image_space(r[0]), fake,
                                     d.eps[0], gp_lambda=cfg.gp_lambda)
        cgrads = torch.autograd.grad(d_loss, list(crit.parameters()))
        g_loss = generator_loss_fn(crit, gen(d.z_gen, train=True))
        ggrads = torch.autograd.grad(g_loss, list(gen.parameters()))
        for h in hooks:
            h.remove()
        same = dict(losses=dict({n: float(v.detach())
                                 for n, v in aux.items()},
                                d_loss=float(d_loss.detach()),
                                g_loss=float(g_loss.detach())),
                    grads={}, pre=pre)
        for mod, module, grads in (("critic", crit, cgrads),
                                   ("generator", gen, ggrads)):
            for (n, _), gr in zip(module.named_parameters(), grads):
                same["grads"][f"{mod}.{n}"] = gr.detach().cpu()
        # the full step
        m = make_train_step(state, latent_dim=k, disc_iters=di,
                            gp_lambda=cfg.gp_lambda)(r, None, d)
        side[dev] = dict(
            same=same, metrics={n: float(v) for n, v in m.items()},
            grads={f"{mod}.{n}": p.grad.detach().cpu()
                   for mod, module in (("generator", gen), ("critic", crit))
                   for n, p in module.named_parameters()},
            stats={n: t.detach().cpu() for n, t in gen.named_buffers()})
    cpu, dev = side["cpu"], side["cuda"]
    same_grads = _grad_errors(cpu["same"]["grads"], dev["same"]["grads"])
    flips = sum(int(((a > 0) != (b > 0)).sum())
                for a, b in zip(cpu["same"]["pre"], dev["same"]["pre"]))
    out = dict(config=os.path.basename(cfg_path), batch=b, disc_iters=di,
               same_weights=dict(
                   losses_cpu=cpu["same"]["losses"],
                   losses_card=dev["same"]["losses"],
                   loss_rel_max=_loss_error(cpu["same"]["losses"],
                                            dev["same"]["losses"]),
                   sign_flips=flips,
                   pre_activations=sum(a.numel()
                                       for a in cpu["same"]["pre"]),
                   grads=same_grads),
               step=dict(
                   metrics_cpu=cpu["metrics"], metrics_card=dev["metrics"],
                   loss_rel_max=_loss_error(cpu["metrics"], dev["metrics"]),
                   stats_rel_max=max(
                       float((dev["stats"][n] - t).abs().max()
                             / t.abs().max())
                       for n, t in cpu["stats"].items()),
                   grads_after_adam=_grad_errors(cpu["grads"],
                                                 dev["grads"])))
    sw, st = out["same_weights"], out["step"]
    sw["grad_bound"] = TRAIN_GRAD_FLIP_REL_MAX if flips else \
        TRAIN_GRAD_REL_MAX
    if not (sw["loss_rel_max"] <= TRAIN_SAME_LOSS_REL_MAX
            and same_grads["worst_rel"] <= sw["grad_bound"]
            and same_grads["exact_zero_rel_max"] <= TRAIN_ZERO_GRAD_REL_MAX
            and st["loss_rel_max"] <= TRAIN_LOSS_REL_MAX
            and st["stats_rel_max"] <= TRAIN_STATS_REL_MAX):
        fail(f"train step on the card against the CPU: {out}")
    return out


def steps_per_s(cfg_path: str, steps: int = 20) -> float:
    """Generator steps/s of the config's model at full width in its own
    compute dtype on the card (seeded weights, the synthetic stand-in's
    images resident on the card), after 3 warm-up steps."""
    import torch
    from defensegan_torch.configs import load_config
    from defensegan_torch.data.synthetic import make_synthetic
    from defensegan_torch.gan.defense_gan import _dtype_of
    from defensegan_torch.gan.train import init_gan_state, \
        make_data_train_step
    from defensegan_torch.models import critic_for, generator_for

    cfg = load_config(cfg_path)
    dt = _dtype_of(cfg.compute_dtype)
    init = torch.Generator().manual_seed(cfg.seed)
    state = init_gan_state(
        generator_for(cfg.type, cfg.gen_dim, dt, cfg.gen_arch,
                      cfg.latent_dim, gen=init).cuda(),
        critic_for(cfg.type, cfg.disc_dim, dt, gen=init).cuda())
    x, _ = make_synthetic(1024, cfg.image_size, cfg.channels,
                          cfg.num_classes)
    data = torch.from_numpy(x).cuda()
    step = make_data_train_step(state, latent_dim=cfg.latent_dim,
                                batch_size=cfg.batch_size,
                                disc_iters=cfg.disc_iters,
                                gp_lambda=cfg.gp_lambda)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(3):
        step(data, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(data, gen)
    float(m["g_loss"])
    return steps / (time.perf_counter() - t0)


def training_phase(build, tmp: str) -> dict:
    """Phase 7: WGAN-GP and encoder training on the card (train_torch.py).

    7a one full step per model family against the CPU; 7b training from
    the seeded init against the committed JAX curve, then test mode on
    the export (v2 at R 10, L 200); 7c the encoder against a temporary
    copy of the committed flagship. Launch counters are set to 0 before
    7b and read after its test mode: v2 must have run."""
    import shutil
    import statistics as stats

    import numpy as np
    import torch

    import train_torch
    from defensegan_torch.configs import load_config
    from defensegan_torch.data import get_dataset
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.utils.misc import fold_seed, generator_for

    t_phase = time.perf_counter()
    out = {"step_card_vs_cpu": {}, "steps_per_s_full_width": {}}
    for name, seed in (("mnist_fast", 21), ("mnist", 22), ("celeba", 23)):
        path = os.path.join(CFG_DIR, name + ".yml")
        out["step_card_vs_cpu"][name] = train_step_pair(path, seed)
        print(json.dumps({"train_step_pair": out["step_card_vs_cpu"][name]}),
              flush=True)
        out["steps_per_s_full_width"][name] = steps_per_s(path)
    out["bounds_7a"] = dict(same_loss_rel=TRAIN_SAME_LOSS_REL_MAX,
                            grad_rel=TRAIN_GRAD_REL_MAX,
                            grad_rel_with_flips=TRAIN_GRAD_FLIP_REL_MAX,
                            exact_zero_grad_rel=TRAIN_ZERO_GRAD_REL_MAX,
                            step_loss_rel=TRAIN_LOSS_REL_MAX,
                            stats_rel=TRAIN_STATS_REL_MAX)
    emit("train_step", **out)

    # ---- 7b. train from the seeded init, then test mode on the export
    build.reset_launches()
    run = os.path.join(tmp, "mnist_fast")
    fast_yml = os.path.join(CFG_DIR, "mnist_fast.yml")
    t0 = time.perf_counter()
    res = train_torch.main(["--cfg", fast_yml, "--is_train", "--output_dir",
                            run, "--train_iters", str(TRAIN_STEPS),
                            "--override", f"SAVE_EVERY={TRAIN_STEPS}",
                            "--override", f"SAMPLE_EVERY={TRAIN_STEPS}"])
    train_s = time.perf_counter() - t0
    with open(os.path.join(run, "metrics.jsonl")) as f:
        ours = [json.loads(line) for line in f]
    ref = jax_curve(TRAIN_STEPS)
    curve = {}
    for key in ("wasserstein", "gp"):
        vals = [r[key] for r in ref]
        q1, _, q3 = stats.quantiles(vals, n=4, method="inclusive")
        curve[key] = dict(port_median=stats.median(r[key] for r in ours),
                          jax_median=stats.median(vals), band=q3 - q1)
        curve[key]["gap"] = abs(curve[key]["port_median"]
                                - curve[key]["jax_median"])
    print(json.dumps({"train_curve": dict(
        steps=TRAIN_STEPS, s=train_s,
        train_steps_per_s=res["train_steps_per_s"], curve=curve)}),
        flush=True)
    if [r["step"] for r in ours] != [r["step"] for r in ref] or any(
            c["gap"] > c["band"] for c in curve.values()):
        fail(f"training curve against the JAX curve: {curve}")
    t0 = time.perf_counter()
    test = train_torch.main(["--cfg", run, "--output_dir", run,
                             "--num_recs", "64"])
    test_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)      # the training path's, test mode's
    x_test, _ = get_dataset("mnist").load("test")
    committed = DefenseGAN(load_config(RUN_DIR).replace(
        output_dir=RUN_DIR)).load()
    ref_res = committed.reconstruct(
        x_test[:64], generator_for(fold_seed(committed.cfg.seed, 100),
                                   "cuda"))
    out_b = dict(steps=TRAIN_STEPS, s=train_s,
                 train_steps_per_s=res["train_steps_per_s"],
                 last_metrics={k: v for k, v in res.items()
                               if k != "train_steps_per_s"},
                 curve=curve, logged_steps=len(ours), test_mode_s=test_s,
                 test_mode_kernel=test["last_kernel"],
                 test_rec_loss_mean=float(np.mean(test["rec_loss"])),
                 committed_step20000_rec_loss_mean=float(
                     ref_res.loss.float().mean()),
                 committed_kernel=committed.last_kernel)
    if test["last_kernel"] != "pallas" or test["step"] != TRAIN_STEPS or \
            not np.isfinite(test["rec_loss"]).all():
        fail(f"test mode on the trained export: {out_b}")

    # ---- 7c. the encoder against a copy of the committed flagship
    copy = os.path.join(tmp, "flagship_copy")
    os.makedirs(os.path.join(copy, "export"))
    shutil.copy(os.path.join(RUN_DIR, "cfg.yml"), copy)
    for ext in ("npz", "json"):
        shutil.copy(os.path.join(RUN_DIR, "export", f"20000.{ext}"),
                    os.path.join(copy, "export"))
    iters = 300
    enc = train_torch.main(["--cfg", copy, "--output_dir", copy,
                            "--train_encoder", "--override",
                            f"ENCODER_TRAIN_ITERS={iters}"])["encoder"]
    hist = enc["history"]
    back = DefenseGAN(load_config(copy).replace(output_dir=copy)).load()
    keys = ("step", "img_mse", "z_cycle", "loss")
    out_c = dict(iters=iters, batch=back.cfg.encoder_batch,
                 first={k: hist[0][k] for k in keys},
                 last={k: hist[-1][k] for k in keys},
                 s_per_step=enc["wall_s"] / iters,
                 reloaded_step=back.step)
    # the objective (img_mse + beta_z z_cycle) falls; img_mse alone
    # wanders at this batch (0.0465 -> 0.0470 in this PR's first run)
    if not (back.has_encoder() and back.step == 20000
            and hist[-1]["loss"] < hist[0]["loss"]
            and np.isfinite(hist[-1]["loss"])):
        fail(f"encoder training: {out_c}")
    torch.cuda.synchronize()
    emit("train", train=out_b, encoder=out_c, launches=launches,
         phase_s=time.perf_counter() - t_phase,
         note="the synthetic stand-in data (no MNIST files in the "
         "repository), as the committed JAX run; the two rec losses are a "
         "path check, not a gate")
    if launches["fused_projection_v2"] <= 0:
        fail(f"test mode did not run v2: {launches}")
    out.update(train=out_b, encoder=out_c, launches=launches)
    return out


def blackbox_phase(build, tmp: str) -> dict:
    """Phase 8: the black-box path (blackbox_torch.py) on the committed
    flagship: jacobian_augmentation on the card against the CPU, then the
    CLI end to end with the defended evaluation and --detect on v2 at
    R 10, L 200. Launch counters are set to 0 just before the CLI and read
    just after: v2 must have run."""
    import numpy as np
    import torch

    import blackbox_torch
    from defensegan_torch.attacks import jacobian_augmentation
    from defensegan_torch.data import get_dataset
    from defensegan_torch.eval.classifier import make_logits_fn
    from defensegan_torch.models import build_classifier

    t_phase = time.perf_counter()
    x_test, _ = get_dataset("mnist").load("test")
    x = torch.from_numpy(x_test[:150])
    labels = torch.from_numpy(
        np.random.RandomState(8).randint(0, 10, 150))
    sides = {}
    for dev in ("cpu", "cuda"):
        sub = build_classifier("B", gen=torch.Generator().manual_seed(9)) \
            .to(dev).requires_grad_(False)
        xg = x.to(dev).requires_grad_(True)
        (g,) = torch.autograd.grad(torch.gather(
            sub(xg), 1, labels.to(dev)[:, None]).sum(), xg)
        sides[dev] = (jacobian_augmentation(make_logits_fn(sub), x.to(dev),
                                            labels.to(dev), 0.1).cpu(),
                      g.cpu())
    (a_cpu, g_cpu), (a_dev, _) = sides["cpu"], sides["cuda"]
    firm = g_cpu.abs() > JACOBIAN_NOISE_REL * g_cpu.abs().max()
    differ = (a_dev - a_cpu).abs() > 1e-6
    jac = dict(images=150, elements=int(differ.numel()),
               differ=int(differ.sum()),
               differ_share=float(differ.float().mean()),
               differ_where_firm=int((differ & firm).sum()),
               bounds=dict(noise_rel=JACOBIAN_NOISE_REL,
                           share=JACOBIAN_FLIP_SHARE_MAX))
    if jac["differ_where_firm"] or jac["differ_share"] > \
            JACOBIAN_FLIP_SHARE_MAX:
        fail(f"jacobian_augmentation on the card against the CPU: {jac}")

    build.reset_launches()
    t0 = time.perf_counter()
    rec = blackbox_torch.main([
        "--cfg", os.path.join(CFG_DIR, "mnist_fast.yml"), "--output_dir",
        RUN_DIR, "--bb_model", "A", "--sub_model", "B", "--data_aug", "6",
        "--num_tests", "256", "--classifier_epochs", "1", "--detect",
        "--rec_rr", "10", "--rec_iters", "200", "--results_dir",
        os.path.join(tmp, "results")])
    cli_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    missing = [k for k in BLACKBOX_KEYS if k not in rec]
    out = dict(jacobian=jac, cli_s=cli_s, phases=rec["phases"],
               last_kernel=rec["last_kernel"], missing_keys=missing,
               num_tests=rec["num_tests"],
               accuracies={k: rec[k] for k in (
                   "clean_acc", "sub_agreement", "clean_defended_acc",
                   "adv_acc_no_defense", "defended_acc", "detection_auc")},
               launches=launches, phase_s=time.perf_counter() - t_phase,
               note="path checks, not the paper's numbers: the synthetic "
               "stand-in data, classifiers of one epoch")
    emit("blackbox", **out)
    if missing or set(rec["last_kernel"].values()) != {"pallas"} or \
            set(rec["last_kernel"]) != {"purify_classify_clean",
                                        "purify_classify_adv", "detect"}:
        fail(f"black-box CLI: {out}")
    if launches["fused_projection_v2"] <= 0:
        fail(f"the black-box path did not run v2: {launches}")
    return out


# (9) several devices. 9a holds ShardedDefenseGAN bit for bit against the
# single-device calls on each shard with the folded seeds: one replica of
# the weights packs what the bare model packs, and v2 computes each row on
# its own (phase 3a holds 192-row chunks bit for bit against one chunk),
# so a shard equals the same rows served alone. 9b holds the data-parallel
# steps at world 1 bit for bit against the plain step given the same
# draws: an average over one rank is the identity (a sum of one term,
# divided by 1), flattening and unflattening copy, and BatchNorm's
# all-reduced moments are its own. cuDNN is held to its deterministic
# algorithms there, and a second plain step (the control) must equal the
# first: otherwise the comparison would measure cuDNN, not the step.
PARALLEL_IMAGES = 1024
DP_BATCH = 64
DP_TIMED_STEPS = 10
SERVING_BATCHES = ["1", "16", "256", "1024", "4096"]


def sharded_serving_phase(build, gan, n_images: int = PARALLEL_IMAGES
                          ) -> dict:
    """9a: the flagship at full width (n_images x R 10 x L 200 on v2)
    through ShardedDefenseGAN over [cuda:0] and over [cuda:0, cuda:0],
    each against the per-shard single-device calls bit for bit; the
    DefendedPipeline over the sharded GAN; recon/s of the sharded call at
    one shard against the bare call, in turns. Launch counters are set to
    0 just before the sharded calls and read just after them."""
    import torch
    from defensegan_torch.defense.pipeline import DefendedPipeline
    from defensegan_torch.models import build_classifier
    from defensegan_torch.parallel import ShardedDefenseGAN, make_mesh
    from defensegan_torch.parallel.serving import base_seed
    from defensegan_torch.utils.misc import fold_seed, generator_for

    dev, cfg, v2 = gan.device, gan.cfg, "fused_projection_v2"
    x = gan.generate(generator_for(9001, dev), n_images)
    meshes = {"one_shard": make_mesh(1),
              "two_shards_one_card": make_mesh(devices=["cuda:0"] * 2)}
    sharded = {k: ShardedDefenseGAN(gan, m) for k, m in meshes.items()}
    out = {"images": n_images, "rr": cfg.rec_rr, "iters": cfg.rec_iters}
    build.reset_launches()
    results = {k: s.reconstruct(x, generator_for(77, dev), kernel="pallas")
               for k, s in sharded.items()}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    seed = base_seed(generator_for(77, dev), cfg)
    for k, mesh in meshes.items():
        b = n_images // len(mesh)
        res, same = results[k], []
        for i, d in enumerate(mesh):
            ref = gan.reconstruct(x[i * b:(i + 1) * b],
                                  generator_for(fold_seed(seed, i), d),
                                  kernel="pallas")
            same.append(all(torch.equal(res[f][i * b:(i + 1) * b], ref[f])
                            for f in range(4)))
        out[k] = dict(shards=len(mesh), bit_equal=all(same),
                      path=sharded[k].last_kernel,
                      replicas=len(sharded[k]._replicas),
                      finite=bool(torch.isfinite(res.x_hat).all()))
    out["launches"] = launches
    # the pipeline over the sharded GAN (two shards on the card)
    clf = build_classifier("E", gen=torch.Generator().manual_seed(0)) \
        .to(dev).requires_grad_(False)
    before = build.LAUNCHES[v2]
    q = n_images // 4
    pipe = DefendedPipeline(sharded["two_shards_one_card"], clf, fpr=0.05)
    p = pipe.calibrate(x[:q]).predict(x[q:2 * q])
    out["pipeline"] = dict(v2_launches=build.LAUNCHES[v2] - before,
                           flag_rate=float(p.flagged.mean()),
                           mean_rec_err=float(p.rec_err.mean()),
                           finite=bool(torch.isfinite(
                               torch.as_tensor(p.rec_err)).all()))

    # recon/s at one shard against the bare call, in turns
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def bare():
        gan.reconstruct(x, generator_for(5, dev), kernel="pallas")

    def one():
        sharded["one_shard"].reconstruct(x, generator_for(5, dev),
                                         kernel="pallas")
    ms = {"bare": [], "sharded": []}
    bare(), one()
    for _ in range(3):
        for name, fn in (("bare", bare), ("sharded", one),
                         ("sharded", one), ("bare", bare)):
            ms[name].append(timed(fn))
    for name, t in ms.items():
        out[f"{name}_ms"] = statistics.median(t)
        out[f"{name}_recon_per_s"] = n_images / (statistics.median(t) / 1e3)
        out[f"{name}_ms_all"] = t
    out["sharded_over_bare"] = out["sharded_ms"] / out["bare_ms"]
    emit("parallel_sharded_serving", **out)
    if not (out["one_shard"]["bit_equal"]
            and out["two_shards_one_card"]["bit_equal"]
            and out["one_shard"]["path"] == "pallas"
            and out["two_shards_one_card"]["path"] == "pallas"
            and out["one_shard"]["finite"] and out["pipeline"]["finite"]
            and out["pipeline"]["v2_launches"] > 0
            and launches[v2] >= 3):
        fail(f"sharded serving: {out}")
    return out


def _state_tensors(state) -> list:
    """Every tensor of a training state: both modules' parameters and
    statistics, both Adam states."""
    import torch
    out = list(state.generator.state_dict().values()) + \
        list(state.critic.state_dict().values())
    for opt in (state.gen_opt, state.disc_opt):
        for s in opt.state_dict()["state"].values():
            out.extend(v for v in s.values() if isinstance(v, torch.Tensor))
    return out


def dp_world1_phase(tmp: str, dev, backend: str = "nccl",
                    batch: int = DP_BATCH) -> dict:
    """9b: a process group of one rank (file:// rendezvous in `tmp`): the
    explicit DP step (make_dp_train_step) and the global-batch step
    (make_data_train_step under the group) on mnist_fast.yml at full width
    in its bf16, B `batch`, each given the same draws as the plain step,
    against it bit for bit (the state after the step: weights, statistics,
    Adam moments; and the metrics); then steps/s of each, synchronized."""
    import torch
    import torch.distributed as dist
    from defensegan_torch.configs import load_config
    from defensegan_torch.gan.train import (draw_step, init_gan_state,
                                            make_data_train_step)
    from defensegan_torch.models import critic_for, generator_for as gfor
    from defensegan_torch.parallel import (initialize_distributed,
                                           make_dp_train_step)
    from defensegan_torch.utils.misc import generator_for

    cfg = load_config(os.path.join(CFG_DIR, "mnist_fast.yml"))
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[cfg.compute_dtype]
    k, di = cfg.latent_dim, cfg.disc_iters

    def fresh():
        g = gfor(cfg.type, cfg.gen_dim, dtype, cfg.gen_arch, k,
                 gen=torch.Generator().manual_seed(cfg.seed))
        c = critic_for(cfg.type, cfg.disc_dim, dtype,
                       gen=torch.Generator().manual_seed(cfg.seed + 1))
        return init_gan_state(g.to(dev), c.to(dev),
                              gen_lr=cfg.gen_learning_rate,
                              disc_lr=cfg.disc_learning_rate,
                              beta1=cfg.beta1, beta2=cfg.beta2)

    data = torch.rand((2048,) + tuple(cfg.image_shape), device=dev,
                      generator=generator_for(3, dev))
    draws = draw_step(generator_for(4, dev), n_data=2048, batch=batch,
                      disc_iters=di, latent_dim=k, device=dev)
    kw = dict(latent_dim=k, disc_iters=di, gp_lambda=cfg.gp_lambda)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _, world = initialize_distributed(
        backend, "file://" + os.path.join(tmp, "rendezvous_dp"), 1, 0)
    try:
        group = dist.group.WORLD
        states = {n: fresh() for n in ("plain", "control", "global", "dp")}
        steps = {n: make_data_train_step(states[n], batch_size=batch, **kw)
                 for n in ("plain", "control")}
        steps["global"] = make_data_train_step(
            states["global"], batch_size=batch, group=group, **kw)
        dp = make_dp_train_step(states["dp"], group=group, **kw)
        steps["dp"] = lambda d, gen, dr: dp(d[dr.idx], 0, dr)
        metrics = {n: s(data, None, draws) for n, s in steps.items()}
        ref = _state_tensors(states["plain"])
        out = {"world": world, "backend": backend, "batch": batch,
               "disc_iters": di, "dtype": cfg.compute_dtype}
        for n in ("control", "global", "dp"):
            got = _state_tensors(states[n])
            out[f"{n}_bit_equal"] = len(got) == len(ref) and all(
                torch.equal(a, b) for a, b in zip(got, ref)) and all(
                torch.equal(metrics[n][m], metrics["plain"][m])
                for m in metrics["plain"])
            out[f"{n}_max_abs_err"] = max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(got, ref))
        out["tensors"] = len(ref)
        # steps/s, each step drawing its own batch from its generator
        own = {"plain": lambda g: steps["plain"](data, g),
               "global": lambda g: steps["global"](data, g),
               "dp": lambda g: dp(data[torch.randint(
                   0, 2048, (di, batch), generator=g, device=dev)], 1)}
        for n, fn in own.items():
            g = generator_for(5, dev)
            fn(g)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(DP_TIMED_STEPS):
                fn(g)
            torch.cuda.synchronize(dev)
            out[f"{n}_steps_per_s"] = DP_TIMED_STEPS / (
                time.perf_counter() - t0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    emit("parallel_dp_world1", **out)
    if not out["control_bit_equal"]:
        fail(f"the plain step is not deterministic on this card: {out}")
    if not (out["global_bit_equal"] and out["dp_bit_equal"]):
        fail(f"the DP steps at world 1 differ from the plain step: {out}")
    return out


def tools_phase(build, tmp: str) -> dict:
    """9c the multi-device dry runs: dryrun_multichip(1) on the card (one
    NCCL rank) and dryrun_multichip(4, device="cpu") (four gloo ranks);
    9d scripts/int8_validate_torch.py on the committed flagship (the stamp
    into `tmp`; it must pass) and scripts/serving_bench_torch.py on it
    (classifier A: the one phase 6 trained and cached, else a seeded one
    in a temporary cache). Launch counters are set to 0 before 9d and read
    after: v2 and v2i must have run."""
    import torch

    import multichip_torch
    from defensegan_torch.cli import int8_validate, serving_bench
    from defensegan_torch.eval import classifier as clf_cache
    from defensegan_torch.models import build_classifier

    out = {}
    t0 = time.perf_counter()
    out["dryrun_cuda_1"] = multichip_torch.dryrun_multichip(1)
    out["dryrun_cuda_1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun_cpu_4"] = multichip_torch.dryrun_multichip(4, device="cpu")
    out["dryrun_cpu_4_s"] = time.perf_counter() - t0
    emit("parallel_dryrun", **out)

    build.reset_launches()
    t0 = time.perf_counter()
    gate = int8_validate.main(
        ["--cfg", os.path.join(CFG_DIR, "mnist_fast.yml"), "--output_dir",
         RUN_DIR, "--out", os.path.join(tmp, "int8_gate_cuda.json")])
    emit("int8_validate", s=time.perf_counter() - t0, stamp=gate["stamp"],
         metrics=gate["metrics"], bench=gate["bench"])
    stamp = gate["stamp"]
    if not stamp["pass"] or stamp["paths"] != {
            "int8": "pallas_int8", "bf16": "pallas",
            "reference": "xla float32"}:
        fail(f"int8_validate: {stamp}")
    cached = clf_cache.load_cached_classifier(
        "mnist_modelA", build_classifier("A"))
    root = clf_cache.CACHE_ROOT
    if cached is None:
        clf_cache.CACHE_ROOT = os.path.join(tmp, "classifiers_torch")
        clf_cache.save_classifier("mnist_modelA", clf_cache.ClassifierState(
            build_classifier("A", gen=torch.Generator().manual_seed(5))))
    try:
        t0 = time.perf_counter()
        rows = serving_bench.main(
            ["--cfg", RUN_DIR, "--model", "A", "--batches",
             *SERVING_BATCHES, "--repeats", "3", "--results_dir",
             os.path.join(tmp, "results")])
    finally:
        clf_cache.CACHE_ROOT = root
    launches = dict(build.LAUNCHES)
    emit("serving_bench", s=time.perf_counter() - t0,
         classifier="cached (phase 6)" if cached is not None
         else "seeded, temporary cache",
         rows=[{k: r[k] for k in ("batch", "kernel", "latency_ms_min",
                                  "latency_ms_median", "images_per_s",
                                  "clean_flag_rate")} for r in rows],
         device=rows[0]["device"], launches=launches)
    if any(r["kernel"] != "pallas" or not r["images_per_s"] > 0
           for r in rows) or launches["fused_projection_v2"] <= 0 \
            or launches["fused_projection_v2i"] <= 0:
        fail(f"serving_bench: {rows}, launches {launches}")
    return out


def parallel_phase(build, gan, tmp: str) -> None:
    """Phase 9: several devices (9a-9d), from the repository's root (the
    tools resolve the committed run's relative paths there)."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        sharded_serving_phase(build, gan)
        dp_world1_phase(tmp, gan.device)
        tools_phase(build, tmp)
    finally:
        os.chdir(cwd)


# (10) the experiments' kernels (defensegan_torch/experiments/): the
# stream64 level and the three layout experiments on v3.
# 10a holds the level kernel against its plain version half by half
# (stream64_probe.check_against_plain): dh equal but where the relu test of
# an h within 1e-4 of its summed absolute products of 0 took the other
# side, dx within one bf16 ulp of the output plus one of every rounded tap
# of the plain backward of the kernel's own dh (conv3x3.rounding_excess, as
# 3a'' holds the grid convs). The probe's own numerics check (dx against
# the library's float32-output form within 2e-2 of its largest element,
# the JAX probe's bound) runs inside run_probe.
# 10b holds each variant against its plain version at L 1 and 5 on 512
# rows row by row with v3's bounds (3a), 192-row chunks bit for bit against
# one chunk, and the two-chain loop bit for bit against the v3 kernel; at
# L 200 on 1024 images x R 10 (ab_variant: the [B, R] final losses by the
# tie-aware gate against the v3 kernel, the two-chain loop's z_final bit
# for bit). The variants compute v3's function, so their bound and
# library yardstick are v3's (phase 5).
S64_BATCH = 512
S64_ITERS = 50
VARIANT_IMAGES = 1024


def _once_ms(fn) -> float:
    """Host time of one synchronized call, in ms (no warm-up: the plain
    versions build nothing)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def experiments_phase(build, deep, v3_timing: dict) -> list:
    """Phase 10; returns the experiments' entries of the `kernels` line."""
    import torch
    from defensegan_torch.experiments import stream64_probe as sp
    from defensegan_torch.experiments.v3_variants import (VARIANTS,
                                                          ab_variant)
    from defensegan_torch.defense.project import tile_restarts
    from defensegan_torch.defense.fastgen import pack_generator
    from defensegan_torch.kernels.fused_projection_v3 import (
        fused_projection_s2d, pack_s2d)
    from defensegan_torch.models import from_image_space
    t_phase = time.perf_counter()
    dev = deep.device
    cfg = deep.cfg
    k, rr = cfg.latent_dim, cfg.rec_rr
    kw_loop = dict(rec_iters=cfg.rec_iters, rec_lr=cfg.rec_lr,
                   momentum=cfg.rec_momentum)

    # ---- 10a. the level kernel against its plain version, each level
    s64 = {}
    for lvl, (g, ci, co) in sp.LEVELS.items():
        a = sp.draw_arrays(lvl, S64_BATCH, seed=100 + lvl)
        pack = sp.level_tensors(*sp.pack_level(a["w"], a["b"], a["scale"],
                                               a["shift"]), g, dev)
        x = torch.as_tensor(a["x0"]).to(dev)
        cot = sp.to_phase_blocked(torch.as_tensor(a["cot"]).to(dev)) \
            .to(torch.bfloat16)
        dx, dh = sp.fused_level(x, cot, pack, return_dh=True)
        torch.cuda.synchronize()
        s64[f"L{lvl}"] = dict(g=g, ci=ci, co=co, batch=S64_BATCH,
                              **sp.check_against_plain(x, cot, pack, dx, dh))
        del a, pack, x, cot, dx, dh
    emit("stream64_level_vs_plain", **s64)
    if not all(r["ok"] for r in s64.values()):
        fail(f"the stream64 level left its band: {s64}")

    # ---- 10b. each variant against its plain version at L 1 and 5
    pack3 = pack_s2d(deep.generator)
    perm = pack_generator(deep.generator, "s2d").perm[0]
    gd = torch.Generator(device=dev).manual_seed(97531)

    def rows_s2d(x_img, r):
        return tile_restarts(from_image_space(x_img).reshape(
            x_img.shape[0], -1)[:, perm], r)

    xr = rows_s2d(deep.generate(gd, 512), 1)
    z0 = torch.randn(512, k, device=dev, generator=gd)
    errs = {v: {} for v in VARIANTS}
    for name, var in VARIANTS.items():
        rec = {}
        for steps, tol in ELEMENTWISE_TOL.items():
            kw = dict(kw_loop, rec_iters=steps)
            zk = var.loop(pack3, xr, z0, **kw)
            zc = var.loop(pack3, xr, z0, chunk=192, **kw)
            torch.cuda.synchronize()
            zp = var.plain(pack3, xr, z0, **kw)
            e = row_errors(zk, zp, z0)
            errs[name][steps] = e["max_abs_err"]
            ok = bool(torch.isfinite(zk).all()) and torch.equal(zc, zk) \
                and e["row_rel_p50"] <= tol \
                and e["row_rel_max"] <= V3_WORST_ROW_TOL[steps]
            if var.bit_equal:
                e["equals_v3_kernel"] = bool(torch.equal(
                    zk, fused_projection_s2d(pack3, xr, z0, **kw)))
                ok = ok and e["equals_v3_kernel"]
            rec[f"L{steps}"] = dict(**e, chunked_equal=bool(
                torch.equal(zc, zk)), tol_row_p50=tol,
                tol_row_max=V3_WORST_ROW_TOL[steps], ok=bool(ok))
        emit(f"variant_{name}_vs_plain", **rec)
        if not all(r["ok"] for r in rec.values()):
            fail(f"variant {name} against its plain version: {rec}")
    del xr, z0

    # ---- 10c. the experiments' entry points, counters from 0: the probe
    # at each level (batch 512, the JAX probe's tiles, 50 steps, median of
    # 3) and the A/B of each variant against v3 (1024 images x R 10 x L 200)
    build.reset_launches()
    probes = [sp.run_probe(lvl, S64_BATCH, sp.DEFAULT_TILE[lvl], S64_ITERS,
                           3, device=dev, seed=200 + lvl)
              for lvl in sp.LEVELS]
    ab = {name: ab_variant(deep, name, VARIANT_IMAGES, repeats=3,
                           seed=300 + i)
          for i, name in enumerate(VARIANTS)}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    decision = sp.decision([p["speedup"] for p in probes])
    emit("stream64_probe", levels=probes, **decision,
         launches=launches[sp.COUNTER])
    for name, rec in ab.items():
        emit(f"variant_{name}_ab", **rec,
             launches=launches[VARIANTS[name].counter])
    counters = [sp.COUNTER] + [v.counter for v in VARIANTS.values()]
    if not all(p["numerics_ok"] for p in probes) or \
            not all(r["gate"]["ok"] for r in ab.values()):
        fail(f"the probe's numerics or a variant's gate against v3: "
             f"{[p['rel_err'] for p in probes]}, "
             f"{ {n: r['gate'] for n, r in ab.items()} }")
    if not all(launches[c] > 0 for c in counters):
        fail(f"an experiment's kernel never launched: {launches}")

    # ---- 10d. the plain versions at the timed shape, one run each
    x_img = deep.generate(gd, VARIANT_IMAGES)
    x_rep = rows_s2d(x_img, rr)
    z0 = torch.randn(VARIANT_IMAGES * rr, k, device=dev, generator=gd)
    plain_ms = {name: _once_ms(lambda: var.plain(pack3, x_rep, z0,
                                                 **kw_loop))
                for name, var in VARIANTS.items()}
    s = time.perf_counter() - t_phase
    emit("experiments_plain_ms", **plain_ms, phase_s=s)

    entries = [{
        "name": sp.COUNTER, "route": "cuda",
        "source": "defensegan_torch/csrc/stream64_level.cu",
        "replaces": "scripts/stream64_probe.py:118",
        "launches": launches[sp.COUNTER],
        "max_abs_err": max(r["max_abs_err"] for r in s64.values()),
        "ms": sum(p["kernel_ms_per_iter"] for p in probes),
        "plain_ms": sum(p["plain_ms_per_iter"] for p in probes),
        "bound_ms": sum(p["bound_ms"] for p in probes),
        "bound_by": "operations"
        if all(p["bound_by"] == "operations" for p in probes) else "bytes",
        "library_ms": sum(p["library_ms_per_iter"] for p in probes)}]
    for name, var in VARIANTS.items():
        entries.append({
            "name": var.counter, "route": "cuda", "source": var.source,
            "replaces": var.replaces, "launches": launches[var.counter],
            "max_abs_err": max(errs[name].values()),
            "ms": ab[name][name]["loop_ms"], "plain_ms": plain_ms[name],
            "bound_ms": v3_timing["bound_ms"],
            "bound_by": v3_timing["bound_by"],
            "library_ms": v3_timing["library_ms"]})
    return entries


# (11) the compile probes (defensegan_torch/experiments/v3_diag.py,
# v3_diag2.py).
# 11a holds each of the ten cases at the script's shapes against its plain
# version (v3_diag.check): the copies, rolls, shifts, lane concats and the
# mask product bit for bit; the two single products within
# gemm.rounding_excess (1e-4 of the summed absolute products); the tanh
# chain (k6) within 8 float32 ulps of the size of its terms; the two
# chains of four products (k7, k10), which round to bf16 between products,
# within 1e-2 of the output's largest magnitude (the plain version and the
# Pallas kernel in interpret mode sit 1.75e-3 of it apart).
# 11b runs the seven cuts on the seeded mnist.yml at 64 latents. Each
# section is held against the plain version's computed from the kernel's
# own earlier sections (v3_diag2.check_sections): one section's float32
# summation order alone, within one bf16 ulp of each element plus 1e-3 of
# the section's largest magnitude. (End to end, a relu decision within
# float32 noise of zero would switch a whole gradient element, as 3a
# says.) z_out equals z0 bit for bit before `full`; `full` is held row by
# row as v3 at L 1 (3a's bounds). With one NaN in x: the cuts before the
# tanh gradient return z0, the summed cuts from it on all NaN, `full` NaN
# in that latent's row alone; each pattern as the plain version's.


ZFINAL_SHAPES = ((512, 5), (10240, 200))     # v3's z_final, rows x L
# rounds of the probe cases' host timing (20 calls each, the kernel, its
# plain version and its library composition in turns): a case's host time
# is a few microseconds, and the machine's host wanders by more than the
# gap between the kernel and torch's own op within a round or two
PROBE_REPEATS = 21


def _zfinal_module():
    """scripts/torch_v3_zfinal.py as a module (its `zfinal`)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_v3_zfinal", os.path.join(ROOT, "scripts",
                                        "torch_v3_zfinal.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probes_phase(build, deep) -> list:
    """Phase 11; returns the probes' entries of the `kernels` line."""
    import torch
    from defensegan_torch.experiments import v3_diag, v3_diag2
    from defensegan_torch.kernels.fused_projection_v3 import CUTS, pack_s2d
    t_phase = time.perf_counter()
    dev = deep.device
    sync = torch.cuda.synchronize

    # ---- 11a. the ten cases against their plain versions
    cases = {}
    for name in v3_diag.CASES:
        inputs = v3_diag.draw_inputs(name, dev)
        got = v3_diag.diag_case(name, *inputs)
        sync()
        cases[name] = v3_diag.check(name, got,
                                    v3_diag.diag_case_plain(name, *inputs),
                                    inputs)
    emit("probe_cases_vs_plain", **cases, chain_tol=v3_diag.CHAIN_TOL,
         tanh_ulps=v3_diag.ULPS_K6)
    if not all(r["ok"] for r in cases.values()):
        fail(f"a probe case left its bound: {cases}")

    # ---- 11b. the seven cuts against the plain version, then a NaN in x;
    # one plan through every cut (graph replays) bit for bit against the
    # fresh calls (launches one by one)
    pack = pack_s2d(deep.generator)
    out_dim = pack.grid_hw ** 2 * pack.cb
    z0, x = v3_diag2.diag2_inputs(pack.z_dim, out_dim, seed=11, device=dev)
    nan_row = 5
    xn = x.clone()
    xn[nan_row, 7 * pack.cb + 3] = float("nan")
    plan = v3_diag2.prepare(pack, z0.shape[0], dev)
    sections, z0_equal, nan, plan_equal = {}, {}, {}, {}
    for targets in (x, xn):
        for upto in CUTS:
            z_out, sec = v3_diag2.run_cut(pack, targets, z0, upto)
            sync()
            got = v3_diag2.run_cut(plan, targets, z0, upto)
            sync()
            plan_equal[f"{upto}{'' if targets is x else '.nan'}"] = all(
                torch.equal(a.nan_to_num(), b.nan_to_num()) and
                torch.equal(a.isnan(), b.isnan())
                for a, b in zip(got, (z_out, sec)))
            if targets is x:
                sections[upto] = sec
                if upto == "full":
                    z_full = z_out
                else:
                    z0_equal[upto] = bool(torch.equal(z_out, z0))
                continue
            zp, _ = v3_diag2.cut_plain(pack, xn, z0, upto)
            rows = torch.isnan(z_out).any(1).nonzero().flatten().tolist()
            if CUTS.index(upto) < CUTS.index("grad"):
                ok = torch.equal(z_out, z0)
            elif upto != "full":
                ok = bool(torch.isnan(z_out).all())
            else:
                ok = rows == [nan_row] and bool(
                    torch.isnan(z_out[nan_row]).all())
            nan[upto] = dict(nan_rows=len(rows), ok=bool(ok) and torch.equal(
                torch.isnan(z_out), torch.isnan(zp)))
    checked = v3_diag2.check_sections(pack, x, z0, sections)
    z_ref, _ = v3_diag2.cut_plain(pack, x, z0, "full")
    full = row_errors(z_full, z_ref, z0)
    full["ok"] = bool(torch.isfinite(z_full).all()) and \
        full["row_rel_p50"] <= ELEMENTWISE_TOL[1] and \
        full["row_rel_max"] <= V3_WORST_ROW_TOL[1]
    emit("probe_cuts_vs_plain", sections=checked, z0_equal=z0_equal,
         full=dict(**full, tol_row_p50=ELEMENTWISE_TOL[1],
                   tol_row_max=V3_WORST_ROW_TOL[1]), nan=nan,
         plan_equal=plan_equal, section_ulp=v3_diag2.SECTION_ULP,
         section_abs=v3_diag2.SECTION_ABS, latents=v3_diag2.TILE)
    if not (all(r["ok"] for r in checked.values())
            and all(z0_equal.values()) and full["ok"]
            and all(r["ok"] for r in nan.values())
            and all(plan_equal.values())):
        fail(f"a cut against its plain version or a plan against the "
             f"fresh calls: {checked}, {z0_equal}, {full}, {nan}, "
             f"{plan_equal}")
    del plan

    # ---- 11c. the two scripts' runs, counters from 0; the launch path's
    # floor; every case at least as fast as its PyTorch composition, both
    # into one given output, round by round (v3_diag.run_cases'
    # vs_library)
    build.reset_launches()
    recs = v3_diag.run_cases(dev, repeats=PROBE_REPEATS)
    cut_recs = v3_diag2.run_cuts(pack, x, z0)
    sync()
    launches = dict(build.LAUNCHES)
    floor = v3_diag.launch_costs(dev)
    one = dict(rec_iters=1, rec_lr=v3_diag2.LR, momentum=v3_diag2.MOMENTUM)
    full_library_ms = v3_diag.host_ms(
        {"lib": lambda: library_loop_v3(pack, x, z0, **one)}, sync)["lib"]
    full_bound = bounds_v3(deep.generator, pack, v3_diag2.TILE, 1)
    full_profile = v3_diag2.profile_cut(v3_diag2.prepare(pack, z0.shape[0],
                                                         dev), x, z0)
    empty_ms = floor["empty_kernel_device_us"] * 1e-3
    for r in recs:
        if r["ok"]:
            r["device_vs_floor"] = r["device_ms"] / max(r["bound_ms"],
                                                        empty_ms)
    emit("probe_runs", cases=recs, cuts=cut_recs, launch_floor=floor,
         full_library_ms=full_library_ms, full_bound=full_bound,
         full_profile=full_profile,
         launches={c: launches[c] for c in (v3_diag.COUNTER,
                                            v3_diag2.COUNTER)},
         phase_s=time.perf_counter() - t_phase)
    if not all(r["ok"] for r in recs + cut_recs):
        fail(f"a probe's run failed: {recs}, {cut_recs}")
    if launches[v3_diag.COUNTER] <= 0 or launches[v3_diag2.COUNTER] <= 0:
        fail(f"a probe's kernel never launched: {launches}")
    slower = {r["case"]: r["vs_library"] for r in recs
              if r["vs_library"]["ratio"] > 1.0}
    if slower:
        fail(f"probe cases slower than their PyTorch composition (the "
             f"median of the rounds' host-time ratios, each writing into "
             f"the same given output, above 1): {slower}")

    # ---- 11d. v3's z_final against the reference digests (the probes'
    # cut step shares v3's step header)
    zmod = _zfinal_module()
    zfinal = [zmod.zfinal(r, it, seeded_deep_gan=seeded_deep_gan)
              for r, it in ZFINAL_SHAPES]
    emit("v3_zfinal", runs=zfinal)
    if any(z["same"] is None for z in zfinal):
        fail(f"no reference digest of v3's z_final for this card and torch "
             f"build (scripts/torch_v3_zfinal.py's REFERENCE says how to "
             f"record one): {zfinal}")
    if not all(z["same"] for z in zfinal):
        fail(f"v3's z_final left its reference digest: {zfinal}")

    by_cut = {r["upto"]: r for r in cut_recs}
    return [{
        "name": v3_diag.COUNTER, "route": "cuda",
        "source": "defensegan_torch/csrc/v3_diag.cu",
        "replaces": "scripts/pallas_v3_diag.py:30",
        "launches": launches[v3_diag.COUNTER],
        "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
        "ms": sum(r["ms"] for r in recs),
        "plain_ms": sum(r["plain_ms"] for r in recs),
        "bound_ms": sum(r["bound_ms"] for r in recs),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in recs) else "bytes",
        "library_ms": sum(r["library_ms"] for r in recs)}, {
        "name": v3_diag2.COUNTER, "route": "cuda",
        "source": "defensegan_torch/csrc/v3_diag2.cu",
        "replaces": "scripts/pallas_v3_diag2.py:30",
        "launches": launches[v3_diag2.COUNTER],
        "max_abs_err": full["max_abs_err"],
        "ms": by_cut["full"]["ms"], "plain_ms": by_cut["full"]["plain_ms"],
        "bound_ms": full_bound["bound_ms"],
        "bound_by": full_bound["bound_by"],
        "library_ms": full_library_ms}]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "defensegan_torch")):
        print("chip_smoke: defensegan_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F

    from defensegan_torch.configs import load_config
    from defensegan_torch.defense.audit import AuditedPipeline
    from defensegan_torch.defense.fastgen import (make_packed_apply,
                                                  pack_generator)
    from defensegan_torch.defense.pipeline import DefendedPipeline
    from defensegan_torch.defense.project import rec_losses, tile_restarts
    from defensegan_torch.eval.quality import (best_loss_p95, int8_gate_ok,
                                               tie_aware_disagreement)
    from defensegan_torch.gan import DefenseGAN
    from defensegan_torch.kernels import build
    from defensegan_torch.kernels.fused_projection_v2 import (
        dense_loop_plain, fused_projection_dense, pack_dense, padded_fc)
    from defensegan_torch.kernels.fused_projection_v2i import (
        _quant_rows, dense_int8_loop_plain, fused_projection_dense_int8,
        pack_dense_int8)
    from defensegan_torch.kernels.gemm import gemm, gemm_plain, split_k_for
    from defensegan_torch.kernels.gemm import rounding_excess as gemm_excess
    from defensegan_torch.kernels.conv3x3 import (conv3x3, conv3x3_plain,
                                                  rounding_excess)
    from defensegan_torch.kernels.fused_projection_v3 import (
        fused_projection_s2d, pack_s2d, padded_s2d, s2d_loop_plain)
    from defensegan_torch.kernels.fused_projection_v4 import (
        fused_projection_v4, pack_v4, padded_v4, v4_loop_plain, x_rows)
    from defensegan_torch.models import build_classifier, from_image_space

    # fp32 references run in full float32 (no TF32 in products or convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         build_s=round(time.perf_counter() - t0, 3))

    # ------------------------------------------------------------ 2. load
    cfg = load_config(RUN_DIR).replace(output_dir=RUN_DIR)
    gan = DefenseGAN(cfg).load()
    if gan.device.type != "cuda" or not gan.has_encoder():
        fail("flagship did not load on cuda with its encoder")
    k, rr, iters, lr, mom = (cfg.latent_dim, cfg.rec_rr, cfg.rec_iters,
                             cfg.rec_lr, cfg.rec_momentum)
    emit("load", step=gan.step, device=str(gan.device),
         dtype=str(gan.dtype), gen_arch=cfg.gen_arch, latent=k, rr=rr,
         iters=iters)

    # the deep model: seeded init, BatchNorm statistics from a seeded
    # generator (no trained deep checkpoint is in the repository)
    deep = seeded_deep_gan()
    dcfg = deep.cfg
    if (dcfg.latent_dim, dcfg.rec_rr, dcfg.rec_iters, dcfg.rec_lr,
            dcfg.rec_momentum) != (k, rr, iters, lr, mom):
        fail("mnist.yml and mnist_fast.yml differ in k, R, L, lr or m")
    emit("load_deep", weights="seeded", device=str(deep.device),
         dtype=str(deep.dtype), gen_arch=dcfg.gen_arch,
         channels=list(deep.generator.channels), latent=dcfg.latent_dim,
         rr=dcfg.rec_rr, iters=dcfg.rec_iters)

    # the 64x64 model: seeded like the deep one (no trained 64x64
    # checkpoint is in the repository); a float32 copy of it is the fp32
    # generic path that v4 is gated against
    celeba = seeded_celeba_gan()
    ccfg = celeba.cfg
    celeba32 = DefenseGAN(ccfg.replace(compute_dtype="float32"))
    celeba32.generator.load_state_dict(celeba.generator.state_dict())
    if (ccfg.latent_dim, ccfg.rec_iters, ccfg.rec_lr, ccfg.rec_momentum) \
            != (k, iters, lr, mom):
        fail("celeba.yml and mnist_fast.yml differ in k, L, lr or m")
    emit("load_celeba", weights="seeded", device=str(celeba.device),
         dtype=str(celeba.dtype), gen_arch=ccfg.gen_arch,
         channels=list(celeba.generator.channels), latent=ccfg.latent_dim,
         rr=ccfg.rec_rr, iters=ccfg.rec_iters,
         image_shape=list(ccfg.image_shape))

    g = torch.Generator(device=dev).manual_seed(1234)
    gd = torch.Generator(device=dev).manual_seed(4321)   # the deep phases'
    gc = torch.Generator(device=dev).manual_seed(2468)   # the 64x64 phases'
    p2 = pack_dense(gan.generator)
    p8 = pack_dense_int8(gan.generator)
    p32 = pack_dense(gan.generator, torch.float32)
    p3 = pack_s2d(deep.generator)
    apply_bf = make_packed_apply(pack_generator(gan.generator, "dense"))
    apply_32 = make_packed_apply(
        pack_generator(gan.generator, "dense", torch.float32))
    s2d_packed = pack_generator(deep.generator, "s2d")
    apply_s2d = make_packed_apply(s2d_packed)
    pdim = p2.d.shape[1]
    t0 = time.perf_counter()
    p4 = pack_v4(celeba.generator)
    pack_v4_s = time.perf_counter() - t0
    apply_conv = make_packed_apply(pack_generator(celeba.generator, "conv"))

    def rows_v4(x_img, r, pack=None):
        """The v4 loop's targets: tanh rows in double-blocked order."""
        return tile_restarts(x_rows(pack or p4, from_image_space(x_img)), r)

    def apply_v4(z):
        """G(z) in the order of the v4 loop's targets (the loss is a mean
        over all outputs, so any one order serves on both sides)."""
        return x_rows(p4, apply_conv(z).reshape((-1,) + ccfg.image_shape))

    def x_pad_of(x_flat_tanh):
        return F.pad(x_flat_tanh.to(torch.bfloat16),
                     (0, pdim - x_flat_tanh.shape[1]))

    def rows_flat(x_img, r):
        return tile_restarts(from_image_space(x_img).reshape(
            x_img.shape[0], -1), r)

    def rows_s2d(x_img, r):
        """The deep loop's targets: flat tanh rows in s2d pixel order."""
        return rows_flat(x_img, r)[:, s2d_packed.perm[0]]

    # per kernel: its model and generator stream, the wrapper's x rows,
    # the plain version's x, the packed apply that scores z_final, and the
    # timed shape (images, restarts; L = 200 for all)
    big = dict(b=1024, rr=rr)
    kernels = {
        "fused_projection_v2": dict(
            run=fused_projection_dense, plain=dense_loop_plain, pack=p2,
            library=library_loop_v2, gan=gan, gen=g, rows=rows_flat,
            plain_x=x_pad_of, apply=apply_bf, request="pallas", **big,
            source="defensegan_torch/csrc/fused_projection_v2.cu",
            replaces="defensegan_tpu/kernels/fused_projection_v2.py:85"),
        "fused_projection_v2i": dict(
            run=fused_projection_dense_int8, plain=dense_int8_loop_plain,
            pack=p8, library=library_loop_v2i, gan=gan, gen=g,
            rows=rows_flat, plain_x=x_pad_of, apply=apply_bf,
            request="pallas_int8", **big,
            source="defensegan_torch/csrc/fused_projection_v2i.cu",
            replaces="defensegan_tpu/kernels/fused_projection_v2i.py:81"),
        "fused_projection_v3": dict(
            run=fused_projection_s2d, plain=s2d_loop_plain, pack=p3,
            library=library_loop_v3, gan=deep, gen=gd, rows=rows_s2d,
            plain_x=lambda x: x, apply=apply_s2d, request="pallas", **big,
            source="defensegan_torch/csrc/fused_projection_v3.cu",
            replaces="defensegan_tpu/kernels/fused_projection_v3.py:138"),
        "fused_projection_v4": dict(
            run=fused_projection_v4, plain=v4_loop_plain, pack=p4,
            library=library_loop_v4, gan=celeba, gen=gc, rows=rows_v4,
            plain_x=lambda x: x, apply=apply_v4, request="pallas_v4",
            b=512, rr=ccfg.rec_rr,
            source="defensegan_torch/csrc/fused_projection_v4.cu",
            replaces="defensegan_tpu/kernels/fused_projection_v4.py:251"),
    }
    V3, V4 = "fused_projection_v3", "fused_projection_v4"
    ROW_WISE = (V3, V4)          # held row by row, with the f64 control

    def images(n, kk=kernels["fused_projection_v2"]):
        """Clean requests G(z_true), [n, H, W, C] in [0, 1]."""
        return kk["gan"].generate(kk["gen"], n)

    def noisy(x, gen=g):
        """Off-manifold copies: +-0.1 uniform noise, clipped to [0, 1]."""
        u = torch.rand(x.shape, device=dev, generator=gen)
        return (x + (u - 0.5) * 0.2).clamp(0.0, 1.0)

    # ------------------------------------- 3a. elementwise, L = 1 and 5
    inputs = {}
    for name in ("fused_projection_v2", V3, V4):    # v2i shares v2's draws
        kk = kernels[name]
        inputs[name] = (kk["rows"](images(512, kk), 1),
                        torch.randn(512, k, device=dev, generator=kk["gen"]))
    inputs["fused_projection_v2i"] = inputs["fused_projection_v2"]
    errs = {name: {} for name in kernels}
    for steps, tol in ELEMENTWISE_TOL.items():
        for name, kk in kernels.items():
            xr, z0 = inputs[name]
            kw = dict(rec_iters=steps, rec_lr=lr, momentum=mom)
            zk = kk["run"](kk["pack"], xr, z0, **kw)
            zp = kk["plain"](kk["pack"], kk["plain_x"](xr), z0, **kw)
            # a row's result does not depend on the other rows: 192-row
            # chunks (192, 192, 128) must equal one chunk bit for bit
            zc = kk["run"](kk["pack"], xr, z0, chunk=192, **kw)
            torch.cuda.synchronize()
            e = row_errors(zk, zp, z0)
            chunked_equal = bool(torch.equal(zc, zk))
            errs[name][steps] = e["max_abs_err"]
            ok = bool(torch.isfinite(zk).all()) and chunked_equal
            extra = {}
            if name in ROW_WISE:
                z64 = kk["plain"](kk["pack"], xr, z0,
                                  product_dtype=torch.float64, **kw)
                c = row_errors(zp, z64, z0)
                p50, worst = v4_row_bounds(steps, c) if name == V4 \
                    else (tol, V3_WORST_ROW_TOL[steps])
                ok = ok and e["row_rel_p50"] <= p50 \
                    and e["row_rel_max"] <= worst
                extra = dict(tol_row_p50=p50, tol_row_max=worst,
                             control_plain_f32_vs_f64=dict(
                                 rel=c["rel"], row_rel_p50=c["row_rel_p50"],
                                 row_rel_max=c["row_rel_max"]))
            else:
                ok = ok and e["max_abs_err"] <= tol * e["moved"]
                extra = dict(tol_rel=tol)
            emit(f"elementwise_{name}_L{steps}", **e, **extra,
                 chunked_equal=chunked_equal, ok=ok)
            if not ok:
                fail(f"{name} L={steps}: {e} against {extra} or chunks "
                     f"differ ({chunked_equal})")

    # 3a'. the level list at other widths: celeba_wide.yml (three levels,
    # fc -> 8x8x256) and imagenet64.yml (k 256, widths of 96: 768 -> 384 ->
    # 192 -> 96), one step at 128 rows against the plain version
    for cfg_name in ("celeba_wide", "imagenet64"):
        other = seeded_celeba_gan(cfg_name)
        ocfg = other.cfg
        t0 = time.perf_counter()
        po = pack_v4(other.generator)
        pack_s = time.perf_counter() - t0
        xr = rows_v4(other.generate(gc, 128), 1, po)
        z0 = torch.randn(128, ocfg.latent_dim, device=dev, generator=gc)
        kw = dict(rec_iters=1, rec_lr=ocfg.rec_lr,
                  momentum=ocfg.rec_momentum)
        zk = fused_projection_v4(po, xr, z0, **kw)
        torch.cuda.synchronize()
        zp = v4_loop_plain(po, xr, z0, **kw)
        e = row_errors(zk, zp, z0)
        c = row_errors(zp, v4_loop_plain(po, xr, z0,
                                         product_dtype=torch.float64, **kw),
                       z0)
        p50, worst = v4_row_bounds(1, c)
        ok = bool(torch.isfinite(zk).all()) and e["row_rel_p50"] <= p50 \
            and e["row_rel_max"] <= worst
        emit(f"elementwise_{V4}_{cfg_name}_L1", **e,
             levels=[[lv.g, lv.ci, lv.co, lv.interleave_after]
                     for lv in po.levels], latent=ocfg.latent_dim,
             pack_s=pack_s, tol_row_p50=p50, tol_row_max=worst,
             control_plain_f32_vs_f64=dict(
                 rel=c["rel"], row_rel_p50=c["row_rel_p50"],
                 row_rel_max=c["row_rel_max"]), ok=ok)
        if not ok:
            fail(f"{V4} on {cfg_name}: {e}")
        del other, po, xr, zk, zp

    # 3a''. every grid conv of the two deep paths on its own (the Hopper
    # conv of csrc/conv3x3_sm90.cuh at celeba.yml's levels, forward and
    # backward, and v3's conv A both ways; 256 rows, seeded activations)
    # against its plain version, within one bf16 ulp of the output plus one
    # of every rounded tap (conv3x3.rounding_excess <= 0)
    convs = {}
    pp4, pp3 = padded_v4(p4), padded_s2d(p3)
    cases = [("v3_conv_a_forward", "chain", pp3.grid_hw, pp3.ka, pp3.ba, 0,
              0), ("v3_conv_a_backward", "backward", pp3.grid_hw, pp3.kat,
                   None, 0, 0)]
    for i, lv in enumerate(pp4.levels):
        fine = lv.interleave_after or 0
        cases += [(f"v4_level{i}_forward", "per_tap" if lv.relu
                   else "tanh_grad", lv.g, lv.w, lv.b, 0, fine),
                  (f"v4_level{i}_backward", "backward", lv.g, lv.wt, None,
                   fine, 0)]
    for label, mode, gg, w, bias, in_fine, out_fine in cases:
        cin, cout = w.shape[0] // 9, w.shape[1]
        act = torch.relu(torch.randn(256, gg * gg * cin, device=dev,
                                     generator=gc)).to(torch.bfloat16)
        kw = dict(in_fine=in_fine, out_fine=out_fine)
        if mode == "backward":
            kw["h"] = torch.randn(256, gg * gg * cout, device=dev,
                                  generator=gc).to(torch.bfloat16)
        else:
            kw["bias"] = bias.reshape(-1)
        if mode == "tanh_grad":
            kw["x"] = torch.tanh(torch.randn(256, gg * gg * cout, device=dev,
                                             generator=gc)).to(torch.bfloat16)
            kw["scale"] = 2.0 / p4.out_dim
        got = conv3x3(act, w, gg, mode, **kw)
        torch.cuda.synchronize()
        ref = conv3x3_plain(act, w, gg, mode, **kw)
        excess = rounding_excess(got, ref, act, w, gg, mode,
                                 in_fine=in_fine, out_fine=out_fine,
                                 scale=kw.get("scale", 1.0))
        convs[label] = dict(mode=mode, g=gg, cin=cin, cout=cout,
                            in_fine=in_fine, out_fine=out_fine,
                            max_abs_err=(got.float() - ref.float()).abs()
                            .max().item(), rounding_excess=excess,
                            ok=excess <= 0)
    emit("grid_convs_vs_plain", **convs)
    if not all(c["ok"] for c in convs.values()):
        fail(f"a grid conv left its rounding band: {convs}")

    # 3a'''. every product of v2 and v2i on its own: the Hopper GEMM of
    # csrc/gemm_sm90.cuh at the flagship's shapes (512 rows; the fc backward
    # also at 10240 rows and at v4's K 8192 x 1024 rows, both split K), each
    # with its loop's epilogue, on chained seeded activations (a generator
    # of its own, so the later phases draw what they drew before), against
    # gemm_plain: bf16 within gemm.rounding_excess, int8 sums bit for bit
    gm = torch.Generator(device=dev).manual_seed(1357)
    bf = torch.bfloat16
    w1, w1t, b1 = padded_fc(p2)
    scale2 = 2.0 / p2.out_dim

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gm)

    x512 = torch.tanh(randn(512, pdim)).to(bf)
    zb512 = randn(512, w1.shape[0]).to(bf)
    h32, _ = gemm_plain(zb512, w1, "bias_relu_amax", bias=b1)
    hq, sh = _quant_rows(h32)
    do32, _ = gemm_plain(hq, p8.dq_k, "tanh_grad_int8", row_scale=sh,
                         col_scale=p8.sd, bias=p2.bd, x=x512, scale=scale2)
    gq, sg = _quant_rows(do32)
    hb = h32.to(bf)
    dob = gemm_plain(hb, p2.d, "tanh_grad", bias=p2.bd, x=x512, scale=scale2)
    dhb = gemm_plain(dob, p2.dt, "relu_mask", h=hb)

    def momentum_case(a, b):
        m = a.shape[0]
        return (a, b, "momentum", dict(z=randn(m, b.shape[1]),
                                       v=0.1 * randn(m, b.shape[1]),
                                       lr=lr, momentum=mom))

    big_dh = torch.where(randn(10240, w1t.shape[0]) > 0,
                         1e-3 * randn(10240, w1t.shape[0]), 0.0).to(bf)
    v4_dh = torch.where(randn(1024, pp4.w1t.shape[0]) > 0,
                        1e-3 * randn(1024, pp4.w1t.shape[0]), 0.0).to(bf)
    products = {
        "v2_fc_forward": (zb512, w1, "bias_relu", dict(bias=b1)),
        "v2_h_at_d": (hb, p2.d, "tanh_grad",
                      dict(bias=p2.bd, x=x512, scale=scale2)),
        "v2_do_at_dt": (dob, p2.dt, "relu_mask", dict(h=hb)),
        "v2_fc_backward": momentum_case(dhb, w1t),
        "v2i_fc_forward": (zb512, w1, "bias_relu_amax", dict(bias=b1)),
        "v2i_h_at_dq_sums": (hq, p8.dq_k, "store", {}),
        "v2i_h_at_dq": (hq, p8.dq_k, "tanh_grad_int8",
                        dict(row_scale=sh, col_scale=p8.sd, bias=p2.bd,
                             x=x512, scale=scale2)),
        "v2i_do_at_dtq_sums": (gq, p8.dtq_k, "store", {}),
        "v2i_do_at_dtq": (gq, p8.dtq_k, "relu_mask_int8",
                          dict(row_scale=sg, col_scale=p8.sdt, h=h32)),
        "fc_backward_rows_10240": momentum_case(big_dh, w1t),
        "v4_fc_backward_rows_1024": momentum_case(v4_dh, pp4.w1t),
    }
    gemms = {}
    for label, (a, b, epi, kw) in products.items():
        got = gemm(a, b, epi, **kw)
        torch.cuda.synchronize()
        ref = gemm_plain(a, b, epi, **kw)
        first = (got[0] if isinstance(got, tuple) else got).float()
        rec = dict(epilogue=epi, m=a.shape[0], k=a.shape[1],
                   n=first.shape[1], dtype=str(a.dtype).split(".")[-1],
                   splits=1 if a.dtype == torch.int8
                   else split_k_for(a.shape[1], first.shape[1]),
                   finite=bool(torch.isfinite(first).all()),
                   nonzero=float((first != 0).float().mean()))
        if a.dtype == torch.int8 and epi == "store":
            rec["bit_equal"] = bool(torch.equal(got, ref))
            ok = rec["bit_equal"]
        else:
            rec["max_abs_err"] = (first - (ref[0] if isinstance(ref, tuple)
                                           else ref).float()).abs().max().item()
            rec["rounding_excess"] = gemm_excess(
                got, ref, a, b, epi, scale=kw.get("scale", 1.0),
                lr=kw.get("lr", 0.0))
            ok = rec["rounding_excess"] <= 0
            if epi in ("bias_relu_amax", "tanh_grad_int8"):
                rec["amax_exact"] = bool(torch.equal(got[1],
                                                     got[0].abs().amax(1)))
                ok = ok and rec["amax_exact"]
        rec["ok"] = bool(ok and rec["finite"] and rec["nonzero"] > 0.2)
        gemms[label] = rec
    emit("gemms_vs_plain", **gemms)
    if not all(r["ok"] for r in gemms.values()):
        fail(f"a product left its band: {gemms}")
    del big_dh, v4_dh, products

    # ------- 3b. L = 200 at the timed shapes: half clean, half noisy
    loop_kw = dict(rec_iters=iters, rec_lr=lr, momentum=mom)
    losses = {}
    for name in ("fused_projection_v2", V3, V4):
        kk = kernels[name]
        clean = images(kk["b"] // 2, kk)
        x_img = torch.cat([clean, noisy(clean, kk["gen"])])
        x_rep = kk["rows"](x_img, kk["rr"])
        z0 = torch.randn(kk["b"] * kk["rr"], k, device=dev,
                         generator=kk["gen"])
        inputs[name] = (x_rep, z0)
        if name == V4:
            # the fp32 generic path on the same images and draws
            losses["v4_fp32_xla"] = celeba32.reconstruct(
                x_img, kernel="xla",
                z0=z0.reshape(kk["b"], kk["rr"], k)).all_losses.cpu().numpy()
            if celeba32.last_kernel != "xla":
                fail(f"the fp32 generic path ran {celeba32.last_kernel}")
    inputs["fused_projection_v2i"] = inputs["fused_projection_v2"]

    def final_losses(z_fin, kk, x_rep):
        return rec_losses(kk["apply"], z_fin, x_rep).reshape(
            kk["b"], kk["rr"]).cpu().numpy()

    for name, kk in kernels.items():
        x_rep, z0 = inputs[name]
        losses[name] = final_losses(
            kk["run"](kk["pack"], x_rep, z0, **loop_kw), kk, x_rep)
        losses[name + "_plain"] = final_losses(
            kk["plain"](kk["pack"], kk["plain_x"](x_rep), z0, **loop_kw),
            kk, x_rep)
    x_rep, z0 = inputs["fused_projection_v2"]
    b = big["b"]
    losses["fp32"] = rec_losses(apply_32, dense_loop_plain(
        p32, F.pad(x_rep, (0, pdim - x_rep.shape[1])), z0, **loop_kw),
        x_rep).reshape(b, rr).cpu().numpy()
    gate = {}
    for name in kernels:
        ref, test = losses[name + "_plain"], losses[name]
        tie = tie_aware_disagreement(ref, test)
        p95 = best_loss_p95(ref, test)
        ok = tie["material_disagreement"] <= MATERIAL_MAX and p95 <= P95_MAX
        extra = {}
        if name in ROW_WISE:
            half = kernels[name]["b"] // 2
            # with seeded weights the R restarts of an image can all end
            # within the tie threshold of each other, and then no pick is
            # ever "materially worse": say so, and hold the losses
            # themselves, restart by restart, relative to their size
            spread = ref.max(1) - ref.min(1)
            rel = np.abs(test - ref) / ref
            extra = dict(
                tie_gate_vacuous=bool((spread < tie["tau"]).mean() > 0.5),
                images_with_restart_spread_below_tau=float(
                    (spread < tie["tau"]).mean()),
                mean_loss_clean=float(ref[:half].mean()),
                mean_loss_noisy=float(ref[half:].mean()),
                loss_rel_p50=float(np.quantile(rel, 0.5)),
                loss_rel_p95=float(np.quantile(rel, 0.95)),
                loss_rel_p50_max=V3_LOSS_REL_P50_MAX,
                loss_rel_p95_max=V3_LOSS_REL_P95_MAX)
            ok = ok and np.isfinite(test).all() \
                and extra["loss_rel_p50"] <= V3_LOSS_REL_P50_MAX \
                and extra["loss_rel_p95"] <= V3_LOSS_REL_P95_MAX
        gate[name] = bool(ok)
        emit(f"selection_{name}_vs_plain", **tie, best_loss_p95=p95,
             material_max=MATERIAL_MAX, p95_max=P95_MAX, **extra,
             ok=bool(ok))
    ref32, l8 = losses["fp32"], losses["fused_projection_v2i"]
    l16 = losses["fused_projection_v2"]
    t8, t16 = tie_aware_disagreement(ref32, l8), \
        tie_aware_disagreement(ref32, l16)
    p8_, p16 = best_loss_p95(ref32, l8), best_loss_p95(ref32, l16)
    with open(os.path.join(RUN_DIR, "checkpoints", "int8_gate.json")) as f:
        criterion = json.load(f)["criterion"]
    int8_ok = int8_gate_ok(t8["material_disagreement"],
                           t16["material_disagreement"], p8_, p16)
    emit("int8_gate_vs_fp32", material_int8=t8["material_disagreement"],
         material_bf16_control=t16["material_disagreement"],
         best_loss_p95_int8=p8_, best_loss_p95_bf16_control=p16,
         mean_best_loss_fp32_clean=float(ref32[:b // 2].min(1).mean()),
         mean_best_loss_fp32_noisy=float(ref32[b // 2:].min(1).mean()),
         criterion=criterion, ok=int8_ok)
    # v4 against the fp32 generic path, its plain version as the control
    # (the int8 gate's criterion, control-relative on both axes: what bf16
    # itself costs against fp32 is the plain version's to show, the kernel
    # may add no more than the criterion's slack)
    ref32, l4, l4p = losses["v4_fp32_xla"], losses[V4], losses[V4 + "_plain"]
    t4, t4p = tie_aware_disagreement(ref32, l4), \
        tie_aware_disagreement(ref32, l4p)
    p4_, p4p = best_loss_p95(ref32, l4), best_loss_p95(ref32, l4p)
    v4_ok = int8_gate_ok(t4["material_disagreement"],
                         t4p["material_disagreement"], p4_, p4p)
    emit("v4_gate_vs_fp32_xla",
         argmin_agreement=float((ref32.argmin(1) == l4.argmin(1)).mean()),
         material_v4=t4["material_disagreement"],
         material_plain_control=t4p["material_disagreement"],
         mean_regret=t4["mean_regret"], best_loss_p95_v4=p4_,
         best_loss_p95_plain_control=p4p,
         best_loss_mean_fp32=float(ref32.min(1).mean()),
         best_loss_mean_v4=float(l4.min(1).mean()), ok=v4_ok)
    if not all(gate.values()) or not int8_ok or not v4_ok:
        fail(f"selection gates: {gate}, int8 gate: {int8_ok}, v4 against "
             f"fp32: {v4_ok}")

    # ---------------------------------------------------- 4. serving path
    clf = build_classifier("E", gen=torch.Generator().manual_seed(0)) \
        .to(dev).requires_grad_(False)
    x_cal = images(512)
    x_clean = images(256)
    x_req = torch.cat([x_clean, noisy(x_clean)])
    kd = kernels[V3]
    xd_cal = images(256, kd)
    xd_clean = images(128, kd)
    xd_req = torch.cat([xd_clean, noisy(xd_clean, gd)])
    # the 64x64 model: a two-class classifier (seeded), requests as uint8
    kc = kernels[V4]
    clf_c = build_classifier("E", num_classes=2,
                             image_shape=ccfg.image_shape,
                             gen=torch.Generator().manual_seed(1)) \
        .to(dev).requires_grad_(False)
    def as_uint8(x):
        return (x * 255.0).round().to(torch.uint8)

    xc_cal = as_uint8(images(256, kc))     # calibrated as it is served
    xc_clean = images(128, kc)
    xc_req = as_uint8(torch.cat([xc_clean, noisy(xc_clean, gc)]))
    build.reset_launches()
    serving = {}

    def serve(label, model, cal, req, n_clean, loss_max, clf=clf, **kw):
        pipe = DefendedPipeline(model, clf, fpr=0.05, **kw)
        t0 = time.perf_counter()
        pipe.calibrate(cal)
        out = pipe.predict(req)
        torch.cuda.synchronize()
        clean_loss = float(out.rec_err[:n_clean].mean())
        serving[label] = dict(
            path=model.last_kernel, s=time.perf_counter() - t0,
            clean_mean_loss=clean_loss,
            noisy_mean_loss=float(out.rec_err[n_clean:].mean()),
            flag_rate_clean=float(out.flagged[:n_clean].mean()),
            flag_rate_noisy=float(out.flagged[n_clean:].mean()),
            finite=bool(np.isfinite(out.rec_err).all()))
        if not serving[label]["finite"] or clean_loss > loss_max:
            fail(f"serving {label}: {serving[label]}")

    for label, kw in (("auto", dict(rec_kernel="auto")),
                      ("pallas_int8", dict(rec_kernel="pallas_int8")),
                      ("encoder", dict(rec_kernel="auto",
                                       rec_init="encoder"))):
        serve(label, gan, x_cal, x_req, 256, CLEAN_LOSS_MAX, **kw)
    # the deep model has seeded weights: its clean requests G(z) must
    # project to a lower loss than an unrelated latent scores on them
    with torch.no_grad():
        deep_unrelated = float(rec_losses(
            apply_s2d, torch.randn(128, k, device=dev, generator=gd),
            rows_s2d(xd_clean, 1)).mean())
    serve("deep_auto", deep, xd_cal, xd_req, 128, deep_unrelated,
          rec_kernel="auto")
    serving["deep_auto"]["unrelated_latent_loss"] = deep_unrelated
    v3_after_pipeline = build.LAUNCHES[V3]
    with torch.no_grad():
        celeba_unrelated = float(rec_losses(
            apply_v4, torch.randn(128, k, device=dev, generator=gc),
            rows_v4(xc_clean, 1)).mean())
    serve("celeba_pallas_v4", celeba, xc_cal, xc_req, 128, celeba_unrelated,
          clf=clf_c, rec_kernel="pallas_v4")
    serving["celeba_pallas_v4"]["unrelated_latent_loss"] = celeba_unrelated
    v4_after_pipeline = build.LAUNCHES[V4]
    # a direct call at a batch the kernels' 64-row tile does not divide
    # (100 images x R 10 = 1000 rows) still runs the requested kernel;
    # on the deep model pallas_int8 runs the bf16 v3 (there is no int8
    # deep loop) and packed the plain s2d path; on the 64x64 model
    # pallas_v4 runs v4 and auto the generic path (v4 is opt-in); the deep
    # model through pallas_v4 is v4's two-level edge case
    limits = {id(gan): (g, CLEAN_LOSS_MAX), id(deep): (gd, deep_unrelated),
              id(celeba): (gc, celeba_unrelated)}
    for label, model, x100, kernel, path, counter in (
            ("direct_pallas", gan, x_clean[:100], "pallas", "pallas",
             "fused_projection_v2"),
            ("direct_pallas_int8", gan, x_clean[:100], "pallas_int8",
             "pallas_int8", "fused_projection_v2i"),
            ("deep_direct_pallas", deep, xd_clean[:100], "pallas", "pallas",
             V3),
            ("deep_direct_pallas_int8", deep, xd_clean[:100], "pallas_int8",
             "pallas", V3),
            ("deep_direct_packed", deep, xd_clean[:100], "packed", "packed",
             None),
            ("deep_direct_pallas_v4", deep, xd_clean[:100], "pallas_v4",
             "pallas_v4", V4),
            ("celeba_direct_pallas_v4", celeba, xc_clean[:100], "pallas_v4",
             "pallas_v4", V4),
            ("celeba_direct_auto", celeba, xc_clean[:100], "auto", "xla",
             None)):
        before = dict(build.LAUNCHES)
        gen_m, loss_max = limits[id(model)]
        res = model.reconstruct(x100, gen_m, kernel=kernel)
        torch.cuda.synchronize()
        rose = {n: build.LAUNCHES[n] - before[n] for n in kernels}
        serving[label] = dict(
            path=model.last_kernel, clean_mean_loss=float(res.loss.mean()),
            finite=bool(torch.isfinite(res.x_hat).all()),
            shape=list(res.x_hat.shape), launched=rose)
        if model.last_kernel != path or not serving[label]["finite"] \
                or float(res.loss.mean()) > loss_max \
                or res.x_hat.shape != x100.shape \
                or rose != {n: int(n == counter) for n in kernels}:
            fail(f"{label}: {serving[label]}")
    # the random-audit cascade on the flagship (trained weights): cheap
    # serve on everything, the full budget on a seeded random tenth
    audited = AuditedPipeline(
        DefendedPipeline(gan, clf, rec_rr=2, rec_iters=50,
                         rec_init="encoder"),
        DefendedPipeline(gan, clf), audit_prob=0.1)
    t0 = time.perf_counter()
    audited.calibrate(x_cal)
    out = audited.predict(x_req)
    torch.cuda.synchronize()
    a = out.audited
    serving["audited"] = dict(
        s=time.perf_counter() - t0, audited=int(a.sum()), of=int(a.size),
        flag_rate=float(out.flagged.mean()),
        serve_clean_mean_loss=float(out.serve.rec_err[:256].mean()),
        audit_ran=out.audit is not None)
    if not a.any() or out.audit is None \
            or not np.array_equal(out.pred[a], out.audit.pred) \
            or not np.array_equal(out.flagged[a],
                                  out.serve.flagged[a] | out.audit.flagged) \
            or not np.array_equal(out.pred[~a], out.serve.pred[~a]) \
            or not np.isfinite(out.audit.rec_err).all():
        fail(f"audited pipeline: {serving['audited']}")
    launches = dict(build.LAUNCHES)
    with torch.no_grad():
        unrelated = float(rec_losses(
            apply_bf, torch.randn(256, k, device=dev, generator=g),
            rows_flat(x_clean, 1)).mean())
    emit("serving", **serving, launches=launches,
         clean_loss_max=CLEAN_LOSS_MAX, unrelated_latent_loss=unrelated)
    if serving["auto"]["path"] != "pallas" or \
            serving["pallas_int8"]["path"] != "pallas_int8" or \
            serving["deep_auto"]["path"] != "pallas" or \
            serving["celeba_pallas_v4"]["path"] != "pallas_v4" or \
            v3_after_pipeline <= 0 or v4_after_pipeline <= 0:
        fail(f"dispatch: {serving}")
    if not all(launches[name] > 0 for name in kernels):
        fail(f"a kernel of the main path never launched: {launches}")

    # ------------------------------------------------------- 5. timing
    timing = {}
    for name, kk in kernels.items():
        pack = kk["pack"]
        b, n = kk["b"], kk["b"] * kk["rr"]
        x_img = images(b, kk)
        x_rep = kk["rows"](x_img, kk["rr"])
        z0 = torch.randn(n, k, device=dev, generator=kk["gen"])
        inputs[name] = (x_rep, z0)
        xp = kk["plain_x"](x_rep)
        # v4's plain version takes tens of seconds a call: one timed run
        plain_repeats = 1 if name == V4 else 3
        t = dict(
            images=b, rr=kk["rr"], rows=n,
            ms=median_ms(lambda: kk["run"](pack, x_rep, z0, **loop_kw)),
            plain_ms=median_ms(lambda: kk["plain"](pack, xp, z0, **loop_kw),
                               plain_repeats),
            plain_repeats=plain_repeats,
            library_ms=median_ms(lambda: kk["library"](pack, xp, z0,
                                                       **loop_kw)),
            recon_ms=median_ms(lambda: kk["gan"].reconstruct(
                x_img, kk["gen"], kernel=kk["request"])))
        t["recon_per_s"] = b / (t["recon_ms"] / 1e3)
        t.update(bounds_v3(deep.generator, pack, n, iters) if name == V3
                 else bounds_v4(celeba.generator, pack, n, iters)
                 if name == V4 else bounds(name, pack, n, iters))
        timing[name] = t
        if name in ROW_WISE:
            # the yardstick computes the same function: one step of it
            # against the plain version on the timed inputs' first rows
            # (median row within 10% of its step: it rounds elsewhere)
            one = dict(rec_iters=1, rec_lr=lr, momentum=mom)
            e = row_errors(kk["library"](pack, xp[:512], z0[:512], **one),
                           kk["plain"](pack, xp[:512], z0[:512], **one),
                           z0[:512])
            t["library_vs_plain_L1_row_rel_p50"] = e["row_rel_p50"]
            if e["row_rel_p50"] > 1e-1:
                fail(f"the {name} library loop is another function: {e}")
        if name == V4:
            # the fp32 generic path (autograd through the generator's own
            # transpose convs) on the same images: one run after a warm-up
            t["fp32_xla_recon_ms"] = median_ms(
                lambda: celeba32.reconstruct(x_img, gc, kernel="xla"), 1)
            t["fp32_xla_recon_per_s"] = b / (t["fp32_xla_recon_ms"] / 1e3)
            # and in the model's own bf16, which is what `auto` serves
            t["bf16_xla_recon_ms"] = median_ms(
                lambda: celeba.reconstruct(x_img, gc, kernel="xla"), 1)
            t["bf16_xla_recon_per_s"] = b / (t["bf16_xla_recon_ms"] / 1e3)
            t["pack_s"] = pack_v4_s
    x_rep, z0 = inputs["fused_projection_v2"]
    fp32_ms = median_ms(lambda: dense_loop_plain(
        p32, F.pad(x_rep, (0, pdim - x_rep.shape[1])), z0, **loop_kw))
    emit("timing", iters=iters, **timing, fp32_plain_ms=fp32_ms,
         fp32_plain_recon_per_s=big["b"] / (fp32_ms / 1e3))

    # ------------------------------------------------ 6. white-box path
    whitebox_phase(build)

    # ---------------------------------- 7. training, 8. the black-box path
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        training_phase(build, tmp)
        blackbox_phase(build, tmp)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "phases_7_8", "s": time.perf_counter() - t0}),
          flush=True)

    # ------------------------------------------- 9. several devices
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        parallel_phase(build, gan, tmp)
    print(json.dumps({"phase": "phase_9", "s": time.perf_counter() - t0}),
          flush=True)

    # ---------------------------------- 10. the experiments' kernels
    t0 = time.perf_counter()
    experiments = experiments_phase(build, deep, timing[V3])
    print(json.dumps({"phase": "phase_10", "s": time.perf_counter() - t0}),
          flush=True)

    # ---------------------------------------- 11. the compile probes
    t0 = time.perf_counter()
    probes = probes_phase(build, deep)
    print(json.dumps({"phase": "phase_11", "s": time.perf_counter() - t0}),
          flush=True)

    # ------------------------------------------------- 12. kernels line
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": kk["source"],
         "replaces": kk["replaces"], "launches": launches[name],
         "max_abs_err": max(errs[name].values()),
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"],
         "library_ms": timing[name]["library_ms"]}
        for name, kk in kernels.items()] + experiments + probes}
    RECORD["kernels"] = line
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RECORD, f, indent=1)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
