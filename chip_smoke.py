#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits non-zero on failure:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``mcgm_tpu_torch/csrc/*.cu`` for sm_90a, with ptxas's report
   and, where ``cuobjdump`` is installed, the count of tensor-core
   instructions (HMMA / HGMMA) in each library's SASS (0 fails the run);
3. kernel: each hand-written kernel against its plain PyTorch version at the
   main path's shapes (full chunk and tail chunk) and at other shapes it
   takes, under a stated tolerance, timed at the main path's shapes beside its
   plain version, a cuDNN yardstick (also timed by parts) and its bound; then
   its gradient (plain VJP) against the plain version's autograd gradient;
4. slice: the 128px MCGAN (CelebA-HQ / ImageNet protocol) at full width and
   depth, random weights from seed 0, driven as a user would: ``build_model``,
   ``Sampler.sample_chunked`` over the class sweep in chunks of 128, then
   ``discriminate``; launch counts are zeroed just before that run and read
   just after; one chunk is held against the same model run f32 through the
   plain versions;
5. train: the CIFAR10 MCGAN GAN step at full width and depth with
   ``bench.py``'s protocol (``mcgm_tpu_torch.bench.train_gan``: B=128, Adam,
   5 D updates and 1 G update, fused D pass, hinge), 3 warm-up and 10 timed
   steps through the kernels and as many through the plain versions, in turns
   (kernel, plain, plain, kernel); launch counts are zeroed just before each
   timed run and read just after (6 launches per step through the kernels, 0
   through the plain versions); then one step from the same state and z on
   both paths, losses and the first D update's gradients held within
   ``5e-2 * max|plain|``;
6. trainer: the CIFAR10 MCGAN trained as a user would,
   ``python -m mcgm_tpu_torch.cli.train`` through ``cli.train.main`` at full
   width and depth, on a CIFAR10-shaped dataset (50,000 + 10,000 seeded
   uint8 images written as ``CIFAR10/processed/{train,test}.npz``) with
   seeded random InceptionV3 weights written as
   ``inception/inception_v3.pkl``: 2 epochs of 20 steps, each with the full
   10,000-image fixed-z eval (InceptionV3 at 299x299, IS / FID) and a
   checkpoint copied to ``_best``; then a second run with ``resume_mode=1``
   to epoch 3, whose resumed state (parameters, buffers, optimizer moments,
   schedulers, logger history) must equal the saved one. ``first_dblock``
   must launch 6 times per step. 64 images' InceptionV3 features on the
   card are held against the same network's f32 features on the CPU within
   ``INCEPTION_TOL * max|cpu|``;
7. cgan: the CIFAR10 CGAN train step at ``bench.py``'s shapes and full width
   (G 256x4, D 128x4, latent 128, embedding 32, 10 modes, B=128, 5 D
   updates and 1 G update, fused D pass, hinge, Adam 2e-4 with betas (0.0,
   0.9), bf16 operands): 3 warm-up and 10 timed steps, images/s; its first
   D-block has 3 + 32 input channels and runs as plain cuDNN convolutions,
   so ``first_dblock`` must launch 0 times; one step from the same state and
   z held against the same model run f32, losses and the first D update's
   gradients within ``TRAIN_TOL * max|f32|``; the device's busy share of one
   step from ``torch.profiler`` (after every timed phase);
8. real: the real UCI digits of ``tests/fixtures/real_digits_shard.npz``
   (32x32x1) written as the raw MNIST files a user places (gzipped IDX
   under ``MNIST/raw/``, 1,297 train / 500 test) and packed by the port's
   MNIST packer into ``MNIST/processed/{train,test}.npz``, bit-equal to the
   fixture's split, the packing timed;
   the classifier trained on them through ``cli.train.main`` (it becomes the
   IS / FID feature model) and re-evaluated from ``_best`` through
   ``cli.test_model.main``; then MCGAN and CGAN at the MNIST configuration's
   full width (G [512,256,128,64], D [64,128,256,512], latent 128, B=128)
   trained through ``cli.train.main`` with IS / FID every epoch, side by
   side. ``first_dblock`` (its 1-channel, 64-wide instantiation) must
   launch 6 times per MCGAN step and 0 times in the CGAN run;
9. workflows: ``cli.sample`` on both real-digit ``_best`` checkpoints:
   ``generate`` with ``save_npy`` (the 10 x 1000 sweep and its grid) and
   without (grids), ``transit`` (an 11 x 10 grid), ``create`` at 10, 50 and
   100 modes and with ``save_npy``; images/s per workflow; every dump
   finite and in [0, 255], every PNG read back with the port's own decoder
   and its size checked against its grid; 0 ``first_dblock`` launches.

10. vq: the VQ-VAE's two kernels against their plain versions (f32 on the
    card): ``vq_assign`` at N = 8,192 (a train batch's 128 x 8 x 8 codes)
    on random rows and on a full-width VQ-VAE train step's own rows and
    codebook after 13 steps, and 32,768 (an eval batch), all three timed;
    a ragged 17 x 64, N = 1, a codebook with every column twice (ties go to
    the lower code), rows at the midpoint of two codes moved by 0 to 30
    times the TF32 rounding of the cross term (near ties), rows and
    codebook scaled by 30, D 256, a tiny codebook, and D 12 (the ``ffma``
    kernel), the ties, near ties and D 256 again at N = 32,768 (several
    tiles per block), checked against float64 distances within
    ``VQ_MARGIN``, two launches bit-equal, each line naming the kernel the C
    entry point chose (``variant``) and the rows that the ``tf32`` kernel
    decided in f32, against every code (``rows_rescored``) and by their two
    best codes (``rows_paired``); ``vq_ema`` on
    the rows and codes of a full-width VQ-VAE train step after 13 steps
    (which fall on a few codes: the main path's traffic), and at N = 8,192 with the codes
    spread, with a row mask and collapsed onto three, ragged and N = 1
    (cluster sizes bit-equal, the rest within ``EMA_TOL`` of each code's
    column; two launches on the same inputs bit-equal); each timed beside
    its plain version, a PyTorch yardstick and its bound (run after the
    first D-block's checks, before the slice); the kernels' own device
    times from ``torch.profiler`` after every timed phase (``vq_ema``: the
    sum of its three kernels per call, each one's, and the span of a call
    from its first kernel's start to its last one's end; its count is
    of kernel launches, three a call);
11. vae: MCVAE and CVAE at the CIFAR10 configuration's full width (hidden
    [64, 128, 256], latent 128, 2 residual blocks) on the trainer's
    CIFAR10-shaped files through ``cli.train``: 2 epochs of ``VAE_STEPS``
    steps, each evaluated on the whole train split (BCE), ``resume_mode=1``
    to epoch 3 with the state checked equal, ``cli.test_model``, and the
    five ``cli.sample`` calls of phase 9 on ``_best``; no hand kernel runs;
12. vqvae: the CIFAR10 VQ-VAE (hidden [128, 128], D 64, K 512, B=128) step
    through the kernels and through the plain versions in turns (2 launches
    per step: one search, one EMA update), one step of each from the same
    state held to the other (loss, equal codes, the three buffers), one
    eval batch (1 search), then ``cli.train`` for 2 epochs of ``VAE_STEPS``
    steps (MSE per epoch; one search per eval batch); one step of each path
    under ``torch.profiler`` at the end (``vqvae profile:``);
13. real (continued): MCVAE, CVAE and VQ-VAE on the real digits at the
    MNIST configuration's width, ``REAL_VAE_EPOCHS`` epochs each, BCE / MSE
    per epoch.
14. mc_gated_matmul (after the VQ kernels' checks): the PixelCNN's gated
    1x1 product against its plain version at the sampler's shapes (1,000
    grids at one position: the head, N = 512 with ReLU, and the residual,
    N = 128) and an eval batch's (512 grids x 64 positions), all four timed
    (device time from ``torch.profiler`` at the end, the wrapper, the plain
    version, the cuBLAS yardstick, the bound); the digits' ragged batch,
    K 64 and N 200, M = 1, a soft indicator, the Pallas form, no gate, f32
    operands, K 96 with P 16 (the generic bf16 kernel), 100 modes, and
    1,000 and 1,200 grids x 64 positions (many tiles of two samples per
    block of the wide kernel) checked, each line
    naming the kernel the C entry point chose (``variant``); its gradient
    against the plain version's autograd;
15. pixelcnn (before ``vqvae:``'s folder is removed): MCPixelCNN and
    CPixelCNN at full width (15 layers, hidden 128, 512 codes, 10 modes,
    B=128) on the codes of ``vqvae:``'s ``_best``, through ``cli.train``: 2
    epochs of ``PIXELCNN_STEPS`` steps, ``resume_mode=1`` to epoch 3 with
    the state checked equal, ``cli.test_model``; one eval batch of 512 (16
    launches); a sampler chunk of 1,000 grids incrementally through the
    kernel (1,024 launches), through its plain version and by full
    re-forward, grids/s each; in f32 the two samplers' codes equal on 16
    grids (a code may differ only where the draw's top two are within
    ``EXACT_MARGIN``), in bf16 the sampler's logits within ``SLICE_TOL`` of
    an f32 forward; the five ``cli.sample`` calls; one chunk under
    ``torch.profiler`` at the very end (``pixelcnn profile:``);
16. real (continued): MCPixelCNN and CPixelCNN on the codes of the real
    digits' VQ-VAE, ``REAL_PIXELCNN_EPOCHS`` epochs each, NLL per epoch side
    by side, one ``generate`` grid each.
17. glow (after ``pixelcnn:``, on the CIFAR10-shaped files): MCGlow and
    CGlow at the CIFAR10 width (hidden 512, K 16, L 3, affine, LU, 10
    modes, B=128, bf16 convs, ``remat_flows``) from seed 0: DDI on 8
    seeded batches, then 3 + 10 steps through ``mc_gated_matmul`` and
    through its plain version in turns from the DDI'd state and one noise
    draw (images/s, bits/dim; 96 launches a step: 48 in the forward, 48 in
    the recompute; and 48 of the backward kernel), the first run of each path held to the other (bits/dim
    and every parameter within ``TRAIN_TOL * max|plain|``); one eval batch
    of 512 (48 launches); the eval forward with random zero convs held to
    its plain version (``SLICE_TOL``); ``reverse(forward(x))`` against x
    within ``GLOW_RECON_TOL``; ``generate`` samples/s over a sweep of
    ``GLOW_SWEEP`` in chunks of ``GLOW_CHUNK`` (median of 3); then
    ``cli.train`` for 2 epochs of ``GLOW_STEPS`` steps (DDI first, each
    epoch evaluated on ``GLOW_EVAL_BATCHES`` batches), ``resume_mode=1`` to
    epoch 3 with the state checked equal, and ``cli.test_model``; one step
    of each path under ``torch.profiler`` at the end (``glow profile:``:
    launches a step, busy share, category ms). ``mc_gated_matmul``'s
    checks (phase 14) gain Glow's three shapes on the wide kernel, timed
    (beside the generic kernel's recorded times, constants), with and
    without the gate, the wide kernel's other shapes (K below 512, N not a
    multiple of 128, P 32 and 192), the widened backward (``dalpha``,
    ``dbeta``), and the backward kernel at the three levels, timed, and at
    the other shapes, each against the plain f32 backward;
18. real (continued): MCGlow and CGlow on the digits, ``REAL_GLOW_EPOCHS``
    epochs each, bits/dim per epoch side by side, and the five
    ``cli.sample`` calls of phase 9 on each ``_best``.
19. scores cifar10 (after ``glow:``, in the trainer's folder): ``cli.make_stats
    stats`` over the 50,000 CIFAR10-shaped train images through the seeded
    InceptionV3 at full width, a 10,000-image ``generate --save_npy true``
    dump of the trainer's MCGAN ``_best``, ``cli.test_generated generated``
    on it (IS in 10 splits, FID against the stats file) and again against a
    fresh sweep of the train split; seconds and images/s per step; scores
    finite, 0 kernel launches.
20. scores real (after phase 18): ``cli.make_stats stats`` on the digits
    (the classifier's features), then for each of the eight generative
    models' ``_best`` (MCGAN, CGAN, MCVAE, CVAE, MCPixelCNN, CPixelCNN,
    MCGlow, CGlow) its ``generated_`` and ``created_`` dumps (drawn where no
    earlier phase drew them: the VAEs' and PixelCNNs', which launch
    ``mc_gated_matmul``) scored by ``cli.test_generated generated`` and
    ``created``; ``report.process`` (``processed_result.json``), ``make_vis``
    (``vis.sh``) and the learning curves' JSON; the paper's table, one row
    per family, MC beside C: generated IS and FID, created DBI. Every score
    finite, every cell and result file present.
21. gan fused g pass (after ``train:``): the CIFAR10 MCGAN step with
    ``fuse_g_pass``, ``remat`` and both from one state and z: ``remat``
    against the plain step and against ``fuse_g_pass`` alone (losses,
    parameters, BatchNorm statistics, ``u`` within ``TRAIN_TOL``), the fused
    pass's fakes against the plain step's (``KERNEL_TOL``), the fused step
    against the plain one fed those fakes; images/s, ``first_dblock``
    launches a step (6; 12 under ``remat``: each recomputed D pass launches
    it again), peak memory;
22. glow reversible (after ``glow:``): MCGlow and CGlow at the CIFAR10
    width: images/s, ``mc_gated_matmul`` launches a step and peak memory
    with no remat, ``remat_flows`` and ``reversible_flows``; one step with
    ``remat_flows`` against one with ``reversible_flows`` from the state 13
    steps reached (bits/dim and gradients within ``TRAIN_TOL``, each
    rebuilt flow input within ``GLOW_RECON_TOL``); the rebuild's error with
    random zero convs, reported;
23. remat single: the VAE, VQ-VAE, PixelCNN and classifier steps with
    ``remat`` against without (``vq_ema`` still 3 launches a step), peak
    memory for each;
24. preempt: the classifier trainer stopped by its own SIGTERM at a step
    checkpoint and resumed with ``resume_mode=1``, bit-equal to an
    uninterrupted run (cuDNN deterministic for the phase);
25. reference import: a reference-keyed ``state_dict`` for each of the ten
    models at the CIFAR10 width converted, loaded on the card and on the
    CPU, and one pass of each held to the other.

26. export (after ``vae:``; the Glow and PixelCNN artifacts exported by a
    process started with the script, niced, tracing on the host): ``int8_quantize`` and
    ``int8_conv`` against their plain versions at every shape the
    CIFAR10-width GAN and VAE generators give them (Dense 128 / 160 -> 4,096,
    the embedding 10 -> 32, the up2 convs into 8, 16 and 32 px, the 3x3 at
    8, 16, 32 and 4 px, the 1x1 at 4, 8 and 16 px, the transposed convs
    256 -> 128 -> 64 -> 3) at B = 1, 5 and 64, dynamic and static, bf16 out
    (and f32 at B = 5), and at the variants no generator shape reaches
    (``INT8_EXTRA_CASES``: the narrow kernel on a direct 3x3, the byte-load
    one where the wide kernel's TMA stores cannot take the output) in both
    dtypes, each record naming the kernels' variants; f32 examples of 4 MB
    through the quantizer's ``stream`` kernel, and a NaN through each
    quantizer kernel: int8 values and scales equal, outputs within one unit
    of the output dtype; MCGAN and CVAE exported as bf16, ``int8``
    and ``int8_static`` (after ``calibrate_int8``) artifacts, MCGlow and
    MCPixelCNN as bf16 ones, at the CIFAR10 width, each saved, loaded in a
    process that imports only torch and ``kernels.ops`` and run at two
    batch sizes (the PixelCNN's at one): equal to the live sampler; then,
    that process ended, the GAN and VAE artifacts' images/s at
    ``SERVE_BATCH`` with the int8 kernels' launches per call (counts zeroed
    just before the call) and max / mean |d| of the int8 images against
    the bf16 artifact's; ``int8_conv`` timed at five shapes and
    ``int8_quantize`` at one, at ``SERVE_BATCH``, each held to its plain
    version there, beside im2col + ``torch._int_mm``, cuDNN's bf16 conv
    and the bound (over the taps that read the input).

The last lines are the script's wall time, the card's name and power limit
as ``nvidia-smi`` gives them, one JSON object listing every kernel, and
``{"ok": true, "device": {...}}``. With ``--profile DIR`` one more G->D pass,
one more train step, one more trainer epoch and one chunk of its eval sweep
run under ``torch.profiler`` after the checks. There
is no CPU path: without a card the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import contextlib
import copy
import functools
import gzip
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mcgm_tpu_torch.bench import train_gan
from mcgm_tpu_torch.bench.int8_cases import (INT8_BATCHES, INT8_CASES, INT8_EXTRA_CASES,
                                             INT8_TIMED, SERVE_BATCH)
from mcgm_tpu_torch.cli import make_stats as cli_make_stats
from mcgm_tpu_torch.cli import sample as cli_sample
from mcgm_tpu_torch.cli import test_generated as cli_test_generated
from mcgm_tpu_torch.cli import test_model as cli_test_model
from mcgm_tpu_torch.cli import train as cli_train
from mcgm_tpu_torch.config import process_control
from mcgm_tpu_torch.data.datasets import (_DIGITS, _MNIST_FILES, _pack_mnist_like,
                                          _save_processed, fetch_dataset)
from mcgm_tpu_torch.evals.inception import InceptionV3, inception_feature_fn
from mcgm_tpu_torch.io import export as io_export
from mcgm_tpu_torch.io.checkpoint import to_numpy
from mcgm_tpu_torch.io.images import read_png
from mcgm_tpu_torch.io.jax_import import to_jax_inception
from mcgm_tpu_torch.kernels import build
from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.kernels import int8 as kint8
from mcgm_tpu_torch.kernels import mc_gate as kmc
from mcgm_tpu_torch.kernels import vq as kvq
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.models.pixelcnn import draw_uniforms, sample_codes, sample_codes_incremental
from mcgm_tpu_torch.ops import quant
from mcgm_tpu_torch.ops.layers import batch_stat_slices, fold_pool
from mcgm_tpu_torch.report import learning_curve
from mcgm_tpu_torch.report import process as report_process
from mcgm_tpu_torch.report.logger import Logger
from mcgm_tpu_torch.train.loop import apply_family_overrides
from mcgm_tpu_torch.train.optim import make_optimizer
from mcgm_tpu_torch.train.state import TrainState, make_gan_train_step, make_train_step
from mcgm_tpu_torch.utils import card_name_and_limit, save, vis_path
from mcgm_tpu_torch.workflows.generate import class_sweep
from mcgm_tpu_torch.workflows.sampling import Sampler

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12
KERNEL_TOL = 2e-2  # max|kernel - plain| <= KERNEL_TOL * max|plain|, both bf16 out
SLICE_TOL = 5e-2   # max|bf16 path - f32 plain path| <= SLICE_TOL * max|f32 plain path|
TRAIN_TOL = 5e-2   # kernel path vs plain path, one train step: losses, first D gradients
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
NUM_MODE = 20
DEV = torch.device("cuda")
TENSOR_CORE_KERNELS = ("first_dblock", "mc_gated_matmul", "vq_assign", "int8_conv")
INCEPTION_TOL = 1e-3  # max|card - cpu| <= INCEPTION_TOL * max|cpu|, both f32
TRAINER_STEPS, TRAINER_EPOCHS = 20, 2
TRAINER_IMAGES = {"train": 50_000, "test": 10_000}  # CIFAR10's splits
CIFAR10_CLASSES = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
                   "ship", "truck"]
REAL_DIGITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "real_digits_shard.npz")
REAL_TRAIN = 1297  # the rest of the 1,797 digits is the test split
# the real digits' depth is the first cut when the script nears its time
# limit: the two GANs and the two Glows took ~90 s and ~140-165 s at 20 and
# 10 epochs (H100 80GB HBM3, 700 W), now half of that
CLASSIFIER_EPOCHS, REAL_GAN_EPOCHS = 10, 10
# VQ kernels: two codes whose float64 distances are closer than VQ_MARGIN *
# (|x|^2 + max|e|^2) cannot be told apart by f32 sums in another order;
# EMA sums of rows in another order within EMA_TOL * max|plain|
VQ_MARGIN, EMA_TOL = 1e-5, 1e-5
# near ties for vq_assign: rows whose two best codes differ by these
# multiples of the cross term's TF32 rounding, 2 * 2^-10 |x| max|e| of the two
NEAR_TIE_FACTORS = (0.0, 1e-3, 0.03, 0.3, 1.0, 3.0, 10.0, 30.0)
# one VQ-VAE step through the kernels vs the plain versions: the loss within
# VQ_STEP_TOL * |plain|, the buffers within VQ_STEP_TOL of each code's column
# (column_errors), at least VQ_CODES_EQUAL of the codes equal (a code may flip
# where two are closer than the margin)
VQ_STEP_TOL, VQ_CODES_EQUAL = 1e-2, 0.99
VAE_STEPS, REAL_VAE_EPOCHS = 20, 10
# mc_gated_matmul with f32 operands against its plain version: f32 sums in
# another order (bf16 operands: KERNEL_TOL)
MC_TOL_F32 = 1e-5
# the PixelCNN's sampler chunk, and the f32 exactness check on the card: the
# incremental sampler and sample_codes may differ only at a position whose
# two best values of logits + Gumbel are closer than EXACT_MARGIN (the two
# compute the same logits with f32 sums in other orders)
SAMPLE_CHUNK, EXACT_GRIDS, EXACT_MARGIN = 1000, 16, 1e-3
# the PixelCNN trainer on the CIFAR10-shaped files: its eval cut to the
# first PIXELCNN_EVAL_BATCHES batches of the train split (the whole split is
# 391 batches of ~25 ms of host time each)
PIXELCNN_STEPS, PIXELCNN_EVAL_BATCHES, REAL_PIXELCNN_EPOCHS = 20, 40, 10
# Glow at the CIFAR10 width (hidden 512, K 16, L 3): its coupling nets' 1x1
# at P = 256, 64, 16 positions (levels 1-3), 48 launches per forward; the
# trainer cut to GLOW_STEPS steps per epoch, each evaluated on the first
# GLOW_EVAL_BATCHES batches of the train split; reverse(forward(x)) within
# GLOW_RECON_TOL of x (f32 flows, bf16 coupling nets run the same both ways);
# generate timed over a sweep of GLOW_SWEEP in chunks of GLOW_CHUNK
GLOW_POSITIONS, GLOW_PER_FORWARD = (256, 64, 16), 48
GLOW_STEPS, GLOW_EVAL_BATCHES, REAL_GLOW_EPOCHS = 20, 8, 5
GLOW_RECON_TOL, GLOW_SWEEP, GLOW_CHUNK = 1e-3, 400, 128
# a Glow's reverse divides by s = sigmoid(log_s + 2), so a sample can
# overflow to NaN (the reference's create filters them): at least this share
# of a 10,000-image dump of a digits Glow is finite
GLOW_FINITE_MIN = 0.5


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ first D-block
def block_inputs(B, H, W, cin, cout, seed):
    """The kernel's arguments as the block's prologue hands them over: NHWC
    bf16 images in [-1, 1], binary mode codes, HWIO weights at the scale SN
    leaves them (w2f the pool fold of a 3x3 kernel), small biases."""
    g = torch.Generator(device=DEV).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEV) * scale

    x = (torch.rand((B, H, W, cin), generator=g, device=DEV) * 2 - 1).to(torch.bfloat16)
    code = (torch.rand((B, cout), generator=g, device=DEV) < 0.5).float()
    w1 = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
    w2 = randn(cout, cout, 3, 3, scale=1 / math.sqrt(9 * cout))
    w2f = fold_pool(w2).permute(2, 3, 1, 0).contiguous()
    w3 = randn(cin, cout, scale=1 / math.sqrt(cin))
    b1, b2, b3 = (randn(cout, scale=0.1) for _ in range(3))
    return [x, code, w1, b1, w2f, b2, w3, b3]


def block_library_chain(args):
    """The same function as a chain of cuDNN bf16 calls: a yardstick of
    what one library call per op costs; the port never calls it. Returns the
    whole chain and its three parts (each a callable)."""
    x, code, w1, b1, w2f, b2, w3, b3 = args
    bf = torch.bfloat16
    cin, cout = w1.shape[2], w1.shape[3]
    w1o, w2o = (w.to(bf).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                for w in (w1, w2f))
    w3o = w3.to(bf).t().reshape(cout, cin, 1, 1).contiguous()
    b1b, b2b, b3b = b1.to(bf), b2.to(bf), b3.to(bf)
    codeb = code.to(bf)[:, :, None, None]
    xc = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory

    def conv1():  # conv3x3 + ReLU + gate: writes h
        return F.conv2d(xc, w1o, b1b, padding=1).relu_().mul_(codeb)

    def conv2(h):  # conv4x4/s2: reads h
        return F.conv2d(h, w2o, b2b, stride=2, padding=1)

    def shortcut():  # avgpool + conv1x1
        return F.conv2d(F.avg_pool2d(xc, 2), w3o, b3b)

    def run():
        return conv2(conv1()).add_(shortcut())
    h, y = conv1(), run()
    parts = {"conv3x3_relu_gate": conv1, "conv4x4_s2": lambda: conv2(h),
             "shortcut_and_add": lambda: y.add(shortcut())}
    return run, parts


def block_bound(args):
    """(bound_ms, bound_by, flop, bytes): the least time an H100 SXM needs
    to read each input once, write the output once and do the MACs at the
    bf16 tensor-core peak."""
    x, code, w1, _, w2f, _, w3, _ = args
    B, H, W, cin = x.shape
    cout, Ho, Wo = w1.shape[3], H // 2, W // 2
    macs = B * H * W * cout * 9 * cin + B * Ho * Wo * cout * (16 * cout + cin)
    flop = 2 * macs
    nbytes = (x.numel() * 2 + B * Ho * Wo * cout * 2 + code.numel() * 4
              + (w1.numel() + w2f.numel() + w3.numel()) * 2 + 3 * cout * 4)
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flop, nbytes


def check_first_dblock(shape, seed, timed: bool):
    B, H, W, cin, cout = shape
    args = block_inputs(B, H, W, cin, cout, seed)
    y = fd.first_dblock(*args)
    ref = fd.first_dblock_reference(*args)
    torch.cuda.synchronize()
    if y.shape != (B, H // 2, W // 2, cout) or y.dtype != torch.bfloat16:
        raise SystemExit(f"first_dblock gave {tuple(y.shape)} {y.dtype} at {shape}")
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = bool(torch.isfinite(y.float()).all()) and err <= KERNEL_TOL * scale
    rec = {"shape": list(shape), "max_abs_err": err, "max_abs_ref": scale,
           "tolerance": KERNEL_TOL * scale, "ok": ok}
    if timed:
        ops = fd.kernel_operands(*args)  # the kernel alone, on packed operands
        rec["ms"] = cuda_ms(lambda: fd.launch(ops), 20)
        rec["ms_source"] = "CUDA events (the kernel's launch alone, on packed operands)"
        rec["wrapper_ms"] = cuda_ms(lambda: fd.first_dblock(*args), 20)  # with the prologue
        rec["plain_ms"] = cuda_ms(lambda: fd.first_dblock_reference(*args), 10)
        chain, parts = block_library_chain(args)
        rec["library_ms"] = cuda_ms(chain, 20)
        rec["library_parts_ms"] = {k: cuda_ms(f, 20) for k, f in parts.items()}
        rec["bound_ms"], rec["bound_by"], flop, nbytes = block_bound(args)
        rec["tflops"] = flop / rec["ms"] / 1e9
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    log("first_dblock", json.dumps(rec))
    if not ok:
        raise SystemExit(f"first_dblock disagrees with its plain version at {shape}: "
                         f"max|d| {err} > {KERNEL_TOL} * {scale}")
    return rec


def check_first_dblock_grad(shape, seed):
    """The kernel path's gradients (forward: the kernel; backward: the plain
    VJP) against the plain version's own autograd gradients, with respect to
    x and every weight and bias, within KERNEL_TOL * max|plain grad|."""
    args = block_inputs(*shape, seed)
    grad_at = (0, 2, 3, 4, 5, 6, 7)  # every input but code, which gets none
    B, H, W, _, cout = shape
    gy = torch.randn((B, H // 2, W // 2, cout), generator=torch.Generator(device=DEV)
                     .manual_seed(seed + 1), device=DEV).to(torch.bfloat16)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(i in grad_at) for i, a in enumerate(args)]
        return torch.autograd.grad(fn(*leaves), [leaves[i] for i in grad_at], gy)

    before = fd.first_dblock.launches
    got = grads(fd.first_dblock)
    launched = fd.first_dblock.launches - before
    want = grads(fd.first_dblock_reference)
    names = ("x", "w1", "b1", "w2f", "b2", "w3", "b3")
    rec, bad = {"shape": list(shape), "launches": launched}, []
    for name, g, w in zip(names, got, want):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        rec[name] = {"max_abs_err": err, "max_abs_ref": scale}
        if not (torch.isfinite(g).all() and err <= KERNEL_TOL * scale):
            bad.append(name)
    log("first_dblock grad", json.dumps(rec))
    if launched != 1 or bad:
        raise SystemExit(f"first_dblock gradient: {launched} launches, mismatch in {bad}")


def sass_tensor_core_count(name: str) -> dict | None:
    """Counts of the tensor-core instructions (HMMA, HGMMA: bf16 / TF32
    ``mma.sync`` and ``wgmma``; IMMA, IGMMA: their s8 forms) and of FFMA in
    the built library's SASS, or None where ``cuobjdump`` is not
    installed."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
        if tool is None:
            return None
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "HGMMA", "IMMA", "IGMMA", "FFMA")}


# ------------------------------------------------------------------- slice
PHASES = ("generate", "discriminate")
MATMUL_CATEGORY = "matmul (cuBLAS: Dense, SN power iterations)"


def kernel_category(name: str) -> str:
    if "first_dblock" in name:
        return "first_dblock (hand kernel)"
    if "vq_assign_kernel" in name or "vq_ema_kernel" in name:
        return "vq_assign / vq_ema (hand kernels)"
    if "mc_gated_matmul_kernel" in name:
        return "mc_gated_matmul (hand kernel)"
    if "mc_gated_matmul_backward_kernel" in name:
        return "mc_gated_matmul backward (hand kernel)"
    if any(k in name for k in ("xmma", "cudnn", "dgrad", "wgrad", "convolve", "winograd")):
        return "conv (cuDNN)"
    if any(k in name for k in ("gemv", "gemm", "nvjet", "cublas", "dot_kernel", "cutlass")):
        return MATMUL_CATEGORY
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return "optimizer (Adam, multi-tensor)"
    if "upsample" in name:
        return "upsample (G's nearest; the eval's bilinear to 299)"
    return "elementwise, casts, reductions, pooling"


def device_profile(run, spans, out_dir: str, tag: str) -> dict:
    """Run ``run()`` (which returns its host window in seconds) once under
    ``torch.profiler``: device time by kernel and by category, the device's
    busy share of the window, and for each named range in ``spans`` its
    calls, its device span and the device time of the kernels inside it.
    Writes a chrome trace and the full tables to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window_ms = run() * 1e3
    prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))

    # Device-side events: the kernels (and memsets / copies), plus one
    # annotation per named range that spans that range's kernels on the
    # device's timeline. A kernel launched through ctypes has no aten op
    # above it, so only these device-side events see it.
    # Other annotations (torch's own, as ``Optimizer.step#Adam.step``) are
    # neither kernels nor named ranges, and are left out.
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = {}
    for e in dev:
        if e.name in spans:
            ranges.setdefault(e.name, []).append(e.time_range)
    kern = [e for e in dev if e.name not in spans and not getattr(e, "is_user_annotation", False)]
    by_name, by_cat = {}, {}
    span_busy = {n: [0.0] * len(rs) for n, rs in ranges.items()}  # per call of the range
    for e in kern:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + ms, n + 1)
        cat = kernel_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        for name, rs in ranges.items():
            for i, r in enumerate(rs):
                if r.start <= e.time_range.start < r.end:
                    span_busy[name][i] += ms
    kernels = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda k: -k[1])
    busy = sum(ms for _, ms, _ in kernels)
    rec = {"window_ms": window_ms, "device_busy_ms": busy, "device_busy_share": busy / window_ms,
           "kernel_launches": len(kern),
           "span_calls": {n: len(rs) for n, rs in ranges.items()},
           "span_device_ms": {n: sum(r.end - r.start for r in rs) / 1e3
                              for n, rs in ranges.items()},
           "span_device_busy_ms": {n: sum(b) for n, b in span_busy.items()},
           "span_device_busy_ms_per_call": span_busy,
           "category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
           "top_kernels": [{"name": n[:120], "ms": ms, "calls": c} for n, ms, c in kernels[:10]],
           "kernels_by_category": {cat: [{"name": n[:120], "ms": ms, "calls": c}
                                         for n, ms, c in kernels if kernel_category(n) == cat]
                                   for cat in by_cat}}
    with open(os.path.join(out_dir, f"{tag}_profile.json"), "w") as f:
        json.dump(dict(rec, all_kernels=[{"name": n, "ms": ms, "calls": c}
                                         for n, ms, c in kernels]), f, indent=1)
    return rec


def profile_pass(g_then_d, out_dir: str) -> dict:
    """One G->D pass of the sweep under ``torch.profiler``, with one range per
    phase (``generate`` / ``discriminate``)."""
    host = {}

    def run():
        _, _, host["generate_s"], t_gd = g_then_d(7, annotate=True)
        return t_gd

    rec = device_profile(run, PHASES, out_dir, "slice")
    return dict(rec, generate_window_ms=host["generate_s"] * 1e3)


def run_slice(name_limit: str):
    cfg = process_control({"data_name": "CelebA-HQ", "model_name": "mcgan",
                           "control": {"controller_rate": "0.5"}})
    cfg.update(classes_size=NUM_MODE, init_seed=0)
    t0 = time.perf_counter()
    model = build_model(cfg)  # the card, bf16 operands, f32 parameters
    sampler = Sampler(cfg, model)
    chunk = cfg["batch_size"]["test"]
    C = class_sweep(NUM_MODE, cfg["generate_per_mode"])
    Ct = torch.as_tensor(C, device=DEV)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice: MCGAN 128px, G {cfg['gan']['generator_hidden_size']}, "
        f"D {cfg['gan']['discriminator_hidden_size']}, {NUM_MODE} modes, "
        f"{n_params} parameters, compute {model.compute_dtype}, "
        f"built in {time.perf_counter() - t0:.1f} s; sweep of {len(C)} in chunks of {chunk}")

    def g_then_d(seed, annotate=False):
        span = torch.profiler.record_function if annotate else lambda _: contextlib.nullcontext()
        gen = torch.Generator(device=DEV).manual_seed(seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with span("generate"):
            imgs = sampler.sample_chunked(C, gen, chunk=chunk)
            torch.cuda.synchronize()
        t_g = time.perf_counter() - t
        with span("discriminate"), torch.no_grad():
            logits = torch.cat([model.discriminate(imgs[i:i + chunk], Ct[i:i + chunk])
                                for i in range(0, len(C), chunk)])
            torch.cuda.synchronize()
        return imgs, logits, t_g, time.perf_counter() - t

    g_then_d(1)  # warm-up: cuDNN plans, allocator
    torch.cuda.reset_peak_memory_stats()
    fd.first_dblock.launches = 0
    imgs, logits, t_g, t_gd = g_then_d(0)  # the counted run of the main path
    launches = {"first_dblock": fd.first_dblock.launches}
    d_calls = len(range(0, len(C), chunk))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    times = [g_then_d(2 + i)[2:] for i in range(3)]
    gen_ips = len(C) / statistics.median(t for t, _ in times)
    gd_ips = len(C) / statistics.median(t for _, t in times)
    log(f"slice: counted run {t_g * 1e3:.1f} ms generate, {t_gd * 1e3:.1f} ms G->D; "
        f"launches {launches}")

    bad = []
    if launches["first_dblock"] != d_calls:
        bad.append(f"first_dblock launched {launches['first_dblock']} times in "
                   f"{d_calls} discriminate calls")
    if imgs.shape != (len(C), 128, 128, 3) or logits.shape != (len(C), 1):
        bad.append(f"shapes {tuple(imgs.shape)} {tuple(logits.shape)}")
    if not (torch.isfinite(imgs).all() and torch.isfinite(logits).all()):
        bad.append("non-finite outputs")
    if imgs.abs().max().item() > 1:
        bad.append("images outside [-1, 1]")

    # one chunk against the same weights run f32 through the plain versions
    ref = copy.deepcopy(model).use_plain_kernels()
    ref.compute_dtype = torch.float32
    gen = torch.Generator(device=DEV).manual_seed(3)
    z = sampler.sample_z(chunk, gen)
    C0, C0t = C[:chunk], Ct[:chunk]
    with torch.no_grad():
        img_k = sampler.sample_with_z(C0, z)
        img_r = Sampler(cfg, ref).sample_with_z(C0, z)
        logit_k = model.discriminate(img_r, C0t)
        logit_r = ref.discriminate(img_r, C0t)
    cmp = {}
    for name, got, want in (("images", img_k, img_r), ("logits", logit_k, logit_r)):
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        cmp[name] = {"max_abs_err": err, "max_abs_ref": scale, "std_ref": want.std().item(),
                     "tolerance": SLICE_TOL * scale}
        if not err <= SLICE_TOL * scale:
            bad.append(f"{name}: bf16 kernel path vs f32 plain path max|d| {err} "
                       f"> {SLICE_TOL} * {scale}")
    log("slice vs f32 plain:", json.dumps(cmp))
    result = {"generate_images_per_s": gen_ips, "g_to_d_images_per_s": gd_ips,
              "images": len(C), "chunk": chunk, "peak_mem_gib": peak_gib, "card": name_limit}
    log("slice:", json.dumps(result))
    if bad:
        raise SystemExit("slice failed: " + "; ".join(bad))
    return launches, result, g_then_d


# ------------------------------------------------------------------- train
def _d_grads(ts):
    """The gradients D's optimizer sees at each update, by name."""
    seen = []
    ts.d_opt.register_step_pre_hook(lambda *_: seen.append(
        {n: p.grad.clone() for n, p in ts.model.discriminator.named_parameters()}))
    return seen


def train_kernel_vs_plain(cfg, step, plain_cfg=None) -> dict:
    """One step from the same state, batch and z through the kernels and
    through the plain versions (built from ``plain_cfg`` if given): the
    losses (against the largest of them, since ``Loss`` may be near 0) and
    the first D update's gradients, each within ``TRAIN_TOL * max|plain|``."""
    (ts_k, batch) = train_gan.bench_state(cfg)
    (ts_p, _) = train_gan.bench_state(plain_cfg or cfg, plain=True)
    g = torch.Generator(device=DEV).manual_seed(5)
    z = [torch.randn((batch["img"].shape[0], ts_k.model.latent_size), generator=g, device=DEV)
         for _ in range(train_gan.D_ITER + 1)]
    seen_k, seen_p = _d_grads(ts_k), _d_grads(ts_p)
    got, want = step(ts_k, batch, z=z), step(ts_p, batch, z=z)
    scale = max(abs(w.item()) for w in want.values())
    rec, bad = {"losses": {}, "grads_worst": None}, []
    for k, w in want.items():
        err = abs(got[k].item() - w.item())
        rec["losses"][k] = {"kernel": got[k].item(), "plain": w.item(), "abs_err": err}
        if not (math.isfinite(got[k].item()) and err <= TRAIN_TOL * scale):
            bad.append(k)
    worst = 0.0
    for n, w in seen_p[0].items():
        err = (seen_k[0][n].float() - w.float()).abs().max().item()
        ref = w.float().abs().max().item()
        if not (torch.isfinite(seen_k[0][n]).all() and err <= TRAIN_TOL * ref):
            bad.append(n)
        if ref > 0 and err / ref >= worst:
            worst, rec["grads_worst"] = err / ref, {"name": n, "max_abs_err": err,
                                                    "max_abs_ref": ref}
    first = [n for n, gr in seen_k[0].items()
             if "FirstDisResBlock_0." in n and not gr.abs().max() > 0]
    if first:
        bad.append(f"first block parameters without gradient: {first}")
    rec["n_grads"] = len(seen_p[0])
    if bad:
        raise SystemExit(f"train: kernel path vs plain path disagree at {bad}: {json.dumps(rec)}")
    return rec


def train_profile(ts, batch, step, out_dir: str) -> dict:
    """One train step (after warm-up) under ``torch.profiler``: the device's
    busy share, the first D-block kernel's forward time, the plain-VJP
    backward of the block (the kernels inside its range) and the categories."""
    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(ts, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    rec = device_profile(run, (fd.BACKWARD_SPAN,), out_dir, "train")
    rec["first_dblock_forward_ms"] = rec["category_ms"].get("first_dblock (hand kernel)", 0.0)
    rec["first_dblock_backward_plain_vjp_ms"] = rec["span_device_busy_ms"].get(fd.BACKWARD_SPAN)
    return rec


def run_train(name_limit: str):
    """The CIFAR10 MCGAN train step at bench shapes, through the kernels and
    through the plain versions in turns; cuDNN may use TF32 for f32 convs, as
    torch allows by default and the bench script runs."""
    cfg = train_gan.bench_config()
    step = make_gan_train_step(train_gan.D_ITER)
    t0 = time.perf_counter()
    states = {plain: train_gan.bench_state(cfg, plain=plain) for plain in (False, True)}
    model = states[False][0].model
    log(f"train: MCGAN CIFAR10, G {cfg['gan']['generator_hidden_size']}, "
        f"D {cfg['gan']['discriminator_hidden_size']}, {cfg['classes_size']} modes, "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"B={cfg['batch_size']['train']}, compute {model.compute_dtype}, d_iter "
        f"{train_gan.D_ITER}, built in {time.perf_counter() - t0:.1f} s")
    runs = {False: [], True: []}
    torch.cuda.reset_peak_memory_stats()
    launches = None
    for plain in (False, True, True, False):
        ts, batch = states[plain]
        res = train_gan.time_steps(ts, batch, step, TRAIN_STEPS, TRAIN_WARMUP)
        if launches is None:  # the counted run of the main path: counts zeroed just before
            launches = {"first_dblock": fd.first_dblock.launches}
        runs[plain].append(res)
        log(f"train {'plain' if plain else 'kernel'}:", json.dumps(res))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    bad = []
    want = {False: train_gan.D_ITER + 1, True: 0}
    for plain, rs in runs.items():
        for r in rs:
            if r["first_dblock_launches_per_step"] != want[plain]:
                bad.append(f"{'plain' if plain else 'kernel'} path: "
                           f"{r['first_dblock_launches_per_step']} launches per step, "
                           f"want {want[plain]}")
            if not all(math.isfinite(v) for v in r["losses"].values()):
                bad.append(f"non-finite losses {r['losses']}")
    if bad:
        raise SystemExit("train failed: " + "; ".join(bad))
    cmp = train_kernel_vs_plain(cfg, step)
    log("train kernel vs plain:", json.dumps(cmp))
    result = {"kernel_images_per_s": [r["images_per_sec"] for r in runs[False]],
              "plain_images_per_s": [r["images_per_sec"] for r in runs[True]],
              "kernel_ms_per_step": [r["ms_per_step"] for r in runs[False]],
              "plain_ms_per_step": [r["ms_per_step"] for r in runs[True]],
              "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP, "batch": cfg["batch_size"]["train"],
              "launches_per_step": runs[False][0]["first_dblock_launches_per_step"],
              "peak_mem_gib": peak_gib, "card": name_limit}
    log("train:", json.dumps(result))
    return launches, result, lambda out_dir: train_profile(*states[False], step, out_dir)


# ----------------------------------------------------------------- trainer
def write_trainer_inputs(work: str) -> tuple[str, str]:
    """A CIFAR10-shaped dataset and seeded random InceptionV3 weights, where
    the trainer's own resolution finds them. Returns (data_dir, output_dir)."""
    data_dir, out_dir = os.path.join(work, "data"), os.path.join(work, "output")
    rng = np.random.default_rng(0)
    for split, n in TRAINER_IMAGES.items():
        img = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        _save_processed(os.path.join(data_dir, "CIFAR10"), split, "label", img,
                        np.arange(n) % 10, CIFAR10_CLASSES)
    # He-scaled convs and unit BatchNorm keep activations O(1) through the net
    g = torch.Generator().manual_seed(0)
    net = InceptionV3()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("conv.weight") or name == "fc.weight":
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) * math.sqrt(2.0 / fan_in))
            elif name == "fc.bias":
                p.zero_()
    save(to_jax_inception(net.state_dict()), os.path.join(out_dir, "inception", "inception_v3.pkl"))
    return data_dir, out_dir


def check_inception_card_vs_cpu(out_dir: str, data_dir: str) -> dict:
    """64 CIFAR-shaped images' features and probabilities through InceptionV3
    on the card against the same weights on the CPU, both f32."""
    path = os.path.join(out_dir, "inception", "inception_v3.pkl")
    with np.load(os.path.join(data_dir, "CIFAR10", "processed", "test.npz")) as z:
        img = torch.from_numpy(z["img"][:64]).float() / 127.5 - 1
    card = inception_feature_fn(path, DEV)(img.to(DEV))
    cpu = inception_feature_fn(path, "cpu")(img)
    rec, bad = {}, []
    for name, got, want in zip(("features", "probs"), card, cpu):
        err = (got.cpu() - want).abs().max().item()
        scale = want.abs().max().item()
        rec[name] = {"max_abs_err": err, "max_abs_ref": scale, "tolerance": INCEPTION_TOL * scale}
        if not (torch.isfinite(got).all() and err <= INCEPTION_TOL * scale):
            bad.append(name)
    log("trainer inception card vs cpu:", json.dumps(rec))
    if bad:
        raise SystemExit(f"trainer: InceptionV3 on the card disagrees with the CPU at {bad}")
    return rec


def _state_mismatch(a, b, path: str = "") -> list:
    """The paths at which two ``Experiment.state_dict`` snapshots (numpy)
    differ: the model, optimizer moments and counts, schedulers, z
    generator and the logger's history."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [p for k in a for p in _state_mismatch(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _state_mismatch(x, y, f"{path}/{i}")]
    if isinstance(a, np.ndarray):
        return [] if isinstance(b, np.ndarray) and np.array_equal(a, b) else [path]
    if isinstance(a, Logger):
        return [] if dict(a.history) == dict(b.history) else [f"{path}.history"]
    return [] if a == b else [path]


def run_trainer(name_limit: str, work: str):
    """The train CLI: 2 epochs, then resume_mode=1 to epoch 3."""
    t0 = time.perf_counter()
    data_dir, out_dir = write_trainer_inputs(work)
    log(f"trainer: wrote CIFAR10-shaped data and InceptionV3 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    incep = check_inception_card_vs_cpu(out_dir, data_dir)
    argv = ["--data_name", "CIFAR10", "--model_name", "mcgan", "--control_name", "0.5",
            "--data_dir", data_dir, "--output_dir", out_dir]
    torch.cuda.reset_peak_memory_stats()
    fd.first_dblock.launches = 0  # the counted run of the trainer path
    t0 = time.perf_counter()
    (exp,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS)],
                            limit_train_batches=TRAINER_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"first_dblock": fd.first_dblock.launches}
    saved = to_numpy(exp.state_dict())

    fd.first_dblock.launches = 0
    t1 = time.perf_counter()
    (exp3,) = cli_train.main(argv + ["--num_epochs", "3", "--resume_mode", "1"],
                             limit_train_batches=TRAINER_STEPS)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t1
    launches3 = fd.first_dblock.launches
    resumed = exp3.resumed or {}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    bad = []
    steps = TRAINER_EPOCHS * TRAINER_STEPS
    if launches["first_dblock"] != 6 * steps:
        bad.append(f"first_dblock launched {launches['first_dblock']} times in {steps} steps")
    if launches3 != 6 * TRAINER_STEPS:
        bad.append(f"resumed run: first_dblock launched {launches3} times")
    if resumed.get("epoch") != 3 or [s["epoch"] for s in exp3.epoch_stats] != [3]:
        bad.append(f"resumed at epoch {resumed.get('epoch')}, ran "
                   f"{[s['epoch'] for s in exp3.epoch_stats]}")
    mismatch = _state_mismatch(saved, resumed["state"]) if resumed else ["nothing resumed"]
    if mismatch:
        bad.append(f"resumed state differs from the saved one at {mismatch[:8]}")
    hist = exp3.logger.history
    scores = {k: hist.get(f"test/{k}", []) for k in ("InceptionScore", "FID")}
    if any(len(v) != 3 or not all(math.isfinite(x) for x in v) for v in scores.values()):
        bad.append(f"IS / FID not finite for 3 epochs: {scores}")
    if not all(math.isfinite(x) for x in hist.get("train/Loss", [math.nan])):
        bad.append("non-finite train loss")
    for kind in ("checkpoint", "best"):
        if not os.path.exists(os.path.join(out_dir, "model", f"{exp.tag}_{kind}.pkl")):
            bad.append(f"no {kind} file")
    stats = exp.epoch_stats + exp3.epoch_stats
    result = {
        "card": name_limit, "steps_per_epoch": TRAINER_STEPS,
        "batch": exp.cfg["batch_size"]["train"], "eval_chunk": exp.cfg["batch_size"]["test"],
        "train_images_per_s": [s["train_images_per_s"] for s in stats],
        # the host's enqueue rate alone: near train_images_per_s, the loop is host-bound
        "host_enqueue_images_per_s": [s["host_enqueue"]["items_per_s"] for s in stats],
        "eval_images": [s["eval_images"] for s in stats],
        "eval_seconds": [s["eval_seconds"] for s in stats],
        "eval_images_per_s": [s["eval_images"] / s["eval_seconds"] for s in stats],
        "real_features_seconds": [s.get("real_features_seconds") for s in stats],
        "test_epoch_seconds": [s["test_epoch_seconds"] for s in stats],
        "checkpoint_snapshot_seconds": [s["checkpoint"]["snapshot_s"] for s in stats],
        "checkpoint_write_seconds": [s["checkpoint"].get("write_s") for s in stats],
        "checkpoint_join_seconds": [s["checkpoint"].get("join_s") for s in stats],
        "run_wall_seconds": [wall, wall3],
        "first_dblock_launches": launches["first_dblock"], "resumed_launches": launches3,
        "launches_per_step": launches["first_dblock"] / steps,
        "inception_score": scores["InceptionScore"], "fid": scores["FID"],
        "peak_mem_gib": peak_gib, "inception_card_vs_cpu": incep,
        "resumed_state_equal": not mismatch,
    }
    log("trainer:", json.dumps(result))
    if bad:
        raise SystemExit("trainer failed: " + "; ".join(bad))
    return launches, result, lambda out_dir: trainer_profile(exp3, out_dir)


def trainer_profile(exp, out_dir: str) -> dict:
    """One more epoch of the finished trainer (20 steps, loader and metric
    fetches included) and one 512-image chunk of its eval sweep (G, resize,
    InceptionV3, moments), each under ``torch.profiler``."""
    def timed(fn):
        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t
        return run

    chunk = exp.cfg["batch_size"]["test"]
    C = np.arange(chunk) % exp.cfg["classes_size"]
    epoch = device_profile(timed(lambda: exp.train_epoch(TRAINER_EPOCHS + 2)),
                           (fd.BACKWARD_SPAN,), out_dir, "trainer_epoch")
    epoch.pop("span_device_busy_ms_per_call")  # 120 calls: in the profile's file
    return {"epoch": epoch,
            "eval_chunk": device_profile(timed(lambda: exp.gan_eval_moments(C, chunk)), (),
                                         out_dir, "trainer_eval_chunk")}


# -------------------------------------------------------------------- cgan
def run_cgan(name_limit: str):
    """The CIFAR10 CGAN train step at bench shapes; its first D-block is plain
    cuDNN (3 + 32 input channels), so no hand kernel launches. Returns the
    launches, the result and a callable that profiles one step."""
    cfg = train_gan.bench_config(model_name="cgan")
    step = make_gan_train_step(train_gan.D_ITER)
    t0 = time.perf_counter()
    ts, batch = train_gan.bench_state(cfg)
    model = ts.model
    log(f"cgan: CGAN CIFAR10, G {cfg['gan']['generator_hidden_size']}, "
        f"D {cfg['gan']['discriminator_hidden_size']}, embedding {cfg['gan']['embedding_size']}, "
        f"{cfg['classes_size']} modes, {sum(p.numel() for p in model.parameters())} parameters, "
        f"B={cfg['batch_size']['train']}, compute {model.compute_dtype}, d_iter "
        f"{train_gan.D_ITER}, built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    fd.first_dblock.launches = 0  # the counted run of the cgan path
    runs = [train_gan.time_steps(ts, batch, step, TRAIN_STEPS, TRAIN_WARMUP) for _ in range(2)]
    launches = {"first_dblock": fd.first_dblock.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = []
    if launches["first_dblock"] != 0:
        bad.append(f"first_dblock launched {launches['first_dblock']} times; CGAN's first "
                   f"block takes {3 + cfg['gan']['embedding_size']} channels and has no kernel")
    if not all(math.isfinite(v) for r in runs for v in r["losses"].values()):
        bad.append(f"non-finite losses {[r['losses'] for r in runs]}")
    if bad:
        raise SystemExit("cgan failed: " + "; ".join(bad))
    cmp = train_kernel_vs_plain(cfg, step, dict(cfg, compute_dtype="float32"))
    log("cgan bf16 vs f32:", json.dumps(cmp))
    result = {"images_per_s": [r["images_per_sec"] for r in runs],
              "ms_per_step": [r["ms_per_step"] for r in runs], "steps": TRAIN_STEPS,
              "warmup": TRAIN_WARMUP, "batch": cfg["batch_size"]["train"],
              "first_dblock_launches": launches["first_dblock"], "peak_mem_gib": peak_gib,
              "card": name_limit}
    log("cgan:", json.dumps(result))
    return launches, result, lambda out_dir: train_profile(ts, batch, step, out_dir)


# -------------------------------------------------------------------- real
def stage_real_digits(data_dir: str) -> dict:
    """The repo's 1,797 real UCI digits (32x32x1 uint8) as the raw MNIST
    files a user places, gzipped IDX under ``MNIST/raw/`` with the names of
    ``_MNIST_FILES`` (the first 1,297 train, the rest test), packed by the
    port's MNIST packer (with no md5s: they are not the published files),
    then read through ``fetch_dataset``. The packed arrays must equal the
    fixture's split bit for bit (32x32: no resample). Returns the record."""
    with np.load(REAL_DIGITS) as z:
        img, labels = z["img"], z["labels"]
    if img.dtype != np.uint8 or img.shape[1:] != (32, 32, 1):
        raise SystemExit(f"real digits: {img.dtype} {img.shape}, want uint8 [N,32,32,1]")
    raw = os.path.join(data_dir, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    splits = {"train": slice(0, REAL_TRAIN), "t10k": slice(REAL_TRAIN, None)}
    for stem, sl in splits.items():
        x, y = img[sl, :, :, 0], labels[sl].astype(np.uint8)
        for kind, data in (("images-idx3", struct.pack(">iiii", 2051, *x.shape) + x.tobytes()),
                           ("labels-idx1", struct.pack(">ii", 2049, len(y)) + y.tobytes())):
            with gzip.open(os.path.join(raw, f"{stem}-{kind}-ubyte.gz"), "wb") as f:
                f.write(data)
    t0 = time.perf_counter()
    _pack_mnist_like(os.path.dirname(raw), [(url, None) for url, _ in _MNIST_FILES], _DIGITS)
    rec = {"pack_seconds": time.perf_counter() - t0, "raw_files": sorted(os.listdir(raw))}
    ds = fetch_dataset("MNIST", data_dir=data_dir, verbose=False)
    for split, stem in (("train", "train"), ("test", "t10k")):
        sl = splits[stem]
        rec[f"{split}_bit_equal"] = bool(np.array_equal(ds[split].img, img[sl])
                                         and np.array_equal(ds[split].labels, labels[sl]))
        rec[f"{split}_shape"] = list(ds[split].img.shape)
    log("real digits from raw IDX files:", json.dumps(rec))
    if not (rec["train_bit_equal"] and rec["test_bit_equal"]):
        raise SystemExit("real digits: the packed MNIST files differ from the fixture")
    return rec


def run_real(name_limit: str, work: str):
    """Classifier, test_model, then MCGAN and CGAN on the real digits, all
    through the CLIs' ``main``. Returns the launches by model, the result
    and the CLI arguments and output folder the workflows reuse."""
    data_dir, out_dir = os.path.join(work, "data"), os.path.join(work, "output")
    staged = stage_real_digits(data_dir)
    base = ["--data_name", "MNIST", "--data_dir", data_dir, "--output_dir", out_dir]
    t0 = time.perf_counter()
    (cls,) = cli_train.main(base + ["--model_name", "classifier", "--control_name", "None",
                                    "--num_epochs", str(CLASSIFIER_EPOCHS)])
    cls_wall = time.perf_counter() - t0
    (tested,) = cli_test_model.main(base + ["--model_name", "classifier", "--control_name", "None"])
    acc = cls.logger.history["test/Accuracy"]
    log(f"real classifier: {CLASSIFIER_EPOCHS} epochs in {cls_wall:.1f} s, accuracy on the train "
        f"split by epoch {json.dumps(acc)}, test_model {json.dumps(dict(tested.mean))}")
    bad = []
    if not acc or not acc[-1] > 60:
        bad.append(f"classifier accuracy {acc}")
    if not os.path.exists(os.path.join(out_dir, "result", f"{cls.tag}.pkl")):
        bad.append("no test_model result")
    runs, launches = {}, {}
    for model in ("mcgan", "cgan"):
        torch.cuda.reset_peak_memory_stats()
        fd.first_dblock.launches = 0  # the counted run of this model's path
        t0 = time.perf_counter()
        (exp,) = cli_train.main(base + ["--model_name", model, "--control_name", "0.5",
                                        "--num_epochs", str(REAL_GAN_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[model] = fd.first_dblock.launches
        steps = sum(st["train_steps"] for st in exp.epoch_stats)
        hist = exp.logger.history
        runs[model] = {
            "tag": exp.tag, "run_wall_seconds": wall, "steps": steps,
            "first_dblock_launches": launches[model],
            "train_images_per_s": [st["train_images_per_s"] for st in exp.epoch_stats],
            "eval_seconds": [st["eval_seconds"] for st in exp.epoch_stats],
            "inception_score": hist.get("test/InceptionScore", []),
            "fid": hist.get("test/FID", []),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        want = 6 * steps if model == "mcgan" else 0
        if launches[model] != want:
            bad.append(f"{model}: first_dblock launched {launches[model]} times in {steps} "
                       f"steps, want {want}")
        scores = runs[model]["inception_score"] + runs[model]["fid"]
        if len(scores) != 2 * REAL_GAN_EPOCHS or not all(math.isfinite(x) for x in scores):
            bad.append(f"{model}: IS / FID not finite every epoch")
        if not os.path.exists(os.path.join(out_dir, "model", f"{exp.tag}_best.pkl")):
            bad.append(f"{model}: no best checkpoint")
    log("real: epoch | MCGAN images/s, eval s, IS, FID | CGAN images/s, eval s, IS, FID")
    keys = ("train_images_per_s", "eval_seconds", "inception_score", "fid")
    for e in range(REAL_GAN_EPOCHS):
        cols = [" ".join(f"{runs[m][k][e]:.4f}" if e < len(runs[m][k]) else "-" for k in keys)
                for m in ("mcgan", "cgan")]
        log(f"real: {e + 1} | {cols[0]} | {cols[1]}")
    result = {"card": name_limit, "staged": staged, "classifier_accuracy": acc,
              "classifier_seconds": cls_wall, "test_model": dict(tested.mean), **runs}
    log("real:", json.dumps(result))
    if bad:
        raise SystemExit("real failed: " + "; ".join(bad))
    return launches, result, (base, out_dir)


def _grid_shape(images: int, nrow: int, channels: int, side: int = 32) -> tuple:
    """The PNG of ``images`` images, ``nrow`` per row, padding 2."""
    rows = (images + nrow - 1) // nrow
    return (rows * (side + 2) + 2, nrow * (side + 2) + 2, channels)


# (workflow, extra flags, dump name, images generated, [(grid name, images, per row)])
WORKFLOW_CASES = [
    ("generate", ["--save_npy", "true"], "generated", 10 * 1000,
     [("generated_{tag}", 10 * 10, 10)]),
    ("generate", [], None, 10 * 10, [("generated_{tag}_10", 10 * 10, 10)]),
    ("transit", [], None, 11 * 10, [("transited_{tag}_10", 11 * 10, 10)]),
    ("create", [], None, 10 * (10 + 50 + 100),
     [(f"created_{{tag}}_{m}", 10 * m, m) for m in (10, 50, 100)]),
    ("create", ["--save_npy", "true"], "created", 10 * 1000, [("created_{tag}", 10 * 10, 10)]),
]


def run_workflows(name_limit: str, base: list, out_dir: str):
    """generate / transit / create through ``cli.sample`` on the two
    real-digit ``_best`` checkpoints; every dump checked and every PNG read
    back and sized."""
    rows, bad = [], []
    fd.first_dblock.launches = 0  # the counted run of the workflows
    for model in ("mcgan", "cgan"):
        for rec in run_sample_calls(model, "0.5", base, out_dir, f"0_MNIST_label_{model}_0.5",
                                    1, bad):
            rows.append(dict(rec, model=model))
            log("workflows:", json.dumps(rows[-1]))
    launches = {"first_dblock": fd.first_dblock.launches}
    if launches["first_dblock"]:
        bad.append(f"first_dblock launched {launches['first_dblock']} times (G only)")
    log("workflows:", json.dumps({"card": name_limit,
                                  "first_dblock_launches": launches["first_dblock"]}))
    if bad:
        raise SystemExit("workflows failed: " + "; ".join(bad))
    return launches, rows


# -------------------------------------------------------------- VQ kernels
def vq_margin(flat, emb):
    """Per row, the f32 margin within which two codes' distances cannot be
    told apart: ``VQ_MARGIN * (|x|^2 + max_k |e_k|^2)``, the size of the
    terms the distance is summed from."""
    return VQ_MARGIN * ((flat.double() ** 2).sum(1) + (emb.double() ** 2).sum(0).max())


def vq_inputs(N, D, K, seed, tie=False, scale=1.0):
    """Rows ~ N(0, 1) and a codebook ~ N(0, 1) ``[D, K]``, both times
    ``scale``; with ``tie`` every column appears twice, at shuffled places."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    flat = torch.randn((N, D), generator=g, device=DEV)
    if tie:
        half = torch.randn((D, K // 2), generator=g, device=DEV)
        emb = torch.cat([half, half], 1)[:, torch.randperm(K, generator=g, device=DEV)]
    else:
        emb = torch.randn((D, K), generator=g, device=DEV)
    return (flat * scale).contiguous(), (emb * scale).contiguous()


def vq_near_tie_inputs(N, D, K, seed):
    """A random codebook and rows at the midpoint of two random codes a, b,
    moved along a - b so that their two distances differ by f x 2 * 2^-10
    |x| max(|e_a|, |e_b|) (the size of the cross term's TF32 rounding), f
    over ``NEAR_TIE_FACTORS`` and both signs in turn; the midpoint is far
    nearer to a and b than to any other code."""
    _, emb = vq_inputs(1, D, K, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    a = torch.randint(0, K, (N,), generator=g, device=DEV)
    b = (a + torch.randint(1, K, (N,), generator=g, device=DEV)) % K
    ea, eb = emb.double().t()[a], emb.double().t()[b]
    mid, diff = (ea + eb) / 2, ea - eb
    norm = diff.norm(dim=1, keepdim=True)
    tau = 2 * 2.0 ** -10 * mid.norm(dim=1, keepdim=True) * torch.maximum(
        ea.norm(dim=1, keepdim=True), eb.norm(dim=1, keepdim=True))
    i = torch.arange(N, device=DEV)
    nf = len(NEAR_TIE_FACTORS)
    f = torch.tensor(NEAR_TIE_FACTORS, device=DEV, dtype=torch.float64)[i % nf]
    f = f * (1 - 2 * ((i // nf) % 2))
    # |x - e_b|^2 - |x - e_a|^2 = 2 t |a - b| at x = mid + t (a - b) / |a - b|
    return (mid + (f[:, None] * tau / (2 * norm)) * diff / norm).float().contiguous(), emb


def vq_assign_bound(N, D, K, rescored=0, paired=0, peak=PEAK_TF32_FLOPS):
    """The least time for the search: x and the codebook in, codes and q
    out, against the operations, the larger. The operations: the cross
    term's MACs at ``peak`` (the TF32 tensor cores) or the f32 MACs of the
    rows decided exactly (FFMA on the CUDA cores: ``rescored`` rows against
    every code, ``paired`` rows against their two best), whichever takes
    longer, since the two pipes run side by side. ``peak=PEAK_F32_FLOPS``
    gives the f32 bound of the CUDA-core design before it
    (``bound_f32_ms``)."""
    t_ops = max(2 * N * K * D / peak, 2 * (rescored * K + paired * 2) * D / PEAK_F32_FLOPS)
    t_bytes = 4 * (N * D + D * K + N + N * D) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def vq_ema_bound(N, D, K, weighted):
    flop = 2 * N * D  # a multiply-add per element of x
    nbytes = 4 * (N * D + N + (N if weighted else 0) + 2 * K + 3 * D * K)
    t_ops, t_bytes = flop / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_vq_assign(N, D, K, seed, timers: list | None = None, tie: bool = False,
                    case: str = "random rows and codebook", inputs=None, scale: float = 1.0,
                    variant: str = "tf32"):
    """The kernel's codes and rows against the plain version's (f32 on the
    card) and the distances in float64: codes equal wherever the best two
    codes are further apart than the margin, the chosen code's distance
    within the margin of the least everywhere, q the chosen columns, two
    launches bit-equal, the kernel the entry point chose ``variant``; with
    ``tie``, every code the lower of its two copies. Inputs:
    :func:`vq_inputs` (with ``tie`` and ``scale``), or ``inputs = (flat,
    emb)``. The first launch counts the rows the ``tf32`` kernel decided in
    f32, against every code and by their two best codes.
    With ``timers``, timed (see :func:`time_kernel`)."""
    flat, emb = inputs if inputs is not None else vq_inputs(N, D, K, seed, tie, scale)
    if (*flat.shape, emb.shape[1]) != (N, D, K):
        raise SystemExit(f"vq_assign: the inputs of {case!r} are {tuple(flat.shape)}, "
                         f"K {emb.shape[1]}, not {[N, D, K]}")
    rescored = torch.zeros(2, dtype=torch.int32, device=DEV)
    code, q = kvq.vq_assign(flat, emb, rescored=rescored)
    code2, q2 = kvq.vq_assign(flat, emb)
    code_r, _ = kvq.vq_assign_reference(flat, emb)
    torch.cuda.synchronize()
    d64 = ((flat.double() ** 2).sum(1, keepdim=True) - 2 * flat.double() @ emb.double()
           + (emb.double() ** 2).sum(0, keepdim=True))
    top2 = d64.topk(2, dim=1, largest=False).values
    margin = vq_margin(flat, emb)
    clear = (top2[:, 1] - top2[:, 0]) > margin
    chosen = d64.gather(1, code.long()[:, None])[:, 0]
    bad = []
    if code.dtype != torch.int32 or code.shape != (N,) or q.shape != (N, D):
        bad.append(f"shapes {code.dtype} {tuple(code.shape)} {tuple(q.shape)}")
    if not torch.equal(code[clear], code_r[clear]):
        bad.append(f"{int((code[clear] != code_r[clear]).sum())} codes differ where clear")
    worst = (chosen - top2[:, 0] - margin).max().item()
    if worst > 0:
        bad.append(f"a chosen distance exceeds the least by more than the margin ({worst})")
    if not torch.equal(q, emb.t()[code.long()]):
        bad.append("q is not the chosen codebook columns")
    if not (torch.equal(code, code2) and torch.equal(q, q2)):
        bad.append("two launches differ")
    if tie:  # the first column equal to each column
        lowest = (emb.t()[:, None, :] == emb.t()[None, :, :]).all(-1).int().argmax(1)
        if not torch.equal(code.long(), lowest[code.long()]):
            bad.append("a tie did not go to the lower code")
    chose = kvq.assign_variant(N, D, K)
    if chose != variant:
        bad.append(f"the entry point chose {chose}, not {variant}")
    # max_abs_err: the chosen code's float64 distance above the least
    rec = {"shape": [N, D, K], "case": "ties" if tie else case, "variant": chose, "rows": N,
           "rows_rescored": int(rescored[0]), "rows_paired": int(rescored[1]),
           "rows_clear": int(clear.sum()),
           "codes_equal": int((code == code_r).sum()),
           "max_abs_err": (chosen - top2[:, 0]).max().item(),
           "max_margin": margin.max().item(), "two_launches_bit_equal": "two launches differ"
           not in bad, "ok": not bad}
    if timers is not None:
        esq = (emb ** 2).sum(0, keepdim=True)
        rec["bound_ms"], rec["bound_by"] = vq_assign_bound(N, D, K, rec["rows_rescored"],
                                                           rec["rows_paired"])
        rec["bound_f32_ms"], _ = vq_assign_bound(N, D, K, peak=PEAK_F32_FLOPS)
        time_kernel(rec, "vq_assign", lambda: kvq.vq_assign(flat, emb),
                    lambda: kvq.vq_assign_reference(flat, emb),
                    lambda: torch.addmm(esq, flat, emb, alpha=-2).argmin(1), timers)
    log("vq_assign", json.dumps(rec))
    if bad:
        raise SystemExit(f"vq_assign disagrees with its plain version at {[N, D, K]} "
                         f"({rec['case']}): {bad}")
    return rec


def column_errors(got, want, skip=None) -> dict:
    """A VQ buffer (``[K]`` or ``[D, K]``) against the plain version's, each
    code's column held to its own size: ``max_abs_err`` and ``worst_ratio
    = max_k max_d |got - want| / max_d |want|`` over the codes not in the
    mask ``skip`` (a column equal to the plain one counts 0, any error in an
    all-zero one inf). An update from cluster sizes near 0 leaves an unused
    code's column near ``1 / eps`` times the size of a used one's, so one
    bound for the whole buffer would pass any error in the used codes."""
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    if skip is not None:
        g, w = g[:, ~skip], w[:, ~skip]
    err, scale = (g - w).abs().amax(0), w.abs().amax(0)
    ratio = torch.where(err == 0, torch.zeros_like(err), err / scale)
    return {"max_abs_err": err.max().item(), "worst_ratio": ratio.max().item(),
            "codes": int(g.shape[1])}


def vq_step_inputs(cfg, steps: int):
    """The EMA's inputs in train step ``steps + 1`` of the full-width CIFAR10
    VQ-VAE (seed 0, the batch of :func:`vqvae_state`, as ``vqvae:`` times
    it): the encoder's rows, their codes from ``vq_assign`` and the
    quantizer's buffers. From the first update on, an unused code's column
    is ~1/eps times the size of a used one's and out of reach, and the codes
    fall onto a few of those the first step took."""
    ts, batch = vqvae_state(cfg, plain=False)
    step = make_train_step()
    for _ in range(steps):
        step(ts, batch)
    model, qz = ts.model, ts.model.quantizer
    with torch.no_grad():
        h = model.encoder(batch["img"].permute(0, 3, 1, 2).to(model.compute_dtype), True)
    flat = h.permute(0, 2, 3, 1).reshape(-1, qz.embedding.shape[0]).float().contiguous()
    code, _ = kvq.vq_assign(flat, qz.embedding)
    return flat, code, {"cluster_size": qz.cluster_size, "embedding_mean": qz.embedding_mean,
                        "embedding": qz.embedding}


def check_vq_ema(N, D, K, seed, timers: list | None = None, weighted: bool = False,
                 collapsed: bool = False, inputs=None):
    """The update on copies of the same buffers through the kernel (twice:
    the two results bit-equal) and the plain version (f32 on the card):
    cluster sizes equal (the counts are exact), ``embedding_mean`` and
    ``embedding`` within ``EMA_TOL`` of each code's column
    (:func:`column_errors`; sums of rows in another order).
    Random rows and codebook, the codes from ``vq_assign`` (spread) or with
    ``collapsed`` every row on one of three codes, cluster sizes in [1, 3];
    or ``inputs = (flat, code, buffers)``, as :func:`vq_step_inputs` gives
    them. With ``timers``, timed (see :func:`time_kernel`)."""
    if inputs is not None:
        flat, code, bufs = inputs
        if (*flat.shape, bufs["cluster_size"].shape[0]) != (N, D, K):
            raise SystemExit(f"vq_ema: the step's inputs are {tuple(flat.shape)}, K "
                             f"{bufs['cluster_size'].shape[0]}, not {[N, D, K]}")
        case = "a VQ-VAE train step's rows and codes"
    else:
        flat, emb = vq_inputs(N, D, K, seed)
        g = torch.Generator(device=DEV).manual_seed(seed + 1)
        if collapsed:
            code = torch.tensor([5, 6, K - 1], device=DEV, dtype=torch.int32)[
                torch.randint(0, 3, (N,), generator=g, device=DEV)]
        else:
            code, _ = kvq.vq_assign(flat, emb)
        cs = torch.rand(K, generator=g, device=DEV) * 2 + 1
        bufs = {"cluster_size": cs, "embedding_mean": emb * cs, "embedding": emb}
        case = "three codes" if collapsed else "random rows, codes spread"
    g = torch.Generator(device=DEV).manual_seed(seed + 2)
    w = (torch.rand(N, generator=g, device=DEV) < 0.75).float() if weighted else None
    got = {k: t.clone() for k, t in bufs.items()}
    again = {k: t.clone() for k, t in bufs.items()}
    want = {k: t.clone() for k, t in bufs.items()}
    kvq.vq_ema(flat, code, w, *got.values(), 0.99, 1e-5)
    kvq.vq_ema(flat, code, w, *again.values(), 0.99, 1e-5)
    kvq.vq_ema_reference(flat, code, w, *want.values(), 0.99, 1e-5)
    torch.cuda.synchronize()
    rec = {"shape": [N, D, K], "case": case + (", rows masked" if weighted else ""),
           "codes_used": int(torch.unique(code).numel()),
           "two_launches_bit_equal": all(torch.equal(got[k], again[k]) for k in bufs)}
    bad = [] if rec["two_launches_bit_equal"] else ["two launches differ"]
    for k in bufs:
        rec[k] = column_errors(got[k], want[k])
        tol = 0.0 if k == "cluster_size" else EMA_TOL
        if not (torch.isfinite(got[k]).all() and rec[k]["worst_ratio"] <= tol):
            bad.append(k)
    rec["max_abs_err"] = max(rec[k]["max_abs_err"] for k in bufs)
    if timers is not None:
        # the update runs again and again on one copy: the same work each time
        rec["bound_ms"], rec["bound_by"] = vq_ema_bound(N, D, K, weighted)
        code64 = code.long()
        time_kernel(rec, "vq_ema", lambda: kvq.vq_ema(flat, code, w, *got.values(), 0.99, 1e-5),
                lambda: kvq.vq_ema_reference(flat, code, w, *want.values(), 0.99, 1e-5),
                lambda: (torch.bincount(code64, minlength=K), torch.zeros(
                    (K, D), device=DEV).index_add_(0, code64, flat)), timers)
    log("vq_ema", json.dumps(rec))
    if bad:
        raise SystemExit(f"vq_ema disagrees with its plain version at {[N, D, K]} ({case}) "
                         f"in {bad}: {json.dumps(rec)}")
    return rec


def time_kernel(rec, kname, kernel, plain, library, timers: list) -> None:
    """CUDA-event times of back-to-back calls of the wrapper, the plain
    version and the PyTorch yardstick (``wrapper_ms``, ``plain_ms``,
    ``library_ms``: what a caller waits for, host included). The kernel's
    own device time, ``ms``, is read later by :func:`kernel_device_times`,
    after every timed phase, from ``kernel`` queued in ``timers``."""
    rec["wrapper_ms"] = cuda_ms(kernel, 50)
    rec["plain_ms"] = cuda_ms(plain, 50)
    rec["library_ms"] = cuda_ms(library, 50)
    timers.append((rec, kname, kernel))


def kernel_device_times(timers: list, reps: int = 20) -> None:
    """For each record queued by :func:`time_kernel`, ``reps`` calls of the
    wrapper under ``torch.profiler``: ``ms`` is the mean device time of one
    call's kernels themselves (the wrapper's copies and the host left out)
    and ``roofline_share`` its bound over it. Where a call launches several
    kernels (``vq_ema``: by its wrapper's count over one call), also
    ``ms_by_kernel`` and ``span_ms``, the mean time from a call's first
    kernel's start to its last one's end (the gaps between them in). After
    every timed phase, before the profiles of whole steps. A pass that sees
    another count of launches is run again, three times at most; then
    ``ms`` is taken by CUDA events if the profiler saw none of the
    launches, and the run fails if it saw some, or the wrapper launched
    nothing. ``ms_source`` names the route."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for rec, kname, kernel in timers:
        for attempt in range(4):  # the profiler has been seen to drop events
            before = {**counts(), **int8_counts()}[kname]
            kernel()
            torch.cuda.synchronize()
            per_call = {**counts(), **int8_counts()}[kname] - before
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    kernel()
                torch.cuda.synchronize()
            ev = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and f"{kname}_kernel" in e.name]
            if per_call >= 1 and len(ev) == reps * per_call:
                break
            log(f"{kname}: the profiler saw {len(ev)} launches of {reps} x {per_call}")
        else:
            if per_call < 1 or ev:
                raise SystemExit(f"{kname} ({rec.get('case', rec['shape'])}): {per_call} "
                                 f"launches a call, the profiler saw {len(ev)} of "
                                 f"{reps} x {per_call}")
            # CUPTI gave no device time at all: CUDA events, the host's gaps included
            rec["ms"] = cuda_ms(kernel, reps)
            rec["ms_source"] = "CUDA events (the profiler saw none of the kernel's launches)"
            rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
            log(f"{kname} device ({rec['ms_source']}):", json.dumps(
                {k: rec[k] for k in ("shape", "case", "ms", "bound_ms", "roofline_share")}))
            continue
        rec["ms_source"] = "torch.profiler (CUPTI device time)"
        by_kernel = {}
        for e in ev:
            name = re.search(rf"{kname}_kernel\w*", e.name).group(0)
            by_kernel[name] = by_kernel.get(name, 0.0) + (e.time_range.end
                                                          - e.time_range.start) / 1e3 / reps
        rec["ms"] = sum(by_kernel.values())
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
        extra = ()
        if per_call > 1:
            ev.sort(key=lambda e: e.time_range.start)
            calls = [ev[i:i + per_call] for i in range(0, len(ev), per_call)]
            rec["ms_by_kernel"] = by_kernel
            rec["span_ms"] = sum(c[-1].time_range.end - c[0].time_range.start
                                 for c in calls) / 1e3 / reps
            extra = ("ms_by_kernel", "span_ms")
        log(f"{kname} device:", json.dumps({k: rec[k] for k in (
            "shape", "case", "ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "roofline_share") + extra + tuple(k for k in (
                "variant", "rows_rescored", "rows_paired", "bound_f32_ms",
                "generic_recorded")
                if k in rec)}))


def vq_launches() -> dict:
    return {"vq_assign": kvq.vq_assign.launches, "vq_ema": kvq.vq_ema.launches}


@functools.cache
def ema_kernels() -> int:
    """Kernels that one ``vq_ema`` call launches on the card (its wrapper
    counts each): the count over one call on one row, taken the first time
    it is asked for; :func:`main` asks before any path is counted."""
    before = kvq.vq_ema.launches
    bufs = (torch.ones(2, device=DEV), torch.zeros(4, 2, device=DEV),
            torch.zeros(4, 2, device=DEV))
    kvq.vq_ema(torch.zeros(1, 4, device=DEV), torch.zeros(1, dtype=torch.int32, device=DEV),
               None, *bufs, 0.99, 1e-5)
    torch.cuda.synchronize()
    return kvq.vq_ema.launches - before


def zero_counts() -> None:
    """Every kernel's count to 0, just before a path is driven."""
    fd.first_dblock.launches = kvq.vq_assign.launches = kvq.vq_ema.launches = 0
    kmc.mc_gated_matmul.launches = kmc.mc_gated_matmul.backward_launches = 0
    kint8.int8_conv.launches = kint8.int8_quantize.launches = 0


def counts() -> dict:
    return {"first_dblock": fd.first_dblock.launches, **vq_launches(),
            "mc_gated_matmul": kmc.mc_gated_matmul.launches,
            "mc_gated_matmul_backward": kmc.mc_gated_matmul.backward_launches}


def int8_counts() -> dict:
    """The int8 serving kernels' counts (only the export phase runs them)."""
    return {"int8_conv": kint8.int8_conv.launches, "int8_quantize": kint8.int8_quantize.launches}


# ------------------------------------------------------------------ VAE
def _history(exp, names):
    return {n: exp.logger.history.get(n, []) for n in names}


def run_vae(name_limit: str, data_dir: str, out_dir: str):
    """MCVAE and CVAE on the CIFAR10-shaped data through ``cli.train``: 2
    epochs of ``VAE_STEPS`` steps (each evaluated on the whole train
    split), ``resume_mode=1`` to epoch 3 with the state checked equal,
    ``cli.test_model`` and the five ``cli.sample`` calls on ``_best``."""
    base = ["--data_name", "CIFAR10", "--data_dir", data_dir, "--output_dir", out_dir,
            "--device", str(DEV)]
    runs, bad, path_counts = {}, [], {}
    for model, ctrl in (("mcvae", "0.5"), ("cvae", "None")):
        argv = base + ["--model_name", model, "--control_name", ctrl]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        (exp,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS)],
                                limit_train_batches=VAE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        saved = to_numpy(exp.state_dict())
        (exp3,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS + 1),
                                         "--resume_mode", "1"], limit_train_batches=VAE_STEPS)
        resumed = exp3.resumed or {}
        mismatch = _state_mismatch(saved, resumed["state"]) if resumed else ["nothing resumed"]
        if mismatch:
            bad.append(f"{model}: resumed state differs at {mismatch[:8]}")
        (tested,) = cli_test_model.main(argv)
        stats = exp.epoch_stats + exp3.epoch_stats
        hist = _history(exp3, ("train/Loss", "train/BCE", "test/Loss", "test/BCE"))
        if any(len(v) != TRAINER_EPOCHS + 1 or not all(math.isfinite(x) for x in v)
               for v in hist.values()):
            bad.append(f"{model}: Loss / BCE not finite every epoch: {hist}")
        wf = run_sample_calls(model, ctrl, base, out_dir, exp.tag, exp.cfg["data_shape"][-1],
                              bad)
        path_counts[model] = counts()
        runs[model] = {
            "tag": exp.tag, "steps_per_epoch": VAE_STEPS, "run_wall_seconds": wall,
            "parameters": sum(p.numel() for p in exp.model.parameters()),
            "train_images_per_s": [s["train_images_per_s"] for s in stats],
            "eval_images": [s["eval_images"] for s in stats],
            "eval_seconds": [s["eval_seconds"] for s in stats],
            "bce_by_epoch": hist["test/BCE"], "train_bce_by_epoch": hist["train/BCE"],
            "test_model": dict(tested.mean), "resumed_state_equal": not mismatch,
            "workflows": wf, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"vae {model}:", json.dumps(runs[model]))
    for model, c in path_counts.items():
        if any(c.values()):
            bad.append(f"{model}: hand kernels launched {c} (the VAE path has none)")
    log("vae:", json.dumps({"card": name_limit, "launches": path_counts}))
    if bad:
        raise SystemExit("vae failed: " + "; ".join(bad))
    return path_counts, runs


def run_sample_calls(model, ctrl, base, out_dir, tag, channels, bad,
                     finite_min: float = 1.0) -> list:
    """``cli.sample`` for each of ``WORKFLOW_CASES`` on ``tag``'s ``_best``:
    at least ``finite_min`` of every dump's images finite (all of them but
    for a Glow, which may draw NaN images: its CIFAR10 create keeps the
    finite ones), the finite values in [0, 255] and the dump what the call
    returned, every PNG read back with the port's own decoder and its whole
    shape (channels too) checked against its grid. Returns one record per
    call; appends what failed to ``bad``."""
    rows = []
    for wf, extra, dump, images, grids in WORKFLOW_CASES:
        t0 = time.perf_counter()
        (out,) = cli_sample.main(wf, base + ["--model_name", model, "--control_name", ctrl]
                                 + extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {"workflow": wf, "args": extra, "images": images, "seconds": dt,
               "images_per_s": images / dt, "png": []}
        if dump:
            arr = np.load(os.path.join(out_dir, "npy", f"{dump}_{tag}.npy"))
            finite = np.isfinite(arr).all(axis=(1, 2, 3))
            kept = arr[finite]
            rec["dump"], rec["finite_share"] = list(arr.shape), float(finite.mean())
            if (arr.shape != (10_000, channels, 32, 32) or finite.mean() < finite_min
                    or not kept.size or kept.min() < 0 or kept.max() > 255
                    or not np.array_equal(arr, out, equal_nan=True)):
                bad.append(f"{model} {wf}: dump {arr.shape}, finite share {finite.mean()}, "
                           f"[{kept.min() if kept.size else None}, "
                           f"{kept.max() if kept.size else None}]")
        for name, n, nrow in grids:
            path = vis_path({"output_dir": out_dir}, f"{name.format(tag=tag)}.png")
            png, want = read_png(path), _grid_shape(n, nrow, channels)
            rec["png"].append({"file": os.path.basename(path), "shape": list(png.shape)})
            if png.shape != want:
                bad.append(f"{path}: {png.shape}, want {want}")
        rows.append(rec)
    return rows


# ---------------------------------------------------------------- VQ-VAE
def vqvae_cfg() -> dict:
    return process_control({"data_name": "CIFAR10", "model_name": "vqvae", "ae_name": "vqvae"})


def vqvae_state(cfg, plain: bool):
    """The full-width VQ-VAE (seed 0) on the card, Adam 3e-4 with clip 1,
    and a batch of CIFAR-shaped images from seed 0."""
    model = build_model(cfg, DEV).use_plain_kernels(plain)
    opt = make_optimizer(model.parameters(), {"optimizer_name": "Adam", "lr": 3e-4,
                                              "weight_decay": 0}, grad_clip=1.0)
    g = torch.Generator(device=DEV).manual_seed(0)
    B = cfg["batch_size"]["train"]
    img = torch.rand((B, *cfg["data_shape"]), generator=g, device=DEV) * 2 - 1
    return TrainState(model, opt), {"img": img, "label": torch.zeros(B, dtype=torch.long,
                                                                     device=DEV)}


def vqvae_steps(ts, batch, step, steps: int, warmup: int) -> dict:
    for _ in range(warmup):
        step(ts, batch)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step(ts, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"images_per_s": batch["img"].shape[0] * steps / dt, "ms_per_step": dt / steps * 1e3,
            "launches": vq_launches(), "loss": float(out["loss"])}


def run_vqvae(name_limit: str, data_dir: str, out_dir: str):
    """The CIFAR10 VQ-VAE step at full width through the kernels and
    through the plain versions in turns; one step of each from the same
    state held to the other; one eval batch; then ``cli.train``."""
    cfg = vqvae_cfg()
    step = make_train_step()
    states = {plain: vqvae_state(cfg, plain) for plain in (False, True)}
    model = states[False][0].model
    B = cfg["batch_size"]["train"]
    log(f"vqvae: CIFAR10, hidden {cfg['vqvae']['hidden_size']}, D "
        f"{cfg['vqvae']['embedding_size']}, K {cfg['vqvae']['num_embedding']}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, B={B}, compute "
        f"{model.compute_dtype}")
    runs, bad, step_counts = {False: [], True: []}, [], None
    for plain in (False, True, True, False):
        res = vqvae_steps(*states[plain], step, TRAIN_STEPS, TRAIN_WARMUP)
        step_counts = step_counts or dict(res["launches"])  # the first: the counted run
        want = {"vq_assign": 0, "vq_ema": 0} if plain else {"vq_assign": TRAIN_STEPS,
                                                             "vq_ema": TRAIN_STEPS
                                                             * ema_kernels()}
        if res["launches"] != want or not math.isfinite(res["loss"]):
            bad.append(f"{'plain' if plain else 'kernel'} path: {res}")
        runs[plain].append(res)
        log(f"vqvae {'plain' if plain else 'kernel'}:", json.dumps(res))

    # one step from the same state through each path
    (ts_k, batch), (ts_p, _) = vqvae_state(cfg, False), vqvae_state(cfg, True)
    out_k, out_p = step(ts_k, batch), step(ts_p, batch)
    torch.cuda.synchronize()
    code_k, code_p = out_k["output"]["code"], out_p["output"]["code"]
    cmp = {"loss": {"kernel": float(out_k["loss"]), "plain": float(out_p["loss"])},
           "codes_equal_share": float((code_k == code_p).float().mean())}
    if not abs(cmp["loss"]["kernel"] - cmp["loss"]["plain"]) <= VQ_STEP_TOL * abs(
            cmp["loss"]["plain"]):
        bad.append(f"step loss {cmp['loss']}")
    if cmp["codes_equal_share"] < VQ_CODES_EQUAL:
        bad.append(f"equal codes {cmp['codes_equal_share']}")
    # a code that a row went to on one path only has other sums; every
    # other code's column is held to its own size (see column_errors)
    differ = (code_k != code_p).reshape(-1)
    K = ts_p.model.quantizer.cluster_size.shape[0]
    skip = torch.zeros(K, dtype=torch.bool, device=DEV)
    skip[code_k.reshape(-1)[differ].long()] = True
    skip[code_p.reshape(-1)[differ].long()] = True
    cmp["codes_used"] = int(torch.unique(code_p).numel())
    cmp["codes_skipped"] = int(skip.sum())
    for k in ("cluster_size", "embedding_mean", "embedding"):
        got, want = getattr(ts_k.model.quantizer, k), getattr(ts_p.model.quantizer, k)
        cmp[k] = column_errors(got, want, skip)
        if not cmp[k]["worst_ratio"] <= VQ_STEP_TOL:
            bad.append(f"{k} {cmp[k]}")
    log("vqvae kernel vs plain:", json.dumps(cmp))

    # one eval batch at the eval batch size: one search, no update
    Be = cfg["batch_size"]["test"]
    img = torch.rand((Be, *cfg["data_shape"]), device=DEV) * 2 - 1
    zero_counts()
    with torch.no_grad():
        ev = model.eval()({"img": img}, train=False)
    torch.cuda.synchronize()
    eval_counts = vq_launches()
    if eval_counts != {"vq_assign": 1, "vq_ema": 0} or not torch.isfinite(ev["loss"]):
        bad.append(f"eval batch: {eval_counts}, loss {float(ev['loss'])}")

    argv = ["--data_name", "CIFAR10", "--model_name", "vqvae", "--control_name", "None",
            "--data_dir", data_dir, "--output_dir", out_dir, "--device", str(DEV)]
    zero_counts()
    t0 = time.perf_counter()
    (exp,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS)],
                            limit_train_batches=VAE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer_counts = vq_launches()
    steps = sum(s["train_steps"] for s in exp.epoch_stats)
    eval_batches = sum(-(-s["eval_images"] // B) for s in exp.epoch_stats)
    if trainer_counts != {"vq_assign": steps + eval_batches, "vq_ema": steps * ema_kernels()}:
        bad.append(f"trainer: {trainer_counts} in {steps} steps and {eval_batches} eval batches")
    hist = _history(exp, ("train/MSE", "test/MSE"))
    if any(len(v) != TRAINER_EPOCHS or not all(math.isfinite(x) for x in v)
           for v in hist.values()):
        bad.append(f"trainer MSE {hist}")
    result = {
        "card": name_limit, "batch": B,
        "kernel_images_per_s": [r["images_per_s"] for r in runs[False]],
        "plain_images_per_s": [r["images_per_s"] for r in runs[True]],
        "kernel_ms_per_step": [r["ms_per_step"] for r in runs[False]],
        "plain_ms_per_step": [r["ms_per_step"] for r in runs[True]],
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in step_counts.items()},
        "eval_batch_launches": eval_counts, "kernel_vs_plain": cmp,
        "trainer": {"wall_seconds": wall, "steps": steps, "eval_batches": eval_batches,
                    "launches": trainer_counts, "mse_by_epoch": hist["test/MSE"],
                    "train_images_per_s": [s["train_images_per_s"] for s in exp.epoch_stats],
                    "eval_seconds": [s["eval_seconds"] for s in exp.epoch_stats]}}
    log("vqvae:", json.dumps(result))
    if bad:
        raise SystemExit("vqvae failed: " + "; ".join(bad))

    def profile(out_dir):  # one step of each path, after every timed phase
        return {path: train_profile_single(*states[plain], step, out_dir, f"vqvae_{path}")
                for path, plain in (("kernel", False), ("plain", True))}

    return {"step": step_counts, "eval": eval_counts, "trainer": trainer_counts}, result, profile


def train_profile_single(ts, batch, step, out_dir: str, tag: str, detail=()) -> dict:
    """One single-model train step under ``torch.profiler``; with
    ``detail``, the kernels of those categories by name."""
    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(ts, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    rec = device_profile(run, (), out_dir, tag)
    return dict({k: rec[k] for k in ("window_ms", "device_busy_ms", "device_busy_share",
                                     "kernel_launches", "category_ms", "top_kernels")},
                **{f"kernels {cat}": rec["kernels_by_category"].get(cat, []) for cat in detail})


def run_real_vae(name_limit: str, base: list, out_dir: str):
    """MCVAE, CVAE and VQ-VAE on the real digits (32x32x1), ``REAL_VAE_EPOCHS``
    epochs each, BCE / MSE per epoch on the train split."""
    runs, bad, launches = {}, [], {}
    for model, ctrl, metric in (("mcvae", "0.5", "BCE"), ("cvae", "None", "BCE"),
                                ("vqvae", "None", "MSE")):
        zero_counts()
        t0 = time.perf_counter()
        (exp,) = cli_train.main(base + ["--model_name", model, "--control_name", ctrl,
                                        "--num_epochs", str(REAL_VAE_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[model] = counts()
        steps = sum(s["train_steps"] for s in exp.epoch_stats)
        evals = sum(-(-s["eval_images"] // exp.cfg["batch_size"]["train"])
                    for s in exp.epoch_stats)
        want = ({"first_dblock": 0, "vq_assign": steps + evals, "vq_ema": steps * ema_kernels(),
                 "mc_gated_matmul": 0, "mc_gated_matmul_backward": 0} if model == "vqvae"
                else {"first_dblock": 0, "vq_assign": 0, "vq_ema": 0, "mc_gated_matmul": 0,
                      "mc_gated_matmul_backward": 0})
        if launches[model] != want:
            bad.append(f"{model}: launches {launches[model]}, want {want}")
        hist = exp.logger.history.get(f"test/{metric}", [])
        if len(hist) != REAL_VAE_EPOCHS or not all(math.isfinite(x) for x in hist):
            bad.append(f"{model}: {metric} {hist}")
        runs[model] = {"run_wall_seconds": wall, "steps": steps, "metric": metric,
                       "by_epoch": hist, "train_by_epoch": exp.logger.history.get(
                           f"train/{metric}", []),
                       "train_images_per_s": [s["train_images_per_s"] for s in exp.epoch_stats],
                       "launches": launches[model]}
    log("real: epoch | MCVAE BCE | CVAE BCE | VQ-VAE MSE")
    for e in range(REAL_VAE_EPOCHS):
        log(f"real: {e + 1} | " + " | ".join(
            f"{runs[m]['by_epoch'][e]:.5f}" if e < len(runs[m]["by_epoch"]) else "-"
            for m in ("mcvae", "cvae", "vqvae")))
    log("real vae:", json.dumps({"card": name_limit, **runs}))
    if bad:
        raise SystemExit("real vae failed: " + "; ".join(bad))
    return launches, runs


# ------------------------------------------------------------- PixelCNN
def mc_gated_matmul_bound(B, P, K, N, modes, esize=2, gate=True, affine=True):
    """Least time of one call: ``x`` and ``w`` read, ``out`` written (in the
    operands' dtype), alpha / beta and the indicator / codebook read (f32);
    ``2 M N K`` operations at the bf16 tensor-core or the f32 peak."""
    M = B * P
    flop = 2 * M * N * K
    nbytes = (esize * (M * K + N * K + M * N) + (8 * N if affine else 0)
              + (4 * (B * modes + modes * N) if gate else 0))
    t_ops = flop / (PEAK_BF16_FLOPS if esize == 2 else PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mc_gated_matmul_backward_bound(B, P, K, N, modes):
    """Least time of one backward kernel call: ``x``, ``w`` and ``g`` read
    and ``gza`` and ``x``'s copy ``xt`` written (bf16), alpha / beta and the
    gate read and dalpha / dbeta written (f32); ``2 M N K`` operations (the
    recompute) at the bf16 peak."""
    M = B * P
    nbytes = 2 * (2 * M * K + N * K + 2 * M * N) + 4 * (4 * N + B * modes + modes * N)
    t_ops = 2 * M * N * K / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mc_backward_parts_bound(B, P, K, N) -> dict:
    """Least times (bytes at the memory rate against bf16 operations at the
    tensor-core rate) of the backward's parts: a copy of ``x`` to ``[K, B,
    P]`` (the kernel writes one; PyTorch's is timed beside it), ``dx = w^T
    gza`` and ``dw = gza xt^T``."""
    M = B * P

    def bound(nbytes, flop):
        return max(nbytes / PEAK_BYTES, flop / PEAK_BF16_FLOPS) * 1e3

    return {"x_copy": bound(4 * M * K, 0), "dx": bound(2 * (N * K + M * N + M * K), 2 * M * N * K),
            "dw": bound(2 * (M * N + M * K + N * K), 2 * M * N * K)}


def mc_inputs(B, K, N, P, modes, dtype, seed, soft=False):
    """``x [B, K(, P)]`` ~ N(0, 1), ``w [N, K]`` ~ N(0, 1/K), BatchNorm-like
    alpha in [0.5, 1.5] and beta ~ N(0, 0.1), a binary codebook and one-hot
    rows (``soft``: each a softmax over the modes, as transit mixes them)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((B, K) if P == 1 else (B, K, P), generator=g, device=DEV).to(dtype)
    w = (torch.randn((N, K), generator=g, device=DEV) / math.sqrt(K)).to(dtype)
    alpha = torch.rand(N, generator=g, device=DEV) + 0.5
    beta = torch.randn(N, generator=g, device=DEV) * 0.1
    cb = (torch.rand((modes, N), generator=g, device=DEV) < 0.5).float()
    if soft:
        ind = torch.softmax(torch.randn((B, modes), generator=g, device=DEV), -1)
    else:
        ind = F.one_hot(torch.arange(B, device=DEV) % modes, modes).float()
    return x, w, alpha, beta, ind.contiguous(), cb


def check_mc_gated_matmul(B, K, N, P, relu, seed, case, timers=None, modes=10,
                          dtype=torch.bfloat16, gate=True, affine=True, soft=False,
                          recorded=None):
    """The kernel against its plain version on the same inputs: within
    ``KERNEL_TOL * max|plain|`` with bf16 operands (both round f32 sums to
    bf16 once), ``MC_TOL_F32 * max|plain|`` with f32 ones. With ``timers``,
    timed beside the plain version, the cuBLAS yardstick and the bound."""
    x, w, alpha, beta, ind, cb = mc_inputs(B, K, N, P, modes, dtype, seed, soft)
    if not affine:
        alpha = beta = None
    if not gate:
        ind = cb = None
    args = (x, w, alpha, beta, ind, cb, relu)
    got = kmc.mc_gated_matmul(*args)
    want = kmc.mc_gated_matmul_reference(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = KERNEL_TOL if dtype == torch.bfloat16 else MC_TOL_F32
    rec = {"shape": [B * P, K, N], "B": B, "P": P, "case": case,
           "variant": kmc.variant(x, w), "dtype": str(dtype).replace("torch.", ""),
           "relu": relu, "gate": gate,
           "affine": affine, "soft_indicator": soft, "max_abs_err": err,
           "max_abs_plain": scale, "tol": tol * scale}
    if recorded is not None:
        rec["generic_recorded"] = recorded
    if timers is not None:
        esize = 2 if dtype == torch.bfloat16 else 4
        rec["bound_ms"], rec["bound_by"] = mc_gated_matmul_bound(B, P, K, N, modes, esize,
                                                                gate, affine)
        # the yardstick: cuBLAS with BatchNorm folded into its weight and
        # bias, then the ReLU and the mask (their inputs made beforehand)
        ws = (w.float() * alpha[:, None]).to(dtype) if affine else w
        bias = (beta if affine else torch.zeros(N, device=DEV)).to(dtype)
        code = (ind @ cb).to(dtype) if gate else None

        def library():
            y = (torch.addmm(bias, x, ws.t()) if P == 1
                 else torch.baddbmm(bias[None, :, None], ws.expand(B, N, K), x))
            if relu:
                y = y.relu_()
            return y if code is None else y.mul_(code if P == 1 else code[:, :, None])

        time_kernel(rec, kmc.KERNEL, lambda: kmc.mc_gated_matmul(*args),
                    lambda: kmc.mc_gated_matmul_reference(*args), library, timers)
    log("mc_gated_matmul", json.dumps(rec))
    if not (torch.isfinite(got.float()).all() and err <= tol * scale):
        raise SystemExit(f"mc_gated_matmul disagrees with its plain version ({case}): "
                         f"{json.dumps(rec)}")
    return rec


def check_mc_gated_matmul_grad(seed):
    """The Pallas form (no affine, no ReLU, a soft indicator), f32: the
    autograd Function's gradients (its backward is the JAX VJP, as plain
    products) against the plain version's autograd, within ``1e-4 * max``."""
    x, w, _, _, ind, cb = mc_inputs(300, 128, 128, 1, 10, torch.float32, seed, soft=True)
    grads = []
    for fn in (kmc.mc_gated_matmul, kmc.mc_gated_matmul_reference):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xs, ws, None, None, ind, cb) ** 2).sum().backward()
        grads.append((xs.grad, ws.grad))
    torch.cuda.synchronize()
    rec = {name: {"max_abs_err": (a - b).abs().max().item(), "max_abs": b.abs().max().item()}
           for name, a, b in zip(("dx", "dw"), grads[0], grads[1])}
    log("mc_gated_matmul grad:", json.dumps(rec))
    if any(not r["max_abs_err"] <= 1e-4 * r["max_abs"] for r in rec.values()):
        raise SystemExit(f"mc_gated_matmul's gradient disagrees: {json.dumps(rec)}")


def check_mc_gated_matmul_affine_grad(seed, gate: bool):
    """The widened backward at Glow's level-2 shape (B=128, P = 64, K = N =
    512, bf16, ReLU, alpha and beta requiring gradients): every gradient of
    the autograd Function against the plain version's autograd; ``dx`` and
    ``dw`` (bf16) within ``KERNEL_TOL * max``, ``dalpha`` / ``dbeta`` (f32
    sums in another order) within ``1e-4 * max``. The upstream gradient is 0
    where the pre-activation is within ``1e-3 * max`` of 0: there the
    kernel's f32 sums, in another order, may take the ReLU's mask the other
    way."""
    x, w, alpha, beta, ind, cb = mc_inputs(128, 512, 512, 64, 10, torch.bfloat16, seed)
    if not gate:
        ind = cb = None
    pre = torch.einsum("nk,bkp->bnp", w.float(), x.float()) * alpha[:, None] + beta[:, None]
    r = torch.randn((128, 512, 64), device=DEV) * (pre.abs() > 1e-3 * pre.abs().max())
    grads = []
    for fn in (kmc.mc_gated_matmul, kmc.mc_gated_matmul_reference):
        leaves = [t.clone().requires_grad_() for t in (x, w, alpha, beta)]
        (fn(*leaves, ind, cb, True).float() * r).sum().backward()
        grads.append([t.grad.float() for t in leaves])
    torch.cuda.synchronize()
    rec = {name: {"max_abs_err": (a - b).abs().max().item(), "max_abs": b.abs().max().item(),
                  "tol": tol}
           for name, a, b, tol in zip(("dx", "dw", "dalpha", "dbeta"), grads[0], grads[1],
                                      (KERNEL_TOL, KERNEL_TOL, 1e-4, 1e-4))}
    log(f"mc_gated_matmul affine grad (Glow level 2, gate {gate}):", json.dumps(rec))
    if any(not r["max_abs_err"] <= r["tol"] * r["max_abs"] for r in rec.values()):
        raise SystemExit(f"mc_gated_matmul's widened gradient disagrees: {json.dumps(rec)}")


# the times of the generic kernel, which took Glow's levels 1-3 before the
# wide kernel, as recorded then (H100 80GB HBM3, 700 W): device ms, wrapper
# ms and the cuBLAS yardstick's ms. Constants, not measured by this script:
# printed beside the wide kernel's lines under "generic_recorded", never in
# the kernels line
GLOW_GENERIC_RECORDED = tuple(
    {"note": "recorded constant, not measured in this run", **t}
    for t in ({"ms": 0.3860, "wrapper_ms": 0.391, "library_ms": 0.1409},
              {"ms": 0.0970, "wrapper_ms": 0.100, "library_ms": 0.0627},
              {"ms": 0.0270, "wrapper_ms": 0.065, "library_ms": 0.0584}))


def check_mc_gated_matmul_backward(B, P, seed, case, timers=None, gate=True, K=512, N=512):
    """The gated 1x1's gradient at Glow's K = N = 512, or the K and N given
    (bf16, ReLU, alpha and beta requiring gradients), through the backward kernel and the two bf16
    cuBLAS products, against the plain f32 backward on the same inputs:
    ``gza`` (the kernel's bf16 output) and ``dx`` / ``dw`` within
    ``KERNEL_TOL * max``, ``dalpha`` / ``dbeta`` within ``1e-4 * max``; two
    launches of the kernel bit-equal. The upstream gradient is 0 where the
    pre-activation is within ``1e-3 * max`` of 0 (there the plain version's
    f32 sums, in another order, may take the ReLU's mask the other way).
    With ``timers``: the whole kernel path (``wrapper_ms``), the plain f32
    path, a bf16 PyTorch chain and the parts, each beside its bound."""
    x, w, alpha, beta, ind, cb = mc_inputs(B, K, N, P, 10, torch.bfloat16, seed)
    if not gate:
        ind = cb = None
    args = (x, w, alpha, beta, ind, cb, True)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1000)
    pre = torch.einsum("nk,bkp->bnp", w.float(), x.float()) * alpha[:, None] + beta[:, None]
    g = (torch.randn((B, N, P), generator=gen, device=DEV)
         * (pre.abs() > 1e-3 * pre.abs().max())).to(torch.bfloat16)
    code = (ind @ cb)[:, :, None] if gate else torch.ones((), device=DEV)
    gza_plain = g.float() * code * (pre > 0) * alpha[:, None]
    del pre
    out = kmc.mc_gated_matmul_reference(*args)
    before = kmc.mc_gated_matmul.backward_launches
    got = kmc.mc_gated_matmul_backward(*args, g)
    launches = kmc.mc_gated_matmul.backward_launches - before
    want = kmc.mc_gated_matmul_backward_reference(*args, g, out)
    first = kmc.mc_gated_matmul_backward_kernel(*args, g)
    second = kmc.mc_gated_matmul_backward_kernel(*args, g)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in zip(first, second))
    xt_equal = torch.equal(first[3], x.transpose(0, 1))
    gza = first[0].float().reshape(N, B, P).transpose(0, 1)
    errors = {}
    for name, a, b, tol in (("gza", gza, gza_plain, KERNEL_TOL),
                            *zip(("dx", "dw", "dalpha", "dbeta"), got, want,
                                 (KERNEL_TOL, KERNEL_TOL, 1e-4, 1e-4))):
        err, top = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
        errors[name] = {"max_abs_err": err, "max_abs_plain": top, "tol": tol * top,
                        "ok": bool(err <= tol * top)}
    del gza, gza_plain
    rec = {"shape": [B * P, K, N], "B": B, "P": P, "case": case,
           "variant": kmc.backward_variant(x, w), "gate": gate,
           "max_abs_err": errors["gza"]["max_abs_err"], "errors": errors,
           "launches_per_call": launches, "two_launches_bit_equal": bit_equal,
           "xt_equal": xt_equal}
    if timers is not None:
        rec["bound_ms"], rec["bound_by"] = mc_gated_matmul_backward_bound(B, P, K, N, 10)
        gza2 = first[0].view(N, B * P)
        xt = first[3].view(K, B * P)
        rec["parts_bound_ms"] = mc_backward_parts_bound(B, P, K, N)
        rec["parts_ms"] = {
            "kernel_wrapper": cuda_ms(lambda: kmc.mc_gated_matmul_backward_kernel(*args, g), 50),
            "kernel_wrapper_without_xt": cuda_ms(lambda: kmc.mc_gated_matmul_backward_kernel(
                *args, g, transposed_x=False), 50),
            "x_copy_torch": cuda_ms(lambda: x.transpose(0, 1).reshape(K, B * P), 50),
            "dx": cuda_ms(lambda: torch.mm(w.t(), gza2), 50),
            "dw": cuda_ms(lambda: torch.mm(gza2, xt.t()), 50)}
        wt, wx = w.expand(B, N, K), w.t().expand(B, K, N)

        def library():  # bf16 products, f32 epilogue and sums
            acc = torch.bmm(wt, x).float()
            gz = g.float() * code * ((acc * alpha[:, None] + beta[:, None]) > 0)
            sums = gz.sum((0, 2)), (gz * acc).sum((0, 2))
            gzb = (gz * alpha[:, None]).to(torch.bfloat16)
            return torch.bmm(wx, gzb), torch.einsum("bnp,bkp->nk", gzb, x), sums

        rec["wrapper_ms"] = cuda_ms(lambda: kmc.mc_gated_matmul_backward(*args, g), 50)
        rec["plain_ms"] = cuda_ms(lambda: kmc.mc_gated_matmul_backward_reference(*args, g, out),
                                  10)
        rec["library_ms"] = cuda_ms(library, 20)
        timers.append((rec, "mc_gated_matmul_backward",
                       lambda: kmc.mc_gated_matmul_backward_kernel(*args, g)))
    log("mc_gated_matmul backward", json.dumps(rec))
    if not (bit_equal and xt_equal and launches == 1 and rec["variant"] == "wide"
            and all(e["ok"] for e in errors.values())):
        raise SystemExit(f"mc_gated_matmul's backward kernel disagrees ({case}): "
                         f"{json.dumps(rec)}")
    return rec


# (B, K, N, P, relu, seed) of the wide kernel's shapes besides Glow's
WIDE_OTHER_SHAPES = ((48, 128, 192, 32, True, 77), (40, 256, 320, 192, True, 78),
                     (33, 64, 64, 16, False, 79), (17, 64, 200, 64, True, 80))


def check_mc_gated_matmul_glow(timers: list) -> tuple[list, list]:
    """Glow's coupling nets' gated 1x1 at B=128 (K = N = 512, ReLU): the
    three levels (P = 256, 64, 16) with MCGlow's gate, timed (the generic
    kernel's recorded times printed beside them, constants); the same
    without the gate (CGlow), an eval batch of 512, the digits' last batch
    of 17 at level 1 and 17 at level 3 and :data:`WIDE_OTHER_SHAPES`,
    checked; the wide kernel named at each; the autograd Function's
    backward with and without the gate; the backward kernel at the three
    levels, timed, and without the gate, at B = 17 and at
    :data:`WIDE_OTHER_SHAPES`, checked. Returns the timed forward and
    backward records."""
    timed = [check_mc_gated_matmul(128, 512, 512, P, True, 60 + i,
                                   f"Glow level {i + 1}, MCGlow (B=128, P = {P})", timers,
                                   recorded=GLOW_GENERIC_RECORDED[i])
             for i, P in enumerate(GLOW_POSITIONS)]
    checked = [check_mc_gated_matmul(128, 512, 512, P, True, 63 + i,
                                     f"Glow level {i + 1}, CGlow: no gate", gate=False)
               for i, P in enumerate(GLOW_POSITIONS)]
    checked += [
        check_mc_gated_matmul(512, 512, 512, 256, True, 66, "Glow level 1, eval batch of 512"),
        check_mc_gated_matmul(17, 512, 512, 256, True, 67, "Glow level 1, the digits' last batch"),
        check_mc_gated_matmul(17, 512, 512, 16, True, 70, "Glow level 3, the digits' last batch")]
    # the wide kernel's other shapes: K below 512, N not a multiple of 128
    # (a slice of 128 channels part empty; 200 not of 64 either), P 32 and
    # 192 (64-position tiles)
    checked += [check_mc_gated_matmul(B, K, N, P, relu, seed, f"wide: K {K}, N {N}, P {P}")
                for B, K, N, P, relu, seed in WIDE_OTHER_SHAPES]
    wrong = [r["case"] for r in timed + checked if r["variant"] != "wide"]
    if wrong:
        raise SystemExit(f"mc_gated_matmul: Glow's shapes not on the wide kernel: {wrong}")
    check_mc_gated_matmul_affine_grad(68, gate=True)
    check_mc_gated_matmul_affine_grad(69, gate=False)
    backward = [check_mc_gated_matmul_backward(128, P, 71 + i,
                                               f"Glow level {i + 1}, MCGlow (B=128, P = {P})",
                                               timers)
                for i, P in enumerate(GLOW_POSITIONS)]
    check_mc_gated_matmul_backward(128, 256, 74, "Glow level 1, CGlow: no gate", gate=False)
    check_mc_gated_matmul_backward(17, 256, 75, "Glow level 1, the digits' last batch")
    check_mc_gated_matmul_backward(17, 16, 76, "Glow level 3, the digits' last batch")
    for B, K, N, P, _, seed in WIDE_OTHER_SHAPES:
        check_mc_gated_matmul_backward(B, P, seed + 10, f"wide: K {K}, N {N}, P {P}", K=K, N=N)
    return timed, backward


def check_mc_gated_matmul_all(timers: list) -> tuple[dict, list]:
    """Every case of the PixelCNN's calls; the four timed shapes are the
    sampler's per-position head and residual (M = 1,000 grids) and an eval
    batch's (M = 512 grids x 64 positions). Returns the headline record
    (the sampler's head) and the other timed ones."""
    head = check_mc_gated_matmul(SAMPLE_CHUNK, 128, 512, 1, True, 40, "sampler head, one "
                                 "position", timers)
    others = [
        check_mc_gated_matmul(SAMPLE_CHUNK, 128, 128, 1, False, 41, "sampler residual, one "
                              "position", timers),
        check_mc_gated_matmul(512, 128, 512, 64, True, 42, "eval batch head", timers),
        check_mc_gated_matmul(512, 128, 128, 64, False, 43, "eval batch residual", timers)]
    check_mc_gated_matmul(17, 128, 512, 64, True, 44, "the digits' ragged eval batch")
    check_mc_gated_matmul(17, 128, 128, 64, False, 45, "the digits' ragged eval batch")
    check_mc_gated_matmul(17, 64, 200, 64, True, 55, "ragged: K 64, N 200")
    check_mc_gated_matmul(48, 96, 200, 16, False, 56, "K 96, P 16: the generic bf16 kernel")
    # the re-forward's chunk of 1,000 grids and 1,200 grids: many tiles of
    # two samples per block of the wide kernel
    check_mc_gated_matmul(SAMPLE_CHUNK, 128, 512, 64, True, 57, "the re-forward's chunk "
                          "of grids, head")
    check_mc_gated_matmul(SAMPLE_CHUNK, 128, 128, 64, False, 58, "the re-forward's chunk "
                          "of grids, residual")
    check_mc_gated_matmul(1200, 128, 128, 64, False, 59, "1,200 grids, residual")
    check_mc_gated_matmul(1, 128, 512, 1, True, 46, "M = 1")
    check_mc_gated_matmul(10, 128, 128, 1, False, 47, "a soft row-mixed indicator (transit)",
                          soft=True)
    check_mc_gated_matmul(SAMPLE_CHUNK, 128, 512, 1, False, 48, "the Pallas form: "
                          "(x @ w) * (indicator @ codebook)", affine=False)
    check_mc_gated_matmul(48, 64, 200, 1, False, 49, "the Pallas form, ragged tiles",
                          affine=False)
    check_mc_gated_matmul(SAMPLE_CHUNK, 128, 512, 1, True, 50, "indicator=None (CPixelCNN)",
                          gate=False)
    check_mc_gated_matmul(EXACT_GRIDS, 128, 512, 64, True, 51, "f32 operands",
                          dtype=torch.float32)
    check_mc_gated_matmul(SAMPLE_CHUNK, 128, 128, 1, False, 52, "f32 operands",
                          dtype=torch.float32)
    check_mc_gated_matmul(100, 128, 512, 1, True, 53, "100 created modes", modes=100)
    check_mc_gated_matmul_grad(54)
    return head, others


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


@contextlib.contextmanager
def _f32_convs():
    """cuDNN in full f32 (no TF32) inside the block, as the plain references
    are run."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def pixelcnn_exactness(model, grid, bad) -> dict:
    """On the card, f32: ``sample_codes_incremental`` and ``sample_codes``
    from one generator on ``EXACT_GRIDS`` grids must give equal codes but
    where the two best values of logits + Gumbel at a grid's first differing
    position are closer than ``EXACT_MARGIN``. bf16 (the model as it runs):
    the incremental sampler's per-position logits against a full f32
    forward on the codes it drew, within ``SLICE_TOL * max|f32|``."""
    m32 = copy.deepcopy(model)
    m32.compute_dtype = torch.float32
    C = np.arange(EXACT_GRIDS) % model.num_mode
    g = torch.Generator(device=DEV)
    H, W = grid
    with _f32_convs(), torch.no_grad():
        inc, logits = sample_codes_incremental(m32, C, g.manual_seed(2), grid, return_logits=True)
        full = sample_codes(m32, C, g.manual_seed(2), grid)
        g.manual_seed(2)  # the uniforms of each position, drawn again in the same order
        u = torch.stack([torch.rand((EXACT_GRIDS, model.input_size), generator=g, device=DEV)
                         for _ in range(H * W)])
        differ = []
        for b in range(EXACT_GRIDS):
            ne = (inc[b] != full[b]).reshape(-1).nonzero()
            if len(ne):
                t = int(ne[0])
                i, j = divmod(t, W)
                z = logits[b, i, j] - torch.log(-torch.log(
                    u[t, b].clamp_min(torch.finfo(torch.float32).tiny)))
                top = z.topk(2).values
                differ.append({"grid": b, "position": [i, j], "gap": (top[0] - top[1]).item()})
        codes_b, logits_b = sample_codes_incremental(model, C, g.manual_seed(3), grid,
                                                     return_logits=True)
        ref = m32({"img": codes_b, "label": torch.as_tensor(C, device=DEV)})["logits"].float()
    err = (logits_b - ref).abs().max().item()
    scale = ref.abs().max().item()
    rec = {"grids": EXACT_GRIDS, "codes_equal_share": float((inc == full).float().mean()),
           "first_differences": differ, "margin": EXACT_MARGIN,
           "bf16_logits_max_abs_err": err, "f32_logits_max_abs": scale,
           "bf16_tol": SLICE_TOL * scale}
    if any(d["gap"] >= EXACT_MARGIN for d in differ):
        bad.append(f"f32 samplers differ where the draw is clear: {differ}")
    if not err <= SLICE_TOL * scale:
        bad.append(f"bf16 sampler logits vs f32 forward: {err} > {SLICE_TOL} * {scale}")
    return rec


def pixelcnn_sampler(model, grid, out_dir, tag, bad) -> tuple[dict, dict, object]:
    """One chunk of ``SAMPLE_CHUNK`` grids three ways, grids/s each: the
    incremental sampler through the kernel (the counted run: 16 launches a
    position), through the kernel's plain version, and the full re-forward
    ``sample_codes``. Returns the record, the counted launches and a
    closure that profiles one incremental chunk (run after the timed phases)."""
    C = class_sweep(model.num_mode, SAMPLE_CHUNK // model.num_mode)
    g = torch.Generator(device=DEV)
    sample_codes_incremental(model, C[:16], g.manual_seed(0), grid)  # warm-up
    zero_counts()
    dt_k, codes_k = _timed(lambda: sample_codes_incremental(model, C, g.manual_seed(1), grid))
    chunk_counts = counts()
    model.use_plain_kernels()
    dt_p, codes_p = _timed(lambda: sample_codes_incremental(model, C, g.manual_seed(1), grid))
    model.use_plain_kernels(False)
    zero_counts()
    dt_f, codes_f = _timed(lambda: sample_codes(model, C, g.manual_seed(1), grid))
    full_counts = counts()
    H, W = grid
    want = (model.num_layer + 1) * H * W  # the residuals and the head, per position
    if chunk_counts["mc_gated_matmul"] != want or full_counts["mc_gated_matmul"] != want:
        bad.append(f"{tag}: a chunk launched {chunk_counts} (incremental), {full_counts} "
                   f"(re-forward), want {want} mc_gated_matmul")
    for name, c in (("kernel", codes_k), ("plain", codes_p), ("reforward", codes_f)):
        if c.shape != (SAMPLE_CHUNK, H, W) or c.min() < 0 or c.max() >= model.input_size:
            bad.append(f"{tag} {name} codes {tuple(c.shape)} [{c.min()}, {c.max()}]")
    rec = {"chunk": SAMPLE_CHUNK, "grid": list(grid),
           "incremental_kernel": {"seconds": dt_k, "grids_per_s": SAMPLE_CHUNK / dt_k},
           "incremental_plain": {"seconds": dt_p, "grids_per_s": SAMPLE_CHUNK / dt_p},
           "reforward_kernel": {"seconds": dt_f, "grids_per_s": SAMPLE_CHUNK / dt_f},
           # bf16 rounds the two paths' logits apart: near-ties may flip
           "codes_equal_share_kernel_vs_plain": float((codes_k == codes_p).float().mean()),
           "codes_equal_share_kernel_vs_reforward": float((codes_k == codes_f).float().mean()),
           "launches_per_chunk": chunk_counts}

    def profile(prof_dir):
        return device_profile(lambda: _timed(lambda: sample_codes_incremental(
            model, C, g.manual_seed(4), grid))[0], (), prof_dir, f"{tag}_sample_chunk")

    return rec, chunk_counts, profile


def run_pixelcnn(name_limit: str, data_dir: str, out_dir: str):
    """MCPixelCNN and CPixelCNN at full width on the codes of the
    ``vqvae:`` phase's ``_best`` (in ``out_dir``), on the CIFAR10-shaped
    files: ``cli.train`` for 2 epochs of ``PIXELCNN_STEPS`` steps (each
    evaluated on ``PIXELCNN_EVAL_BATCHES`` batches of the train split, NLL),
    ``resume_mode=1`` to epoch 3
    with the state checked equal, ``cli.test_model``, one eval batch at the
    eval batch size (16 launches), the sampler (a chunk three ways, the
    exactness checks) and the five ``cli.sample`` calls."""
    base = ["--data_name", "CIFAR10", "--data_dir", data_dir, "--output_dir", out_dir,
            "--device", str(DEV)]
    runs, bad, launches, profiles = {}, [], {}, {}
    for model, ctrl in (("mcpixelcnn", "0.5"), ("cpixelcnn", "None")):
        argv = base + ["--model_name", model, "--control_name", ctrl]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        (exp,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS)],
                                limit_train_batches=PIXELCNN_STEPS,
                                limit_eval_batches=PIXELCNN_EVAL_BATCHES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer = counts()
        B = exp.cfg["batch_size"]["train"]
        steps = sum(s["train_steps"] for s in exp.epoch_stats)
        evals = sum(-(-s["eval_images"] // B) for s in exp.epoch_stats)
        per_forward = exp.model.num_layer + 1  # 16: the residuals and the head
        want = {"first_dblock": 0, "vq_assign": steps + evals, "vq_ema": 0,
                "mc_gated_matmul": per_forward * evals, "mc_gated_matmul_backward": 0}
        if trainer != want:
            bad.append(f"{model} trainer: launches {trainer}, want {want}")
        saved = to_numpy(exp.state_dict())
        (exp3,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS + 1),
                                         "--resume_mode", "1"],
                                 limit_train_batches=PIXELCNN_STEPS,
                                 limit_eval_batches=PIXELCNN_EVAL_BATCHES)
        resumed = exp3.resumed or {}
        mismatch = _state_mismatch(saved, resumed["state"]) if resumed else ["nothing resumed"]
        if mismatch:
            bad.append(f"{model}: resumed state differs at {mismatch[:8]}")
        (tested,) = cli_test_model.main(argv, limit_eval_batches=PIXELCNN_EVAL_BATCHES)
        hist = _history(exp3, ("train/Loss", "train/NLL", "test/Loss", "test/NLL"))
        if any(len(v) != TRAINER_EPOCHS + 1 or not all(math.isfinite(x) for x in v)
               for v in hist.values()):
            bad.append(f"{model}: Loss / NLL not finite every epoch: {hist}")
        net = exp3.model
        side = exp3.cfg["data_shape"][0] // 4
        # one eval batch at the eval batch size: 16 launches
        Be = exp3.cfg["batch_size"]["test"]
        g = torch.Generator(device=DEV).manual_seed(5)
        batch = {"img": torch.randint(0, net.input_size, (Be, side, side), generator=g,
                                      device=DEV),
                 "label": torch.arange(Be, device=DEV) % net.num_mode}
        zero_counts()
        with torch.no_grad():
            ev = net(batch)
        torch.cuda.synchronize()
        eval_counts = counts()
        if eval_counts["mc_gated_matmul"] != per_forward or not torch.isfinite(ev["loss"]):
            bad.append(f"{model} eval batch: {eval_counts}, loss {float(ev['loss'])}")
        sampler, chunk_counts, profiles[model] = pixelcnn_sampler(net, (side, side), out_dir,
                                                                  model, bad)
        exact = pixelcnn_exactness(net, (side, side), bad)
        zero_counts()
        wf = run_sample_calls(model, ctrl, base, out_dir, exp.tag, exp.cfg["data_shape"][-1],
                              bad)
        wf_counts = counts()
        launches[model] = {"trainer": trainer, "eval_batch": eval_counts,
                           "sample_chunk": chunk_counts, "workflows": wf_counts}
        runs[model] = {
            "tag": exp.tag, "steps_per_epoch": PIXELCNN_STEPS, "run_wall_seconds": wall,
            "parameters": sum(p.numel() for p in net.parameters()),
            "compute_dtype": str(net.compute_dtype),
            "train_images_per_s": [s["train_images_per_s"] for s in
                                   exp.epoch_stats + exp3.epoch_stats],
            "eval_images": [s["eval_images"] for s in exp.epoch_stats + exp3.epoch_stats],
            "eval_seconds": [s["eval_seconds"] for s in exp.epoch_stats + exp3.epoch_stats],
            "nll_by_epoch": hist["test/NLL"], "train_nll_by_epoch": hist["train/NLL"],
            "test_model": dict(tested.mean), "resumed_state_equal": not mismatch,
            "sampler": sampler, "exactness": exact, "workflows": wf, "launches": launches[model],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"pixelcnn {model}:", json.dumps(runs[model]))
    log("pixelcnn:", json.dumps({"card": name_limit, "launches": launches}))
    if bad:
        raise SystemExit("pixelcnn failed: " + "; ".join(bad))

    def profile(prof_dir):  # one sampler chunk each, after every timed phase
        out = {}
        for model, run in profiles.items():
            rec = run(prof_dir)
            out[model] = {k: rec[k] for k in ("window_ms", "device_busy_ms", "device_busy_share",
                                              "kernel_launches", "category_ms", "top_kernels")}
        return out

    return launches, runs, profile


def run_real_pixelcnn(name_limit: str, base: list, out_dir: str):
    """MCPixelCNN and CPixelCNN on the codes of the real digits' VQ-VAE
    (``real vae:``'s ``_best``), ``REAL_PIXELCNN_EPOCHS`` epochs each, NLL
    per epoch side by side, and one ``generate`` grid each."""
    runs, bad, launches = {}, [], {}
    for model, ctrl in (("mcpixelcnn", "0.5"), ("cpixelcnn", "None")):
        argv = base + ["--model_name", model, "--control_name", ctrl]
        zero_counts()
        t0 = time.perf_counter()
        (exp,) = cli_train.main(argv + ["--num_epochs", str(REAL_PIXELCNN_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[model] = counts()
        B = exp.cfg["batch_size"]["train"]
        steps = sum(s["train_steps"] for s in exp.epoch_stats)
        evals = sum(-(-s["eval_images"] // B) for s in exp.epoch_stats)
        per_forward = exp.model.num_layer + 1  # 16: the residuals and the head
        want = {"first_dblock": 0, "vq_assign": steps + evals, "vq_ema": 0,
                "mc_gated_matmul": per_forward * evals, "mc_gated_matmul_backward": 0}
        if launches[model] != want:
            bad.append(f"{model}: launches {launches[model]}, want {want}")
        hist = exp.logger.history.get("test/NLL", [])
        if len(hist) != REAL_PIXELCNN_EPOCHS or not all(math.isfinite(x) for x in hist):
            bad.append(f"{model}: NLL {hist}")
        t0 = time.perf_counter()
        cli_sample.main("generate", argv)
        gen_s = time.perf_counter() - t0
        path = vis_path({"output_dir": out_dir}, f"generated_{exp.tag}_10.png")
        png, shape = read_png(path), _grid_shape(10 * exp.cfg["save_per_mode"], 10, 1)
        if png.shape != shape:
            bad.append(f"{path}: {png.shape}, want {shape}")
        runs[model] = {"run_wall_seconds": wall, "steps": steps, "nll_by_epoch": hist,
                       "train_nll_by_epoch": exp.logger.history.get("train/NLL", []),
                       "train_images_per_s": [s["train_images_per_s"] for s in exp.epoch_stats],
                       "generate_seconds": gen_s, "generate_png": list(png.shape),
                       "launches": launches[model]}
    log("real: epoch | MCPixelCNN NLL | CPixelCNN NLL")
    for e in range(REAL_PIXELCNN_EPOCHS):
        log(f"real: {e + 1} | " + " | ".join(
            f"{runs[m]['nll_by_epoch'][e]:.5f}" if e < len(runs[m]["nll_by_epoch"]) else "-"
            for m in ("mcpixelcnn", "cpixelcnn")))
    log("real pixelcnn:", json.dumps({"card": name_limit, **runs}))
    if bad:
        raise SystemExit("real pixelcnn failed: " + "; ".join(bad))
    return launches, runs


# ------------------------------------------------------------------ Glow
def glow_cfg(name: str) -> dict:
    """The CIFAR10 configuration of ``name`` (hidden 512, K 16, L 3, affine,
    LU, rate 0.5) with the Glow trainer's settings and 10 modes."""
    cfg = apply_family_overrides(process_control({
        "data_name": "CIFAR10", "model_name": name, "control": {"controller_rate": "0.5"}}))
    cfg["classes_size"] = 10
    return cfg


def glow_per_step(cfg: dict) -> int:
    """``mc_gated_matmul`` launches per train step: 48 in the forward, and
    48 more where ``remat_flows`` recomputes each flow in the backward."""
    return GLOW_PER_FORWARD * (2 if cfg["glow"].get("remat_flows", True) else 1)


def glow_state(cfg: dict, state: dict, plain: bool) -> TrainState:
    """The model holding ``state`` on the card, through the kernel or its
    plain version, with the Glow trainer's optimizer (Adam 3e-4, clip 1,
    16-step warmup)."""
    model = build_model(cfg, DEV).use_plain_kernels(plain)
    model.load_state_dict(state)
    return TrainState(model, make_optimizer(model.parameters(), cfg, grad_clip=cfg["grad_clip"]))


def glow_steps(ts, batch, noise, step, steps: int, warmup: int) -> tuple[dict, dict]:
    """``warmup`` steps, then ``steps`` timed and counted; returns the
    record and the first step's gradients (before the clip)."""
    first = {}

    def grab(*_):
        if not first:
            first.update({n: p.grad.clone() for n, p in ts.model.named_parameters()
                          if p.grad is not None})

    hook = ts.opt.register_step_pre_hook(grab)
    for _ in range(warmup):
        step(ts, batch, noise=noise)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = [step(ts, batch, noise=noise)["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hook.remove()
    return ({"images_per_s": batch["img"].shape[0] * steps / dt,
             "ms_per_step": dt / steps * 1e3, "launches": counts()["mc_gated_matmul"],
             "backward_launches": counts()["mc_gated_matmul_backward"],
             "bits_per_dim": [float(x) for x in losses]}, first)


def glow_compare(ts_k, ts_p, grads_k, grads_p, cfg: dict, n_steps: int) -> dict:
    """The kernel path against the plain path after ``n_steps`` steps from
    one state: the first step's gradients within ``TRAIN_TOL * max|plain|``
    per tensor (a tensor with none on the plain path has none on the
    kernel's either), every parameter within ``TRAIN_TOL * max|plain|``
    plus ``allowance``, twice the most that the warmed-up Adam updates can
    move a weight (a gradient near 0 may take either sign on either path)."""
    allowance = 2 * cfg["lr"] * sum(min(1.0, (t + 1) / cfg["lr_warmup_steps"])
                                    for t in range(n_steps))
    grad_ratio, zero_mismatch = 0.0, []
    for k, b in grads_p.items():
        top, err = b.abs().max().item(), (grads_k[k] - b).abs().max().item()
        if top == 0:
            if err:
                zero_mismatch.append(k)
            continue
        grad_ratio = max(grad_ratio, err / top)
    param_ratio = 0.0
    sk = ts_k.model.state_dict()
    for k, b in ts_p.model.state_dict().items():
        err = (sk[k].float() - b.float()).abs().max().item()
        param_ratio = max(param_ratio, err / (TRAIN_TOL * b.float().abs().max().item()
                                              + allowance))
    return {"first_grad_worst_ratio": grad_ratio, "zero_grads_differ": zero_mismatch,
            "parameter_worst_share_of_tol": param_ratio, "allowance": allowance,
            "ok": grad_ratio <= TRAIN_TOL and not zero_mismatch and param_ratio <= 1.0}


def glow_sweep(model, n: int, chunk: int, seed: int) -> tuple[float, torch.Tensor]:
    """``generate`` over the class sweep of ``n`` in chunks of ``chunk``, z
    from one generator; returns the seconds and the images."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    C = torch.arange(n, device=DEV) % model.num_mode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [model.generate(C[i:i + chunk], rng=g) for i in range(0, n, chunk)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cat(out)


def glow_kernel_vs_plain_eval(model, batch, noise) -> dict:
    """The eval forward through the kernel and through its plain version on
    a copy of ``model`` whose zero convs hold N(0, 1e-2) weights (after a
    few steps they are still near 0, so the coupling nets barely reach the
    output): z within ``SLICE_TOL * max|plain|`` per level, and the loss."""
    from mcgm_tpu_torch.models.glow import ZeroConv2d

    net = copy.deepcopy(model)
    g = torch.Generator(device=DEV).manual_seed(11)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ZeroConv2d):
                m.conv.weight.normal_(0.0, 1e-2, generator=g)
        got = net.use_plain_kernels(False)(batch, noise=noise)
        want = net.use_plain_kernels(True)(batch, noise=noise)
    torch.cuda.synchronize()
    rec = {"loss": {"kernel": float(got["loss"]), "plain": float(want["loss"])},
           "z_max_abs_err": [(a - b).abs().max().item() for a, b in zip(got["z"], want["z"])],
           "z_max_abs": [b.abs().max().item() for b in want["z"]]}
    rec["ok"] = (all(e <= SLICE_TOL * m for e, m in zip(rec["z_max_abs_err"], rec["z_max_abs"]))
                 and abs(rec["loss"]["kernel"] - rec["loss"]["plain"])
                 <= SLICE_TOL * abs(rec["loss"]["plain"]))
    return rec


def run_glow(name_limit: str, data_dir: str, out_dir: str):
    """MCGlow and CGlow at the CIFAR10 width on seeded CIFAR10-shaped
    images (the same for both): DDI on 8 batches; 3 + 10 steps through the
    kernel and through its plain version in turns from the DDI'd state,
    the first run of each held to the other (losses, parameters after);
    one eval batch of 512 (48 launches); the eval forward held to its plain
    version; ``reverse(forward(x))`` against ``x``; ``generate`` samples/s
    over a sweep of ``GLOW_SWEEP``; then ``cli.train`` (2 epochs of
    ``GLOW_STEPS`` steps, DDI first), ``resume_mode=1`` to epoch 3 with the
    state checked equal, and ``cli.test_model``."""
    g = torch.Generator(device=DEV).manual_seed(0)
    n_ddi = 8 * 128
    big = {"img": torch.rand((n_ddi, 32, 32, 3), generator=g, device=DEV) * 2 - 1,
           "label": torch.arange(n_ddi, device=DEV) % 10}
    big_noise = torch.rand((n_ddi, 32, 32, 3), generator=g, device=DEV)
    batch = {k: v[:128] for k, v in big.items()}
    noise = torch.rand((128, 32, 32, 3), generator=g, device=DEV)
    step = make_train_step(skip_nonfinite=True)
    base = ["--data_name", "CIFAR10", "--data_dir", data_dir, "--output_dir", out_dir,
            "--device", str(DEV)]
    runs, bad, launches, profiles = {}, [], {}, {}
    for name, ctrl in (("mcglow", "0.5"), ("cglow", "None")):
        cfg = glow_cfg(name)
        per_step = glow_per_step(cfg)
        model = build_model(cfg, DEV)
        with torch.no_grad():
            model(big, train=True, ddi=True, noise=big_noise)
        state = {k: t.clone() for k, t in model.state_dict().items()}
        del model
        torch.cuda.reset_peak_memory_stats()
        steps, first = {False: [], True: []}, {}
        for plain in (False, True, True, False):
            ts = glow_state(cfg, state, plain)
            res, grads = glow_steps(ts, batch, noise, step, TRAIN_STEPS, TRAIN_WARMUP)
            want = 0 if plain else per_step * TRAIN_STEPS
            want_bwd = 0 if plain else GLOW_PER_FORWARD * TRAIN_STEPS
            if res["launches"] != want or res["backward_launches"] != want_bwd \
                    or not all(math.isfinite(x) for x in res["bits_per_dim"]):
                bad.append(f"{name} {'plain' if plain else 'kernel'} path: {res}, want {want} "
                           f"and {want_bwd} backward")
            steps[plain].append(res)
            first.setdefault(plain, (ts, grads))
            log(f"glow {name} {'plain' if plain else 'kernel'}:", json.dumps(res))
        (ts_k, grads_k), (ts_p, grads_p) = first[False], first[True]
        cmp = glow_compare(ts_k, ts_p, grads_k, grads_p, cfg, TRAIN_WARMUP + TRAIN_STEPS)
        del grads_k, grads_p, first
        lk, lp = steps[False][0]["bits_per_dim"][-1], steps[True][0]["bits_per_dim"][-1]
        cmp["bits_per_dim"] = {"kernel": lk, "plain": lp}
        if not (abs(lk - lp) <= TRAIN_TOL * abs(lp) and cmp["ok"]):
            bad.append(f"{name} kernel vs plain after {TRAIN_WARMUP + TRAIN_STEPS} steps: {cmp}")
        model = ts_k.model
        # one eval batch at the eval batch size: 48 launches
        Be = cfg["batch_size"]["test"]
        ev_batch = {"img": torch.rand((Be, 32, 32, 3), generator=g, device=DEV) * 2 - 1,
                    "label": torch.arange(Be, device=DEV) % 10}
        zero_counts()
        with torch.no_grad():
            ev = model(ev_batch, rng=g)
        torch.cuda.synchronize()
        eval_counts = counts()
        if eval_counts["mc_gated_matmul"] != GLOW_PER_FORWARD or not torch.isfinite(ev["loss"]):
            bad.append(f"{name} eval batch: {eval_counts}, loss {float(ev['loss'])}")
        eval_cmp = glow_kernel_vs_plain_eval(model, batch, noise)
        if not eval_cmp["ok"]:
            bad.append(f"{name} eval forward kernel vs plain: {eval_cmp}")
        with torch.no_grad():
            z = model(batch, noise=noise)["z"]
            recon = model.reverse(z, batch["label"], reconstruct=True)
        x = torch.clamp(batch["img"] * 0.5 + noise / 256.0, -0.5, 0.5) * 2.0
        recon_err = (recon - x).abs().max().item()
        if not recon_err <= GLOW_RECON_TOL:
            bad.append(f"{name} reverse(forward(x)) off by {recon_err}")
        zero_counts()
        sweeps = [glow_sweep(model, GLOW_SWEEP, GLOW_CHUNK, seed) for seed in range(3)]
        sweep_counts = counts()
        chunks = -(-GLOW_SWEEP // GLOW_CHUNK)
        if sweep_counts["mc_gated_matmul"] != 3 * chunks * GLOW_PER_FORWARD:
            bad.append(f"{name} generate: launches {sweep_counts}")
        finite = float(torch.isfinite(sweeps[0][1]).all(dim=(1, 2, 3)).float().mean())
        sweep_s = statistics.median(s for s, _ in sweeps)
        # the trainer, as a user runs it
        argv = base + ["--model_name", name, "--control_name", ctrl]
        zero_counts()
        t0 = time.perf_counter()
        (exp,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS)],
                                limit_train_batches=GLOW_STEPS,
                                limit_eval_batches=GLOW_EVAL_BATCHES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer = counts()
        B = exp.cfg["batch_size"]["train"]
        n_steps = sum(st["train_steps"] for st in exp.epoch_stats)
        evals = sum(-(-st["eval_images"] // B) for st in exp.epoch_stats)
        want = {"first_dblock": 0, "vq_assign": 0, "vq_ema": 0,
                "mc_gated_matmul": per_step * n_steps + GLOW_PER_FORWARD * evals,
                "mc_gated_matmul_backward": GLOW_PER_FORWARD * n_steps}
        if trainer != want:
            bad.append(f"{name} trainer: launches {trainer}, want {want}")
        saved = to_numpy(exp.state_dict())
        (exp3,) = cli_train.main(argv + ["--num_epochs", str(TRAINER_EPOCHS + 1),
                                         "--resume_mode", "1"],
                                 limit_train_batches=GLOW_STEPS,
                                 limit_eval_batches=GLOW_EVAL_BATCHES)
        resumed = exp3.resumed or {}
        mismatch = _state_mismatch(saved, resumed["state"]) if resumed else ["nothing resumed"]
        if mismatch:
            bad.append(f"{name}: resumed state differs at {mismatch[:8]}")
        (tested,) = cli_test_model.main(argv, limit_eval_batches=GLOW_EVAL_BATCHES)
        hist = _history(exp3, ("train/Loss", "test/Loss"))
        if any(len(v) != TRAINER_EPOCHS + 1 or not all(math.isfinite(x) for x in v)
               for v in hist.values()):
            bad.append(f"{name}: bits/dim not finite every epoch: {hist}")
        stats = exp.epoch_stats + exp3.epoch_stats
        launches[name] = {"step": steps[False][0]["launches"],
                          "step_backward": steps[False][0]["backward_launches"],
                          "eval_batch": eval_counts,
                          "generate_sweeps": sweep_counts, "trainer": trainer}
        runs[name] = {
            "parameters": sum(p.numel() for p in model.parameters()),
            "compute_dtype": str(model.compute_dtype), "batch": 128,
            "remat_flows": bool(cfg["glow"].get("remat_flows", True)),
            "kernel_images_per_s": [r["images_per_s"] for r in steps[False]],
            "plain_images_per_s": [r["images_per_s"] for r in steps[True]],
            "kernel_ms_per_step": [r["ms_per_step"] for r in steps[False]],
            "plain_ms_per_step": [r["ms_per_step"] for r in steps[True]],
            "bits_per_dim": steps[False][0]["bits_per_dim"],
            "launches_per_step": steps[False][0]["launches"] / TRAIN_STEPS,
            "backward_launches_per_step": steps[False][0]["backward_launches"] / TRAIN_STEPS,
            "kernel_vs_plain": cmp, "eval_kernel_vs_plain": eval_cmp,
            "eval_batch_bits_per_dim": float(ev["loss"]),
            "reconstruction_max_abs_err": recon_err,
            "generate_samples_per_s": GLOW_SWEEP / sweep_s,
            "generate_seconds": [s for s, _ in sweeps], "generate_finite_share": finite,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "trainer": {"wall_seconds": wall, "steps": n_steps, "eval_batches": evals,
                        "train_images_per_s": [st["train_images_per_s"] for st in stats],
                        "eval_seconds": [st["eval_seconds"] for st in stats],
                        "bits_per_dim_by_epoch": hist["test/Loss"],
                        "train_bits_per_dim_by_epoch": hist["train/Loss"],
                        "test_model": dict(tested.mean), "resumed_state_equal": not mismatch}}
        log(f"glow {name}:", json.dumps(runs[name]))

        profiles[name] = (ts_k, ts_p)
    log("glow:", json.dumps({"card": name_limit, "launches": launches}))
    if bad:
        raise SystemExit("glow failed: " + "; ".join(bad))

    def profile(prof_dir):  # one step of each path per model, after every timed phase
        out = {}
        run_step = functools.partial(step, noise=noise)
        for name, pair in profiles.items():
            for path, ts in zip(("kernel", "plain"), pair):
                zero_counts()
                rec = train_profile_single(ts, batch, run_step, prof_dir, f"glow_{name}_{path}",
                                           detail=(MATMUL_CATEGORY,))
                out[f"{name}_{path}"] = dict(rec, mc_gated_matmul_launches=counts()[
                    "mc_gated_matmul"], mc_gated_matmul_backward_launches=counts()[
                    "mc_gated_matmul_backward"])
        return out

    return launches, runs, profile


def run_real_glow(name_limit: str, base: list, out_dir: str):
    """MCGlow and CGlow at full width on the real digits (32x32x1),
    ``REAL_GLOW_EPOCHS`` epochs each (DDI first), bits/dim per epoch on the
    train split side by side, and the five ``cli.sample`` calls on each
    ``_best``."""
    runs, bad, launches = {}, [], {}
    for name, ctrl in (("mcglow", "0.5"), ("cglow", "None")):
        argv = base + ["--model_name", name, "--control_name", ctrl]
        zero_counts()
        t0 = time.perf_counter()
        (exp,) = cli_train.main(argv + ["--num_epochs", str(REAL_GLOW_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer = counts()
        B = exp.cfg["batch_size"]["train"]
        steps = sum(st["train_steps"] for st in exp.epoch_stats)
        evals = sum(-(-st["eval_images"] // B) for st in exp.epoch_stats)
        want = {"first_dblock": 0, "vq_assign": 0, "vq_ema": 0,
                "mc_gated_matmul": glow_per_step(exp.cfg) * steps + GLOW_PER_FORWARD * evals,
                "mc_gated_matmul_backward": GLOW_PER_FORWARD * steps}
        if trainer != want:
            bad.append(f"{name}: launches {trainer}, want {want}")
        hist = exp.logger.history.get("test/Loss", [])
        if len(hist) != REAL_GLOW_EPOCHS or not all(math.isfinite(x) for x in hist):
            bad.append(f"{name}: bits/dim {hist}")
        zero_counts()
        wf = run_sample_calls(name, ctrl, base, out_dir, exp.tag, 1, bad,
                              finite_min=GLOW_FINITE_MIN)
        launches[name] = {"trainer": trainer, "workflows": counts()}
        runs[name] = {"run_wall_seconds": wall, "steps": steps, "bits_per_dim_by_epoch": hist,
                      "train_bits_per_dim_by_epoch": exp.logger.history.get("train/Loss", []),
                      "skipped_share_by_epoch": exp.logger.history.get("train/SkipUpd", []),
                      "train_images_per_s": [st["train_images_per_s"]
                                             for st in exp.epoch_stats],
                      "workflows": wf, "launches": launches[name]}
    log("real: epoch | MCGlow bits/dim | CGlow bits/dim")
    for e in range(REAL_GLOW_EPOCHS):
        log(f"real: {e + 1} | " + " | ".join(
            f"{runs[m]['bits_per_dim_by_epoch'][e]:.5f}"
            if e < len(runs[m]["bits_per_dim_by_epoch"]) else "-" for m in ("mcglow", "cglow")))
    log("real glow:", json.dumps({"card": name_limit, **runs}))
    if bad:
        raise SystemExit("real glow failed: " + "; ".join(bad))
    return launches, runs


# ---------------------------------------------------------------- scores
def _timed_call(steps: dict, name: str, images: int, fn):
    """Run ``fn`` (a CLI's ``main``) to its end on the card; record its
    seconds and images/s under ``steps[name]``; return what it returned."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps[name] = {"seconds": dt, "images": images, "images_per_s": images / dt}
    return out


def run_scores_cifar10(name_limit: str, data_dir: str, out_dir: str) -> dict:
    """The offline scorers at InceptionV3's full width, in the trainer's
    folder: ``cli.make_stats stats`` over the 50,000 CIFAR10-shaped train
    images (the seeded InceptionV3 that ``write_trainer_inputs`` saved), a
    10,000-image ``generate --save_npy true`` dump of the trainer's MCGAN
    ``_best``, ``cli.test_generated generated`` on it (IS in 10 splits, FID
    against the stats file), and the same again with the stats file set
    aside, so that the FID's real side is a fresh sweep of the train split."""
    argv = ["--data_name", "CIFAR10", "--model_name", "mcgan", "--control_name", "0.5",
            "--data_dir", data_dir, "--output_dir", out_dir, "--device", str(DEV)]
    steps, n_real, n_dump = {}, TRAINER_IMAGES["train"], 10 * 1000
    zero_counts()  # the counted run of the scoring path
    stats_path = _timed_call(steps, "make_stats", n_real, lambda: cli_make_stats.main(
        "stats", argv))
    (dump,) = _timed_call(steps, "generate", n_dump, lambda: cli_sample.main(
        "generate", argv + ["--save_npy", "true"]))
    (score,) = _timed_call(steps, "test_generated", n_dump, lambda: cli_test_generated.main(
        "generated", argv))
    os.replace(stats_path, stats_path + ".aside")
    try:
        (fresh,) = _timed_call(steps, "test_generated_fresh_sweep", n_real + n_dump,
                               lambda: cli_test_generated.main("generated", argv))
    finally:
        os.replace(stats_path + ".aside", stats_path)
    launches = counts()
    with np.load(stats_path) as z:
        stats_shapes = [list(z["mu"].shape), list(z["sigma"].shape)]
    rec = {"card": name_limit, "steps": steps, "dump": list(np.shape(dump)),
           "images_scored": score["images"], "is_10_splits": score["InceptionScore"],
           "fid_stats_file": score["FID"], "fid_fresh_sweep": fresh["FID"],
           "fid_relative_gap": abs(score["FID"] - fresh["FID"]) / abs(fresh["FID"]),
           "stats_shapes": stats_shapes, "launches": launches}
    log("scores cifar10:", json.dumps(rec))
    values = (score["InceptionScore"], score["FID"], fresh["FID"], fresh["InceptionScore"])
    bad = []
    if not all(math.isfinite(v) for v in values):
        bad.append(f"scores not finite: {values}")
    if np.shape(dump) != (n_dump, 3, 32, 32) or score["images"] != n_dump:
        bad.append(f"dump {np.shape(dump)}, {score['images']} images scored")
    if stats_shapes != [[2048], [2048, 2048]]:
        bad.append(f"stats file shapes {stats_shapes}")
    if any(launches.values()):
        bad.append(f"hand kernels launched {launches} (G and InceptionV3 have none)")
    if bad:
        raise SystemExit("scores cifar10 failed: " + "; ".join(bad))
    return rec


# (family, MC model and control, C model and control) of the paper's table
SCORED_FAMILIES = (("GAN", ("mcgan", "0.5"), ("cgan", "0.5")),
                   ("VAE", ("mcvae", "0.5"), ("cvae", "None")),
                   ("PixelCNN", ("mcpixelcnn", "0.5"), ("cpixelcnn", "None")),
                   ("Glow", ("mcglow", "0.5"), ("cglow", "None")))
CURVE_METRICS = ("test/InceptionScore", "test/FID", "test/BCE", "test/MSE", "test/NLL",
                 "test/Loss", "test/Accuracy")


def run_scores_real(name_limit: str, base: list, out_dir: str):
    """The paper's scores on the real digits: ``cli.make_stats stats``
    (the classifier's features), then for each of the eight generative
    models' ``_best`` its ``generated_`` and ``created_`` dumps (drawn with
    ``cli.sample ... --save_npy true`` where the earlier phases drew none:
    the VAEs and the PixelCNNs) scored by ``cli.test_generated generated``
    (IS, 10 splits; FID) and ``created`` (DBI); then ``report.process``,
    ``make_vis`` and the learning curves' JSON. Returns the launches (the
    PixelCNN dumps run ``mc_gated_matmul``) and the record."""
    steps, bad, table = {}, [], {}
    zero_counts()  # the counted run of the scoring path
    _timed_call(steps, "make_stats", REAL_TRAIN, lambda: cli_make_stats.main("stats", base))
    for family, *models in SCORED_FAMILIES:
        for model, ctrl in models:
            argv = base + ["--model_name", model, "--control_name", ctrl]
            tag = "_".join(["0", "MNIST", "label", model] + ([ctrl] if ctrl != "None" else []))
            for wf, dump in (("generate", "generated"), ("create", "created")):
                if not os.path.exists(os.path.join(out_dir, "npy", f"{dump}_{tag}.npy")):
                    _timed_call(steps, f"{model} {wf}", 10 * 1000, lambda: cli_sample.main(
                        wf, argv + ["--save_npy", "true"]))
            (gen,) = _timed_call(steps, f"{model} test_generated", 10 * 1000,
                                 lambda: cli_test_generated.main("generated", argv))
            (cre,) = _timed_call(steps, f"{model} test_created", 10 * 1000,
                                 lambda: cli_test_generated.main("created", argv))
            table[model] = {"IS": gen["InceptionScore"], "FID": gen["FID"], "DBI": cre["DBI"],
                            "generated_kept": gen["images"], "created_kept": cre["images"]}
            if not all(math.isfinite(table[model][k]) for k in ("IS", "FID", "DBI")):
                bad.append(f"{model}: scores not finite {table[model]}")
            if min(gen["images"], cre["images"]) < GLOW_FINITE_MIN * 10 * 1000:
                bad.append(f"{model}: too few finite images {gen['images']}, {cre['images']}")
    launches = counts()
    summary = _timed_call(steps, "process", 0, lambda: report_process.process(out_dir))
    vis = report_process.make_vis(summary, out_dir)
    curves = learning_curve.plot_curves(out_dir, CURVE_METRICS)
    with open(os.path.join(out_dir, "processed_result.json")) as f:
        processed = json.load(f)
    for family, *models in SCORED_FAMILIES:
        for model, ctrl in models:
            cell = "_".join(["MNIST", "label", model] + ([ctrl] if ctrl != "None" else []))
            have = processed.get(cell, {})
            for metric in ("generated/InceptionScore", "generated/FID", "created/DBI"):
                mean = have.get(metric, {}).get("mean")
                if mean is None or not math.isfinite(mean):
                    bad.append(f"processed_result.json: {cell} {metric} {mean}")
            for kind in ("is_generated", "fid_generated", "dbi_created"):
                if not os.path.exists(os.path.join(out_dir, "result", f"{kind}_0_{cell}.npy")):
                    bad.append(f"no result file {kind}_0_{cell}.npy")
    if "test/Accuracy" not in processed.get("MNIST_label_classifier", {}):
        bad.append("processed_result.json: no classifier cell")
    with open(vis) as f:
        vis_lines = f.read().splitlines()[1:]
    if len(vis_lines) != 3 * 8 or not all("mcgm_tpu_torch.cli.sample" in v for v in vis_lines):
        bad.append(f"vis.sh: {len(vis_lines)} lines")
    if len(curves) != len(CURVE_METRICS):
        bad.append(f"curves: {[os.path.basename(c) for c in curves]}")
    if launches["mc_gated_matmul"] == 0:
        bad.append("the PixelCNN dumps launched no mc_gated_matmul")
    log("scores real: family | MC IS, FID, DBI | C IS, FID, DBI (classifier features, "
        "one seed)")
    for family, (mc, _), (c, _) in SCORED_FAMILIES:
        cols = [" ".join(f"{table[m][k]:.4f}" for k in ("IS", "FID", "DBI")) if m in table
                else "-" for m in (mc, c)]
        log(f"scores real: {family} | {cols[0]} | {cols[1]}")
    rec = {"card": name_limit, "steps": steps, "table": table, "launches": launches,
           "cells": sorted(processed), "vis_lines": len(vis_lines),
           "curves": [os.path.basename(c) for c in curves]}
    log("scores real:", json.dumps(rec))
    if bad:
        raise SystemExit("scores real failed: " + "; ".join(bad))
    return launches, rec

# ------------------------------------------------- the steps' last options
def _peak_gib(fn) -> float:
    """The most device memory ``fn`` allocates above what was allocated
    before it (the model, its optimizer and gradients, and what earlier
    phases keep), GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def _grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


def _worst_ratio(got: dict, want: dict) -> tuple[float, str | None]:
    """The largest ``max|got - want| / max|want|`` over the tensors of
    ``want`` (a tensor that is 0 in ``want`` must be 0 in ``got``)."""
    worst, at = 0.0, None
    for k, w in want.items():
        top, err = w.float().abs().max().item(), (got[k].float() - w.float()).abs().max().item()
        r = err / top if top > 0 else (math.inf if err else 0.0)
        if r >= worst:
            worst, at = r, k
    return worst, at


def _rebuilt_flow_inputs(ts, batch, noise, step, K: int) -> tuple[dict, list]:
    """One step of ``ts`` (a Glow with ``reversible_flows``) that records
    each flow's input in the forward and as the reversible backward rebuilds
    it; returns the step's result and the relative error of each rebuilt
    input (max abs error over the input's max abs), in forward order."""
    from mcgm_tpu_torch.models.glow import Flow
    from mcgm_tpu_torch.ops import reversible as prev

    inputs = []
    hooks = [m.register_forward_pre_hook(lambda mod, a: inputs.append(a[0].detach().clone()))
             for m in ts.model.modules() if isinstance(m, Flow)]
    prev.RECONSTRUCTED = []
    try:
        res = step(ts, batch, noise=noise)
        torch.cuda.synchronize()
        rebuilt = prev.RECONSTRUCTED
    finally:
        prev.RECONSTRUCTED = None
        for h in hooks:
            h.remove()
    # the backward visits the blocks last to first, each block's flows last to first
    blocks = [rebuilt[i:i + K] for i in range(0, len(rebuilt), K)][::-1]
    flat = [x for blk in blocks for _, x in blk[::-1]]
    if len(flat) != len(inputs):
        raise SystemExit(f"glow reversible: rebuilt {len(flat)} flow inputs of {len(inputs)}")
    return res, [(a - b).abs().max().item() / a.abs().max().item() for a, b in zip(inputs, flat)]


def run_glow_reversible(name_limit: str):
    """MCGlow and CGlow at the CIFAR10 width (hidden 512, K 16, L 3, B=128,
    bf16 convs, through ``mc_gated_matmul``) from one DDI'd state: 3 + 10
    steps with no remat, with ``remat_flows`` and with ``reversible_flows``
    (images/s, launches a step, the peak memory of a step); then, from the
    state the ``remat_flows`` run reached (the zero convs grown by 13
    updates), one step with each of the two: bits/dim, and every gradient
    within ``TRAIN_TOL * max|remat|`` over all the gradients (per tensor
    the worst ratio is reported: a coupling net's weights whose gradients
    are ~1e-4 of the largest are a near-cancelling sum, which the rebuild's
    rounding moves by a few percent of themselves), and each flow input as
    the reversible backward rebuilds it within ``GLOW_RECON_TOL`` of the one
    the forward saw (worst over the 48 flows). Reported, not checked: the
    rebuild from the DDI'd state with every zero conv N(0, 1e-2) (couplings
    whose ``s`` reaches far below 1, so f32 rounding compounds over the
    flows)."""
    from mcgm_tpu_torch.models.glow import ZeroConv2d

    g = torch.Generator(device=DEV).manual_seed(21)
    batch = {"img": torch.rand((128, 32, 32, 3), generator=g, device=DEV) * 2 - 1,
             "label": torch.arange(128, device=DEV) % 10}
    noise = torch.rand((128, 32, 32, 3), generator=g, device=DEV)
    step = make_train_step(skip_nonfinite=True)
    opts = {"none": dict(remat_flows=False, reversible_flows=False),
            "remat_flows": dict(remat_flows=True, reversible_flows=False),
            "reversible_flows": dict(remat_flows=False, reversible_flows=True)}
    out, bad, launches = {}, [], {}
    for name in ("mcglow", "cglow"):
        cfg = glow_cfg(name)
        K = cfg["glow"]["K"]
        model = build_model(cfg, DEV)
        with torch.no_grad():
            model(batch, train=True, ddi=True, noise=noise)
        state0 = {k: t.clone() for k, t in model.state_dict().items()}

        def fresh(opt, state):
            for k, v in opts[opt].items():  # the flags build_model sets from the config
                setattr(model, k, v)
            model.load_state_dict(state)
            return TrainState(model, make_optimizer(model.parameters(), cfg,
                                                    grad_clip=cfg["grad_clip"]))

        rec, state1 = {}, None
        for opt in opts:
            ts = fresh(opt, state0)
            timed, _ = glow_steps(ts, batch, noise, step, TRAIN_STEPS, TRAIN_WARMUP)
            rec[opt] = {"images_per_s": timed["images_per_s"], "ms_per_step": timed["ms_per_step"],
                        "launches_per_step": timed["launches"] / TRAIN_STEPS,
                        "backward_launches_per_step": timed["backward_launches"] / TRAIN_STEPS,
                        "bits_per_dim": timed["bits_per_dim"][-1],
                        "peak_mem_gib": _peak_gib(lambda: step(ts, batch, noise=noise))}
            if opt == "remat_flows":
                state1 = {k: t.clone() for k, t in model.state_dict().items()}
            del ts
            torch.cuda.empty_cache()
        first = {}
        for opt in ("remat_flows", "reversible_flows"):
            ts = fresh(opt, state1)
            zero_counts()
            if opt == "reversible_flows":
                res, errs = _rebuilt_flow_inputs(ts, batch, noise, step, K)
                rec[opt]["reconstruction_rel_err_by_flow"] = errs
                rec[opt]["reconstruction_worst_rel_err"] = max(errs)
            else:
                res = step(ts, batch, noise=noise)
                torch.cuda.synchronize()
            rec[opt]["step_launches"] = counts()["mc_gated_matmul"]
            rec[opt]["step_backward_launches"] = counts()["mc_gated_matmul_backward"]
            rec[opt]["step_bits_per_dim"] = float(res["loss"])
            rec[opt]["step_skipped"] = float(res["skipped"])
            first[opt] = _grads_of(model)
            model.zero_grad(set_to_none=True)
            del ts
        worst, at = _worst_ratio(first["reversible_flows"], first["remat_flows"])
        lr_, lv = rec["remat_flows"]["step_bits_per_dim"], rec["reversible_flows"]["step_bits_per_dim"]
        ratios = sorted(((first["reversible_flows"][k] - w).abs().max().item()
                         / max(w.abs().max().item(), 1e-30), k, w.abs().max().item())
                        for k, w in first["remat_flows"].items())[::-1]
        top_all = max(w.abs().max().item() for w in first["remat_flows"].values())
        err_all = max((first["reversible_flows"][k] - w).abs().max().item()
                      for k, w in first["remat_flows"].items())
        cmp = {"grad_err_share_of_max": err_all / top_all, "grad_max_abs": top_all,
               "grad_worst_ratio_per_tensor": worst, "grad_worst_at": at,
               "grad_ratios_top": [[r, k, top] for r, k, top in ratios[:6]],
               "grad_ratio_median": ratios[len(ratios) // 2][0],
               "bits_per_dim": {"remat_flows": lr_, "reversible_flows": lv}}
        del first
        # the stress case: every zero conv N(0, 1e-2) on the DDI'd state
        ts = fresh("reversible_flows", state0)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, ZeroConv2d):
                    m.conv.weight.normal_(0.0, 1e-2, generator=g)
        res, errs = _rebuilt_flow_inputs(ts, batch, noise, step, K)
        stress = {"reconstruction_rel_err_by_flow": errs, "skipped": float(res["skipped"])}
        del ts, model
        torch.cuda.empty_cache()
        if not (err_all <= TRAIN_TOL * top_all and abs(lv - lr_) <= TRAIN_TOL * abs(lr_)):
            bad.append(f"{name} reversible vs remat_flows: {cmp}")
        want = {"none": GLOW_PER_FORWARD, "remat_flows": 2 * GLOW_PER_FORWARD,
                "reversible_flows": 2 * GLOW_PER_FORWARD}
        for opt, n in want.items():
            if rec[opt]["launches_per_step"] != n or rec[opt].get("step_launches", n) != n \
                    or rec[opt]["backward_launches_per_step"] != GLOW_PER_FORWARD \
                    or rec[opt].get("step_backward_launches", GLOW_PER_FORWARD) \
                    != GLOW_PER_FORWARD or rec[opt].get("step_skipped"):
                bad.append(f"{name} {opt}: {rec[opt]}, want {n} launches a step")
        if not rec["reversible_flows"]["reconstruction_worst_rel_err"] <= GLOW_RECON_TOL:
            bad.append(f"{name}: a rebuilt flow input is off by "
                       f"{rec['reversible_flows']['reconstruction_worst_rel_err']}")
        launches[name] = {"forward": rec["reversible_flows"]["step_launches"],
                          "backward": rec["reversible_flows"]["step_backward_launches"]}
        out[name] = dict(rec, reversible_vs_remat=cmp, stress_random_zero_convs=stress)
        log(f"glow reversible {name}:", json.dumps({"card": name_limit, "batch": 128, **out[name]}))
    if bad:
        raise SystemExit("glow reversible failed: " + "; ".join(bad))
    return launches, out


def _gan_state_errs(state: dict, ref: dict, lr: float, d_iter: int) -> dict:
    """Per kind (parameters, BatchNorm statistics, ``u``), the worst
    ``max|state - ref|`` over ``TRAIN_TOL * max|ref|`` (parameters: plus
    ``2 lr`` per Adam update the tensor took, the reach of an update whose
    gradient is near 0 and takes the other sign)."""
    worst = {"parameters": 0.0, "batch_stats": 0.0, "u": 0.0}
    for k, b in ref.items():
        kind = ("batch_stats" if k.endswith(("running_mean", "running_var"))
                else "u" if k.endswith(".u") else "parameters")
        if kind == "parameters" and k.endswith("codebook"):
            continue
        updates = d_iter if k.startswith("discriminator") else 1
        allowance = 2 * lr * updates if kind == "parameters" else 0.0
        err = (state[k].float() - b.float()).abs().max().item()
        worst[kind] = max(worst[kind], err / (TRAIN_TOL * b.float().abs().max().item()
                                              + allowance + 1e-30))
    return worst


def run_gan_fused(name_limit: str):
    """The CIFAR10 MCGAN step (B=128, ``d_iter`` 5) with ``fuse_g_pass``,
    with ``remat`` and with both, from one state and z:

    - ``remat`` against the plain step and both against ``fuse_g_pass``:
      losses within ``TRAIN_TOL`` of the largest, parameters, BatchNorm
      statistics and ``u`` within ``TRAIN_TOL * max|ref|`` (parameters plus
      the Adam updates' reach);
    - the fused G pass's fakes against the plain step's ``d_iter``
      ``generate`` calls within ``KERNEL_TOL * max|plain|`` (bf16 convs at
      another batch round otherwise), its BatchNorm statistics and the
      step's ``Loss_D``, parameters and ``u`` against the plain step's as
      above;
    - the fused step against the plain step fed the fused pass's fakes:
      every loss, parameters, ``u`` as above. ``Loss_G`` of the fused step
      against the plain one is reported with the plain step's own change
      when its fakes move by one bf16 unit (the d_iter Adam updates of D
      amplify either);

    then images/s over 3 + 10 steps, ``first_dblock`` launches a step and
    the peak memory of a step, for each."""
    cfg = train_gan.bench_config()
    lr, d_iter = train_gan.LR, train_gan.D_ITER
    flags = {"plain": {}, "fuse_g_pass": dict(fuse_g_pass=True), "remat": dict(remat=True),
             "both": dict(fuse_g_pass=True, remat=True)}
    g = torch.Generator(device=DEV).manual_seed(7)
    rec, bad, launches, after, fakes = {}, [], {}, {}, {}

    def one_step(f, fed=None):
        """One step from the seeded state; ``fed``: the fakes the D passes'
        ``generate`` calls return (G still runs, so its statistics move)."""
        ts, batch = train_gan.bench_state(cfg, DEV)
        model, real = ts.model, ts.model.generate
        seen = []

        def generate(C, zz, train=False):
            x = real(C, zz, train)
            if torch.is_grad_enabled() or len(seen) >= d_iter:
                return x
            seen.append(x.detach().clone())
            return fed[len(seen) - 1] if fed is not None else x

        model.generate = generate
        zero_counts()
        got = make_gan_train_step(d_iter, **f)(ts, batch, z=z)
        torch.cuda.synchronize()
        n = counts()["first_dblock"]
        model.generate = real
        return (ts, batch, {k: float(v) for k, v in got.items()}, n,
                {k: t.detach().clone() for k, t in model.state_dict().items()}, seen)

    z = [torch.randn((cfg["batch_size"]["train"], cfg["gan"]["latent_size"]), generator=g,
                     device=DEV) for _ in range(d_iter + 1)]
    for name, f in flags.items():
        ts, batch, losses, n, state, seen = one_step(f)
        after[name] = (losses, state)
        if name == "plain":
            fakes["plain"] = seen
        r = {"launches": n, "losses": losses}
        want = (d_iter + 1) * (2 if f.get("remat") else 1)
        if n != want:
            bad.append(f"{name}: {n} first_dblock launches a step, want {want}")
        step = make_gan_train_step(d_iter, **f)
        timed = train_gan.time_steps(ts, batch, step, TRAIN_STEPS, TRAIN_WARMUP)
        zero_counts()
        r.update(images_per_s=timed["images_per_sec"], ms_per_step=timed["ms_per_step"],
                 peak_mem_gib=_peak_gib(lambda: step(ts, batch)))
        r["launches_per_step_timed"] = timed["first_dblock_launches_per_step"]
        rec[name] = r
        launches[name] = n
        del ts, batch
        torch.cuda.empty_cache()
    # the fused pass's fakes, out of the fused model's own pass
    ts, batch = train_gan.bench_state(cfg, DEV)
    with torch.no_grad(), batch_stat_slices(ts.model.generator, d_iter):
        fused = ts.model.generate(batch["label"].repeat(d_iter), torch.cat(z[:d_iter]),
                                  train=True).chunk(d_iter)
    del ts
    fake_err = max((a - b).abs().max().item() for a, b in zip(fused, fakes["plain"]))
    fake_top = max(b.abs().max().item() for b in fakes["plain"])
    _, _, fed_losses, _, fed_state, _ = one_step({}, fed=list(fused))
    ulp = torch.Generator(device=DEV).manual_seed(3)
    nudged = [x + torch.randint(-1, 2, x.shape, generator=ulp, device=DEV) * 2.0 ** -8 * x.abs()
              for x in fakes["plain"]]
    _, _, nudged_losses, _, _, _ = one_step({}, fed=nudged)

    def losses_err(a, b):
        scale = max(abs(v) for v in b.values())
        return max(abs(a[k] - v) for k, v in b.items()) / scale

    checks = {
        "remat_vs_plain": (losses_err(after["remat"][0], after["plain"][0]),
                           _gan_state_errs(after["remat"][1], after["plain"][1], lr, d_iter)),
        "both_vs_fuse_g_pass": (losses_err(after["both"][0], after["fuse_g_pass"][0]),
                                _gan_state_errs(after["both"][1], after["fuse_g_pass"][1], lr,
                                                d_iter)),
        "fuse_g_pass_vs_plain_fed_its_fakes": (
            losses_err(after["fuse_g_pass"][0], fed_losses),
            _gan_state_errs(after["fuse_g_pass"][1], fed_state, lr, d_iter)),
    }
    fused_vs_plain = _gan_state_errs(after["fuse_g_pass"][1], after["plain"][1], lr, d_iter)
    scale = max(abs(v) for v in after["plain"][0].values())
    loss_d_err = abs(after["fuse_g_pass"][0]["Loss_D"] - after["plain"][0]["Loss_D"]) / scale
    cmp = {k: {"loss_err_share_of_scale": e, "worst_share_of_tol": w}
           for k, (e, w) in checks.items()}
    cmp["fuse_g_pass_vs_plain"] = {
        "fakes_max_abs_err": fake_err, "fakes_max_abs": fake_top,
        "loss_d_err_share_of_scale": loss_d_err, "worst_share_of_tol": fused_vs_plain,
        "loss_g": {"fuse_g_pass": after["fuse_g_pass"][0]["Loss_G"],
                   "plain": after["plain"][0]["Loss_G"],
                   "plain_fakes_moved_one_bf16_unit": nudged_losses["Loss_G"]}}
    for k, (e, w) in checks.items():
        if not (e <= TRAIN_TOL and max(w.values()) <= 1.0):
            bad.append(f"{k}: {cmp[k]}")
    if not (fake_err <= KERNEL_TOL * fake_top and loss_d_err <= TRAIN_TOL
            and max(fused_vs_plain.values()) <= 1.0):
        bad.append(f"fuse_g_pass vs plain: {cmp['fuse_g_pass_vs_plain']}")
    log("gan fused g pass:", json.dumps({"card": name_limit, "batch": cfg["batch_size"]["train"],
                                         "d_iter": d_iter, **rec, "checks": cmp}))
    if bad:
        raise SystemExit("gan fused g pass failed: " + "; ".join(bad))
    return launches, rec


def _single_cfg(name: str) -> dict:
    cfg = apply_family_overrides(process_control({
        "data_name": "CIFAR10", "model_name": name, "ae_name": "vqvae",
        "control": {"controller_rate": "0.5"} if name.startswith("mc") else {}}))
    cfg["classes_size"] = 10
    return cfg


def run_remat_single(name_limit: str):
    """The generic step of MCVAE, VQ-VAE, MCPixelCNN and the classifier at
    the CIFAR10 width (B=128; the PixelCNN on random 8x8 code grids) with
    ``remat`` against without, 2 steps from one state, batch and noise:
    losses within ``TRAIN_TOL * |plain|``, parameters within ``TRAIN_TOL *
    max|plain|`` plus the Adam updates' reach, buffers within ``TRAIN_TOL *
    max|plain|``; the kernels' launches a step (``vq_ema`` 3 either way) and
    the peak memory of a step."""
    g = torch.Generator(device=DEV).manual_seed(31)
    out, bad = {}, []
    for name in ("mcvae", "vqvae", "mcpixelcnn", "classifier"):
        cfg = _single_cfg(name)
        B = 128
        img = (torch.randint(0, cfg["pixelcnn"]["num_embedding"], (B, 8, 8), generator=g,
                             device=DEV) if name == "mcpixelcnn"
               else torch.rand((B, 32, 32, 3), generator=g, device=DEV) * 2 - 1)
        batch = {"img": img, "label": torch.arange(B, device=DEV) % 10}
        rec, ref = {}, None
        for remat in (False, True):
            model = build_model(cfg, DEV)
            rng = torch.Generator(DEV).manual_seed(5) if name == "mcvae" else None
            ts = TrainState(model, make_optimizer(model.parameters(), cfg,
                                                  grad_clip=cfg.get("grad_clip")), rng=rng)
            step = make_train_step(remat=remat)
            zero_counts()
            losses = [float(step(ts, batch)["loss"]) for _ in range(2)]
            torch.cuda.synchronize()
            c = {k: v / 2 for k, v in counts().items()}
            state = {k: t.detach().clone() for k, t in model.state_dict().items()}
            r = {"losses": losses, "launches_per_step": c,
                 "peak_mem_gib": _peak_gib(lambda: step(ts, batch))}
            if ref is None:
                ref = (losses, state)
            else:
                worst = 0.0
                for k, b in ref[1].items():
                    allowance = 2 * 2 * cfg["lr"] if k in dict(model.named_parameters()) else 0.0
                    err = (state[k].float() - b.float()).abs().max().item()
                    worst = max(worst, err / (TRAIN_TOL * b.float().abs().max().item()
                                              + allowance + 1e-30))
                loss_err = max(abs(a - b) for a, b in zip(losses, ref[0]))
                r["vs_plain"] = {"loss_max_abs_err": loss_err, "worst_share_of_tol": worst}
                if not (loss_err <= TRAIN_TOL * max(abs(x) for x in ref[0]) and worst <= 1.0):
                    bad.append(f"{name} remat vs plain: {r['vs_plain']}")
            rec["remat" if remat else "plain"] = r
            del ts, model
            torch.cuda.empty_cache()
        want_ema = 3.0 if name == "vqvae" else 0.0
        for k, r in rec.items():
            if r["launches_per_step"]["vq_ema"] != want_ema:
                bad.append(f"{name} {k}: vq_ema {r['launches_per_step']}, want {want_ema}")
        out[name] = rec
        log(f"remat single {name}:", json.dumps({"card": name_limit, **rec}))
    if bad:
        raise SystemExit("remat single failed: " + "; ".join(bad))
    return {k: v["remat"]["launches_per_step"] for k, v in out.items()}, out


# the imported VQ-VAE's encoding on the card (bf16) against the CPU's (f32):
# a code may flip where two codes are near, so this share at least is equal
IMPORT_CODES_EQUAL = 0.9
REFERENCE_MODELS = ("mcgan", "cgan", "mcvae", "cvae", "vqvae", "mcpixelcnn", "cpixelcnn",
                    "mcglow", "cglow", "classifier")


def run_reference_import(name_limit: str):
    """A reference-keyed ``state_dict`` (the reference implementation's key
    paths, seeded random tensors shaped by the port's layers;
    ``tests/reference_state_dicts.py``) for each of the ten models at the
    CIFAR10 width, converted by ``io.torch_import.load_reference`` and
    loaded by the model on the card and on the CPU; one pass of 16 on each
    (the GANs and VAEs: a ``generate`` chunk from fixed z; the Glows: the
    eval forward's z; the PixelCNNs: logits of random codes; the VQ-VAE:
    the decoded codes of the CPU's encoding, and the share of codes the
    card's encoding finds equal, at least ``IMPORT_CODES_EQUAL``; the
    classifier: logits): finite, the card's within ``SLICE_TOL * max|cpu|``
    of the CPU's (bf16 operands against f32; the classifier f32 both)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from mcgm_tpu_torch.io.torch_import import load_reference, reference_dims
    from reference_state_dicts import reference_state_dict

    rec, bad = {}, []
    g = torch.Generator().manual_seed(41)
    n = 16
    label = torch.arange(n) % 10
    img = torch.rand((n, 32, 32, 3), generator=g) * 2 - 1
    for name in REFERENCE_MODELS:
        cfg = _single_cfg(name)
        cpu = build_model(cfg, "cpu")
        section = next(k for k in ("vqvae", "pixelcnn", "glow", "gan", "vae", "classifier")
                       if k in name)
        t0 = time.perf_counter()
        sd = reference_state_dict(name, cpu, cfg[section], seed=len(name))
        state = load_reference(name, sd, **reference_dims(cfg))
        convert_s = time.perf_counter() - t0
        cpu.load_state_dict(state, strict=True)
        card = build_model(cfg, DEV)
        card.load_state_dict(state, strict=True)
        if section in ("gan", "vae"):
            z = torch.randn((n, cfg[section]["latent_size"]), generator=g)

            def fwd(m, dev):
                return m.generate(label.to(dev), z.to(dev))
        elif section == "glow":
            noise = torch.rand((n, 32, 32, 3), generator=g)

            def fwd(m, dev):
                out = m({"img": img.to(dev), "label": label.to(dev)}, noise=noise.to(dev))
                return torch.cat([t.reshape(n, -1) for t in out["z"]], 1)
        elif section == "pixelcnn":
            codes = torch.randint(0, cfg["pixelcnn"]["num_embedding"], (n, 8, 8), generator=g)

            def fwd(m, dev):
                return m({"img": codes.to(dev), "label": label.to(dev)})["logits"]
        elif section == "classifier":
            def fwd(m, dev):
                return m({"img": img.to(dev), "label": label.to(dev)})["label"]
        with torch.no_grad():
            if name == "vqvae":
                cpu_codes = cpu.encode(img)[2]
                want = cpu.decode_code(cpu_codes).float()
                got_codes = card.encode(img.to(DEV))[2].cpu()
                got = card.decode_code(cpu_codes.to(DEV)).float().cpu()
                code_share = float((got_codes == cpu_codes).float().mean())
            else:
                want = fwd(cpu, "cpu").float()
                got = fwd(card, DEV).float().cpu()
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        r = {"parameters": sum(p.numel() for p in cpu.parameters()), "keys": len(sd),
             "convert_seconds": convert_s, "shape": list(want.shape),
             "max_abs_err": err, "max_abs_cpu": top, "finite": bool(torch.isfinite(got).all())}
        if name == "vqvae":
            r["codes_equal_share"] = code_share
        ok = r["finite"] and bool(torch.isfinite(want).all()) and err <= SLICE_TOL * top
        if name == "vqvae":
            ok = ok and code_share >= IMPORT_CODES_EQUAL
        if not ok:
            bad.append(f"{name}: {r}")
        rec[name] = r
        del cpu, card
    log("reference import:", json.dumps({"card": name_limit, **rec}))
    if bad:
        raise SystemExit("reference import failed: " + "; ".join(bad))
    return rec


PREEMPT_STEPS, PREEMPT_SAVE_EVERY, PREEMPT_AT = 6, 2, 3


def run_preempt(name_limit: str, data_dir: str, out_dir: str):
    """The classifier trained through ``cli.train`` on the CIFAR10-shaped
    files for one epoch of ``PREEMPT_STEPS`` steps with ``save_every_steps
    = PREEMPT_SAVE_EVERY``: once uninterrupted, once sending itself SIGTERM
    just before step ``PREEMPT_AT`` (it stops after that step with a step
    checkpoint), then ``resume_mode=1`` to the epoch's end. cuDNN runs its
    deterministic algorithms here, so the resumed run's state (parameters,
    Adam's moments, scheduler, logger) must equal the uninterrupted one's
    bit for bit."""
    import signal

    from mcgm_tpu_torch.train import loop as ploop

    base = ["--data_name", "CIFAR10", "--data_dir", data_dir, "--model_name", "classifier",
            "--control_name", "None", "--device", str(DEV), "--num_epochs", "1"]
    kw = dict(limit_train_batches=PREEMPT_STEPS, limit_eval_batches=2,
              save_every_steps=PREEMPT_SAVE_EVERY)
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    real_setup = ploop.Experiment.setup
    calls = [0]

    def setup_with_sigterm(exp):
        real_setup(exp)
        step = exp.train_step

        def wrapped(ts, batch):
            calls[0] += 1
            if calls[0] == PREEMPT_AT:
                if signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None):
                    raise SystemExit("preempt: the trainer's SIGTERM handler is not installed")
                os.kill(os.getpid(), signal.SIGTERM)
            return step(ts, batch)

        exp.train_step = wrapped

    try:
        t0 = time.perf_counter()
        (full,) = cli_train.main(base + ["--output_dir", os.path.join(out_dir, "full")], **kw)
        full_s = time.perf_counter() - t0
        ploop.Experiment.setup = setup_with_sigterm
        try:
            t0 = time.perf_counter()
            (first,) = cli_train.main(base + ["--output_dir", os.path.join(out_dir, "split")],
                                      **kw)
            stop_s = time.perf_counter() - t0
        finally:
            ploop.Experiment.setup = real_setup
        t0 = time.perf_counter()
        (resumed,) = cli_train.main(base + ["--output_dir", os.path.join(out_dir, "split"),
                                            "--resume_mode", "1"], **kw)
        resume_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    mismatch = _state_mismatch(to_numpy(full.state_dict()), to_numpy(resumed.state_dict()))
    rec = {"card": name_limit, "steps_before_stop": first.epoch_stats[0]["train_steps"],
           "resumed_at_step": (resumed.resumed or {}).get("mid_epoch_step"),
           "steps_after_resume": resumed.epoch_stats[0]["train_steps"],
           "handler_restored": signal.getsignal(signal.SIGTERM) is signal.SIG_DFL,
           "state_bit_equal": not mismatch, "mismatch": mismatch[:8],
           "seconds": {"uninterrupted": full_s, "stopped": stop_s, "resumed": resume_s}}
    log("preempt:", json.dumps(rec))
    if not (rec["steps_before_stop"] == PREEMPT_AT and rec["resumed_at_step"] == PREEMPT_AT
            and rec["steps_after_resume"] == PREEMPT_STEPS - PREEMPT_AT
            and rec["state_bit_equal"] and rec["handler_restored"]):
        raise SystemExit(f"preempt failed: {rec}")
    return rec


# ------------------------------------------------------------------- export
# int8_conv at the shapes the CIFAR10-width GAN and VAE generators give it,
# each at INT8_BATCHES, dynamic and static, beside INT8_EXTRA_CASES; the
# INT8_TIMED ones at the artifacts' batch SERVE_BATCH
PEAK_INT8_OPS = 1979e12
SERVE_CALLS = 5
EXPORTED = (("mcgan", None), ("mcgan", "int8"), ("mcgan", "int8_static"), ("cvae", None),
            ("cvae", "int8"), ("cvae", "int8_static"), ("mcglow", None), ("mcpixelcnn", None))
# exported by a process of their own, started with the script (their traces
# take minutes of host time: Glow's 48 flows, the PixelCNN's two loop bodies);
# it traces on the host only (niced), the card holding the weights
EXPORT_BACKGROUND = ("mcglow", "mcpixelcnn")
# two batch sizes from one artifact; the PixelCNN's at one (its artifact is
# two while_loops of eager launches)
ROUNDTRIP_BATCHES = {"mcpixelcnn": (3,)}
ROUNDTRIP_DEFAULT = (3, 8)
EXPORT_WORK = os.path.join(str(build.BUILD_DIR), "export_smoke")


def int8_inputs(case, B, seed, static):
    """bf16 NHWC activations, the static scale's amax (0.7 of the largest
    |x|: the top is clipped) or None, weights quantized per channel and a
    bias (or None)."""
    _, layout, H, W, C, N, kh, kw, _, has_bias = case
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g, device=DEV).to(torch.bfloat16)
    K = (16 if layout == kint8.UP2 else kh * kw) * C
    w, wscale = kint8.quantize_sym(torch.randn((N, K), generator=g, device=DEV) / math.sqrt(K),
                                   (1,))
    bias = 0.1 * torch.randn(N, generator=g, device=DEV) if has_bias else None
    amax = (0.7 * x.float().abs().max()).reshape(()) if static else None
    return x, amax, w, wscale.reshape(-1), bias


def _units(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of two same-dtype tensors in units of their last
    place (bit patterns; 0 is bit-equal)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return int((a.view(view).long() - b.view(view).long()).abs().max())


def int8_variants(case, B, static, out_dtype=torch.bfloat16, x_dtype=torch.bfloat16) -> dict:
    """The kernels a call takes (``kernels/int8.py``'s plans; operands
    16-byte aligned, as the checks' are): ``variant`` of ``int8_conv`` and
    of ``int8_quantize`` (with its cluster's size)."""
    _, layout, H, W, C, N, kh, kw, pad, _ = case
    plan = kint8.conv_plan(B, H, W, C, N, layout, kh, kw, pad,
                           out_itemsize=torch.finfo(out_dtype).bits // 8)
    qplan = kint8.quantize_plan(B, H * W * C, torch.finfo(x_dtype).bits // 8, static)
    return {"variant": plan["variant"],
            "quantize_variant": qplan["variant"] + (f" x{qplan['cluster']}"
                                                    if qplan["cluster"] else "")}


def check_int8(case, B, seed, static, out_dtype=torch.bfloat16) -> dict:
    """``int8_quantize`` and ``int8_conv`` against their plain versions: the
    int8 values and scales equal, the outputs within one unit of the output
    dtype (the int32 sums are exact on both sides)."""
    name, layout, H, W, C, N, kh, kw, pad, _ = case
    x, amax, w, wscale, bias = int8_inputs(case, B, seed, static)
    q, xs = kint8.int8_quantize(x, amax)
    qr, xsr = kint8.int8_quantize_reference(x, amax)
    args = (q, w, wscale, xs, bias, layout, kh, kw, pad, out_dtype)
    y = kint8.int8_conv(*args)
    yr = kint8.int8_conv_reference(*args)
    torch.cuda.synchronize()
    rec = {"case": name, "B": B, "mode": "static" if static else "dynamic",
           "out": str(out_dtype).split(".")[-1], "shape": [B, H, W, C, N],
           "quantize_equal": bool(torch.equal(q, qr) and torch.equal(xs, xsr)),
           "units": _units(y, yr), "max_abs_err": float((y.float() - yr.float()).abs().max()),
           "clipped": float((q.abs() == 127).float().mean()),
           **int8_variants(case, B, static, out_dtype)}
    if not rec["quantize_equal"] or rec["units"] > 1 or tuple(y.shape) != tuple(yr.shape):
        raise SystemExit(f"int8 kernels disagree with their plain versions: {json.dumps(rec)}")
    return rec


def check_int8_quantize_large() -> dict:
    """``int8_quantize`` (dynamic) on f32 examples of 4 MB, more than a
    cluster's shared memory holds (the ``stream`` kernel: x read twice),
    equal to its plain version."""
    x = torch.randn((2, 64, 64, 256), device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(41)) * 3
    x[1, 5, 7, 9] = 40.0  # one example's amax far from the rest
    q, xs = kint8.int8_quantize(x)
    qr, xsr = kint8.int8_quantize_reference(x)
    plan = kint8.quantize_plan(2, x[0].numel(), 4, False)
    rec = {"case": "f32 examples of 4 MB, dynamic", "shape": list(x.shape),
           "quantize_variant": f"{plan['variant']} x{plan['cluster']}",
           "equal": bool(torch.equal(q, qr) and torch.equal(xs, xsr))}
    if not rec["equal"] or plan["variant"] != "stream":
        raise SystemExit(f"int8_quantize on large f32 examples: {json.dumps(rec)}")
    return rec


def check_int8_quantize_nan() -> dict:
    """``int8_quantize`` on inputs that hold a NaN, through each of its
    kernels: the int8 values equal to the plain version's, the scales equal
    with the NaN where the plain version has it (an example's amax, or a
    static amax, that is NaN gives a NaN scale)."""
    g = torch.Generator(device=DEV).manual_seed(43)
    rec = {}
    for shape, dtype, static in (((8, 128), torch.bfloat16, False),
                                 ((4, 16, 16, 256), torch.bfloat16, False),
                                 ((2, 64, 64, 256), torch.float32, False),
                                 ((4, 16, 16, 256), torch.bfloat16, True)):
        x = torch.randn(shape, generator=g, device=DEV).to(dtype)
        x[1].view(-1)[37] = float("nan")
        for amax in ((torch.tensor(1.5, device=DEV), torch.tensor(float("nan"), device=DEV))
                     if static else (None,)):
            q, xs = kint8.int8_quantize(x, amax)
            qr, xsr = kint8.int8_quantize_reference(x, amax)
            plan = kint8.quantize_plan(shape[0], x[0].numel(), x.element_size(), static)
            key = f"{plan['variant']} {list(shape)}" + ("" if amax is None else
                                                       f" amax {float(amax)}")
            rec[key] = bool(torch.equal(q, qr) and torch.equal(xs.isnan(), xsr.isnan())
                            and torch.equal(xs.nan_to_num(), xsr.nan_to_num()))
    if not all(rec.values()):
        raise SystemExit(f"int8_quantize with a NaN: {json.dumps(rec)}")
    return rec


def _taps_in(n: int, k: int, pad: int, up2: bool) -> int:
    """Along one axis of ``n`` input positions: the (output position, tap)
    pairs whose tap reads the input, not the zero padding (up2: over both
    output parities, each a 2-tap product of the input padded by 1)."""
    if up2:
        return sum(0 <= i + du + a - 1 < n for a in (0, 1) for du in (0, 1) for i in range(n))
    return sum(0 <= o + d - pad < n for d in range(k) for o in range(n + 2 * pad - k + 1))


def int8_conv_bound(case, B) -> tuple[float, str, float]:
    """``(bound_ms, bound_by, ops)``: x, w, the scales and the bf16 output
    once, at 3.35 TB/s, against 2 ops per MAC at the int8 dense peak, over
    the taps that read the input (those that meet the zero padding left
    out: the function needs none of them)."""
    _, layout, H, W, C, N, kh, kw, pad, has_bias = case
    Ho, Wo = kint8._out_hw(layout, H, W, kh, kw, pad)
    up2 = layout == kint8.UP2
    K = (16 if up2 else kh * kw) * C
    nbytes = B * H * W * C + N * K + 4 * (N + B) + 2 * B * Ho * Wo * N + (2 * N if has_bias
                                                                          else 0)
    ops = 2.0 * B * N * C * _taps_in(H, kh, pad, up2) * _taps_in(W, kw, pad, up2)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", ops


def int8_library(q, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype):
    """The yardstick: im2col (``F.unfold``'s columns, tap-major) and
    ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32) per phase, then the same
    dequantization; N padded to a multiple of 8 for ``_int_mm``."""
    B, H, W, C = q.shape
    N = w.shape[0]
    Np = -(-N // 8) * 8
    wp = F.pad(w, (0, 0, 0, Np - N))
    scale = wscale[None, :] * xscale[:, None]

    def mm(cols, wk, h, w_):
        acc = torch._int_mm(cols.reshape(B * h * w_, -1), wk.t())[:, :N]
        y = (acc.float().reshape(B, h * w_, N) * scale[:, None, :]).to(out_dtype)
        return (y if bias is None else y + bias.to(out_dtype)).reshape(B, h, w_, N)

    if layout == kint8.DIRECT:
        Ho, Wo = kint8._out_hw(layout, H, W, kh, kw, pad)
        xp = F.pad(q, (0, 0, pad, pad, pad, pad))
        return mm(torch.stack([xp[:, dy:dy + Ho, dx:dx + Wo] for dy in range(kh)
                               for dx in range(kw)], 3), wp, Ho, Wo)
    xp = F.pad(q, (0, 0, 1, 1, 1, 1))
    out = torch.empty((B, 2 * H, 2 * W, N), dtype=out_dtype, device=q.device)
    for phase in range(4):
        a, b = divmod(phase, 2)
        cols = torch.stack([xp[:, du + a:du + a + H, dv + b:dv + b + W] for du in (0, 1)
                            for dv in (0, 1)], 3)
        out[:, a::2, b::2] = mm(cols, wp[:, phase * 4 * C:(phase + 1) * 4 * C], H, W)
    return out


def _cudnn_bf16(case, x):
    """cuDNN's bf16 conv of the same shape (the full-precision artifact's
    op): conv2d, or conv_transpose2d k4 s2 p1 for the up2 layout."""
    _, layout, H, W, C, N, kh, kw, pad, has_bias = case
    xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
    bias = torch.zeros(N, device=DEV, dtype=torch.bfloat16) if has_bias else None
    if layout == kint8.UP2:
        wt = torch.randn((C, N, 4, 4), device=DEV, dtype=torch.bfloat16)
        return lambda: F.conv_transpose2d(xc, wt, bias, 2, 1)
    wt = torch.randn((N, C, kh, kw), device=DEV, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return lambda: F.conv2d(xc, wt, bias, 1, pad)


def time_int8(case, timers: list, seed: int) -> dict:
    """``int8_conv`` at ``SERVE_BATCH`` in dynamic mode: the wrapper, the
    plain version (f64 sums), ``_int_mm`` + im2col and cuDNN's bf16 conv,
    CUDA events; the kernel's own device time later, from the profiler.
    Also ``int8_quantize`` at the same input (queued once, for the first
    case)."""
    B = SERVE_BATCH
    x, _, w, wscale, bias = int8_inputs(case, B, seed, static=False)
    q, xs = kint8.int8_quantize(x)
    args = (q, w, wscale, xs, bias) + case[1:2] + case[6:9] + (torch.bfloat16,)
    bound, bound_by, ops = int8_conv_bound(case, B)
    rec = {"case": case[0], "shape": [B, *case[2:6]], "bound_ms": bound, "bound_by": bound_by,
           "ops": ops, **int8_variants(case, B, False)}
    y = kint8.int8_conv(*args)
    yr = kint8.int8_conv_reference(*args)
    rec["units"] = _units(y, yr)
    rec["max_abs_err"] = float((y.float() - yr.float()).abs().max())
    if rec["units"] > 1 or tuple(y.shape) != tuple(yr.shape):
        raise SystemExit(f"int8_conv disagrees with its plain version at the artifacts' batch: "
                         f"{json.dumps(rec)}")
    rec["wrapper_ms"] = cuda_ms(lambda: kint8.int8_conv(*args), 20)
    rec["plain_ms"] = cuda_ms(lambda: kint8.int8_conv_reference(*args), 2)
    rec["library_ms"] = cuda_ms(lambda: int8_library(*args), 5)
    rec["library_bf16_ms"] = cuda_ms(_cudnn_bf16(case, x), 20)
    rec["library_int_mm_err"] = float((int8_library(*args).float() - y.float()).abs().max())
    timers.append((rec, "int8_conv", lambda: kint8.int8_conv(*args)))
    log("int8_conv timed:", json.dumps(rec))
    return rec


def time_int8_quantize(timers: list) -> dict:
    """``int8_quantize`` (dynamic) on the largest activation the GAN
    artifact quantizes at its batch: Conv_1's input at 32 px."""
    x = torch.randn((SERVE_BATCH, 32, 32, 256), device=DEV).to(torch.bfloat16)
    nbytes = x.numel() * 3 + 4 * SERVE_BATCH  # x once, q once, the scales
    plan = kint8.quantize_plan(SERVE_BATCH, x[0].numel(), 2, False)
    rec = {"case": "GAN Conv_1 input at 32, dynamic", "shape": list(x.shape),
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes", "library_ms": None,
           "variant": f"{plan['variant']} x{plan['cluster']}"}
    q, xs = kint8.int8_quantize(x)
    qr, xsr = kint8.int8_quantize_reference(x)
    rec["max_abs_err"] = float((q.int() - qr.int()).abs().max())
    rec["scales_equal"] = bool(torch.equal(xs, xsr))
    if not torch.equal(q, qr) or not rec["scales_equal"]:
        raise SystemExit(f"int8_quantize disagrees with its plain version at the artifacts' "
                         f"batch: {json.dumps(rec)}")
    rec["wrapper_ms"] = cuda_ms(lambda: kint8.int8_quantize(x), 20)
    rec["plain_ms"] = cuda_ms(lambda: kint8.int8_quantize_reference(x), 5)
    timers.append((rec, "int8_quantize", lambda: kint8.int8_quantize(x)))
    log("int8_quantize timed:", json.dumps(rec))
    return rec


def export_cfg(name: str) -> dict:
    """The CIFAR10 configuration of ``name`` with 10 modes (a PixelCNN's over
    the VQ-VAE's 8 x 8 grid of 512 codes)."""
    cfg = apply_family_overrides(process_control({
        "data_name": "CIFAR10", "model_name": name, "ae_name": "vqvae",
        "control": {"controller_rate": "0.5"}}))
    cfg["classes_size"] = 10
    return cfg


def export_samplers(names=("mcgan", "cvae", "mcglow", "mcpixelcnn")) -> dict:
    """Random-weight samplers at the CIFAR10 width, built on the card (the
    same weights in every process: each model draws them from its seed)."""
    out = {}
    for name in names:
        cfg = export_cfg(name)
        ae = (build_model(dict(vqvae_cfg(), classes_size=10)) if name == "mcpixelcnn"
              else None)
        out[name] = Sampler(cfg, build_model(cfg), ae)
    return out


def _artifact_path(key: str) -> str:
    return os.path.join(EXPORT_WORK, key.replace(":", ".") + ".pt2")


def export_artifact(s: Sampler, key: str, quantize=None) -> dict:
    """Export ``s``, save the artifact where the serving process finds it."""
    t = time.perf_counter()
    blob = io_export.export_sampler(s, quantize=quantize)
    io_export.save_artifact(blob, _artifact_path(key))
    return {"export_s": time.perf_counter() - t, "bytes": len(blob)}


EXPORTER_SCRIPT = r"""
import json, os, sys
os.nice(10)
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
out = {f"{name}:bf16": cs.export_artifact(s, f"{name}:bf16")
       for name, s in cs.export_samplers(json.loads(sys.argv[2])).items()}
print(json.dumps(out))
"""


def _child(script: str, *args: str) -> subprocess.Popen:
    """``python -c script args`` from the checkout's root, killed at exit
    if a failure ends the script first."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen([sys.executable, "-c", script, *args], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def start_background_exports() -> subprocess.Popen:
    """The ``EXPORT_BACKGROUND`` artifacts, exported by a process started
    here (at the script's start); :func:`run_export` collects them."""
    shutil.rmtree(EXPORT_WORK, ignore_errors=True)
    os.makedirs(EXPORT_WORK)
    return _child(EXPORTER_SCRIPT, os.path.dirname(os.path.abspath(__file__)),
                  json.dumps(list(EXPORT_BACKGROUND)))


def finish_background_exports(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"export: the background exporter failed:\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def roundtrip_inputs(s: Sampler, n: int, seed: int):
    """``(C, z)`` for ``n`` requests, the PixelCNN's ``z`` its uniforms, and
    the live sampler's images from the same draws."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    C = torch.arange(n, device=DEV) % 10
    if s.ae_model is not None:
        z = draw_uniforms(n, (8, 8), s.model.input_size, g)
        live = s.sample(C.cpu(), torch.Generator(device=DEV).manual_seed(seed))
    else:
        z = s.sample_z(n, g)
        live = s.sample_with_z(C.cpu(), z)
    return C, z, live


SERVE_SCRIPT = r"""
import json, os, sys, time
import torch
import mcgm_tpu_torch.kernels.ops  # the custom ops an artifact calls
paths, inputs, out = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]


def wait_for(path):  # each file appears by an atomic rename
    deadline = time.time() + 600
    while not os.path.exists(path):
        if time.time() > deadline:
            raise SystemExit(f"{path} did not appear")
        time.sleep(0.05)


res, load_s, data = {}, {}, None
for key, path in paths.items():
    wait_for(path)
    t0 = time.perf_counter()
    program = torch.export.load(path).module()
    load_s[key] = time.perf_counter() - t0
    if data is None:
        wait_for(inputs)
        data = torch.load(inputs)
    with torch.no_grad():
        res[key] = [program(C, z) for C, z in data[key]]
torch.save(res, out)
own = sorted(m for m in sys.modules if m.startswith(("mcgm_tpu", "jax", "flax")))
print(json.dumps({"load_s": load_s, "modules": own}))
"""


def run_export(name_limit: str, timers: list, background: subprocess.Popen):
    """The int8 kernels against their plain versions, the serving
    artifacts' round trips through a process that imports only torch and
    ``kernels.ops``, then, with the card to this process alone, their
    images/s at ``SERVE_BATCH`` and the int8 kernels' times. ``background``
    exports the ``EXPORT_BACKGROUND`` ones."""
    # the round trips in a process of its own, started first: it serves each
    # artifact once its file is there (the background's first) while this
    # one checks the kernels and exports the others, and it ends before
    # anything is timed
    paths = {key: _artifact_path(key) for key in sorted(
        (f"{name}:{quantize or 'bf16'}" for name, quantize in EXPORTED),
        key=lambda k: k.split(":")[0] not in EXPORT_BACKGROUND)}
    inputs_path = os.path.join(EXPORT_WORK, "inputs.pt")
    t_serve = time.perf_counter()
    server = _child(SERVE_SCRIPT, json.dumps(paths), inputs_path,
                    os.path.join(EXPORT_WORK, "outputs.pt"))

    t0 = time.perf_counter()
    checks = [check_int8(case, B, seed=100 + i * 7 + B, static=static)
              for i, case in enumerate(INT8_CASES) for B in INT8_BATCHES
              for static in (False, True)]
    checks += [check_int8(case, 5, seed=300 + i, static=False, out_dtype=torch.float32)
               for i, case in enumerate(INT8_CASES)]
    checks += [check_int8(case, B, seed=400 + i * 7 + B, static=static, out_dtype=dtype)
               for i, case in enumerate(INT8_EXTRA_CASES) for B in INT8_BATCHES
               for static in (False, True) for dtype in (torch.bfloat16, torch.float32)]
    log("export int8 large quantize:", json.dumps(check_int8_quantize_large()))
    log("export int8 quantize with a NaN:", json.dumps(check_int8_quantize_nan()))
    log("export int8 checks:", json.dumps({
        "cases": len(checks), "bit_equal": sum(r["units"] == 0 for r in checks),
        "max_units": max(r["units"] for r in checks),
        "max_abs_err": max(r["max_abs_err"] for r in checks),
        "variants": dict(collections.Counter(r["variant"] for r in checks)),
        "quantize_variants": dict(collections.Counter(r["quantize_variant"] for r in checks)),
        "seconds": time.perf_counter() - t0}))
    for r in checks:
        if r["B"] == 64 and r["mode"] == "dynamic":
            log("  int8 check:", json.dumps(r))

    samplers = export_samplers()
    to_export, calibrate_s, rt_inputs, live = {}, {}, {}, {}
    for name, quantize in EXPORTED:
        key = f"{name}:{quantize or 'bf16'}"
        s = samplers[name]
        if quantize == "int8_static":
            t = time.perf_counter()
            s = io_export.calibrate_int8(s, torch.Generator(device=DEV).manual_seed(7))
            calibrate_s[key] = time.perf_counter() - t
        if name not in EXPORT_BACKGROUND:
            to_export[key] = (s, quantize)
        rt_inputs[key], live[key] = [], []
        for n in ROUNDTRIP_BATCHES.get(name, ROUNDTRIP_DEFAULT):
            C, z, ref = roundtrip_inputs(samplers[name], n, seed=n)
            if quantize:
                with torch.no_grad(), quant.int8_serving(io_export.QUANTIZE[quantize]):
                    ref = s.model.generate(C, z)
            rt_inputs[key].append((C, z))
            live[key].append(ref)
    torch.save(rt_inputs, inputs_path + ".tmp")
    os.replace(inputs_path + ".tmp", inputs_path)
    exported = {}
    for key, (s, quantize) in to_export.items():
        exported[key] = export_artifact(s, key, quantize)
        if key in calibrate_s:
            exported[key]["calibrate_s"] = calibrate_s[key]
    t = time.perf_counter()
    exported.update(finish_background_exports(background))
    log("export artifacts:", json.dumps({"waited_for_background_s": time.perf_counter() - t,
                                         **exported}))
    out, err = server.communicate(timeout=600)
    if server.returncode != 0:
        raise SystemExit(f"export: the serving process failed:\n{err[-4000:]}")
    served = json.loads(out.strip().splitlines()[-1])
    outs = torch.load(os.path.join(EXPORT_WORK, "outputs.pt"))
    roundtrips, bad = {}, []
    stray = [m for m in served["modules"] if m != "mcgm_tpu_torch"
             and not m.startswith(("mcgm_tpu_torch.kernels", "mcgm_tpu_torch.ops"))]
    if stray:
        bad.append(f"the serving process imported {stray}")
    for key in paths:
        errs = [float((o.float() - ref.float()).abs().max()) for o, ref in
                zip(outs[key], live[key])]
        roundtrips[key] = {"max_abs_err": errs, "shapes": [list(o.shape) for o in outs[key]],
                           "load_s": served["load_s"][key],
                           "finite": all(bool(torch.isfinite(o).all()) for o in outs[key])}
        if (len(errs) != len(live[key]) or any(e != 0.0 for e in errs)
                or not roundtrips[key]["finite"]):
            bad.append(f"{key}: the served images differ from the live sampler's by {errs}")
    log("export round trips:", json.dumps({"serving_process_s": time.perf_counter() - t_serve,
                                           "modules": served["modules"], **roundtrips}))

    # images/s of the GAN and VAE artifacts at SERVE_BATCH, loaded here
    throughput, launches, outputs = {}, {}, {}
    for key in [k for k in paths if k.split(":")[0] not in EXPORT_BACKGROUND]:
        fn = io_export.load_artifact(paths[key])
        s = samplers[key.split(":")[0]]
        g = torch.Generator(device=DEV).manual_seed(11)
        C = torch.randint(0, 10, (SERVE_BATCH,), generator=g, device=DEV)
        z = torch.randn((SERVE_BATCH, s.model.latent_size), generator=g, device=DEV)
        fn(C, z)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        outputs[key] = fn(C, z)  # the counted call
        torch.cuda.synchronize()
        launches[key] = int8_counts()
        secs = [_timed(lambda: fn(C, z))[0] for _ in range(SERVE_CALLS)]
        throughput[key] = {"images_per_s": SERVE_BATCH / statistics.median(secs),
                           "ms_per_call": 1e3 * statistics.median(secs),
                           "launches_per_call": launches[key]}
        base = outputs.get(key.split(":")[0] + ":bf16")
        if base is not None and key != key.split(":")[0] + ":bf16":
            d = (outputs[key] - base).abs()
            throughput[key].update(max_abs_vs_bf16=float(d.max()), mean_abs_vs_bf16=float(
                d.mean()))
        if key.endswith("bf16") and any(launches[key].values()):
            bad.append(f"{key} launched int8 kernels: {launches[key]}")
        if not key.endswith("bf16") and not all(launches[key].values()):
            bad.append(f"{key} did not launch both int8 kernels: {launches[key]}")
    log(f"export throughput ({name_limit}):", json.dumps(throughput))

    timed = [time_int8(case, timers, seed=500 + i) for i, case in enumerate(INT8_CASES)
             if case[0] in INT8_TIMED]
    quantize_rec = time_int8_quantize(timers)
    shutil.rmtree(EXPORT_WORK, ignore_errors=True)
    if bad:
        raise SystemExit("export failed:\n" + "\n".join(bad))
    return launches, timed, quantize_rec, checks


PHASE_SECONDS: dict = {}


def phase(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept under ``name`` for the
    ``phases:`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one G->D pass and one train step; traces and tables go to DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False  # the plain versions are f32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    name_limit = card_name_and_limit()
    log(f"card: {name_limit}")
    exporter = start_background_exports()  # collected by the export phase
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    report = build.build_all(ptxas_verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s wall")
    for kname, r in report.items():
        log(f"build {kname}: {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                log("  " + line.strip())
        sass = sass_tensor_core_count(kname)
        log(f"sass {kname}: instructions {json.dumps(sass)}"
            + (" (no cuobjdump)" if sass is None else ""))
        # first_dblock, mc_gated_matmul (bf16), vq_assign (TF32) and
        # int8_conv (s8: IGMMA in its TMA kernels, IMMA in its byte-load
        # one) are designed for the tensor cores; vq_ema adds rows on the
        # CUDA cores
        if kname in TENSOR_CORE_KERNELS and sass is not None \
                and sass["HMMA"] + sass["HGMMA"] + sass["IMMA"] + sass["IGMMA"] == 0:
            raise SystemExit(f"{kname}: no tensor-core instruction in its SASS")

    full = check_first_dblock((128, 128, 128, 3, 64), seed=0, timed=True)
    tail = check_first_dblock((16, 128, 128, 3, 64), seed=3, timed=True)  # the sweep's tail
    cifar = check_first_dblock((512, 32, 32, 3, 128), seed=4, timed=True)  # CIFAR's test batch
    train_d = check_first_dblock((256, 32, 32, 3, 128), seed=9, timed=True)  # fused D pass
    train_g = check_first_dblock((128, 32, 32, 3, 128), seed=10, timed=True)  # G update's D pass
    real_d = check_first_dblock((256, 32, 32, 1, 64), seed=11, timed=True)  # real digits, D pass
    real_g = check_first_dblock((128, 32, 32, 1, 64), seed=12, timed=True)  # real digits, G update
    check_first_dblock((3, 32, 32, 3, 128), seed=1, timed=False)
    check_first_dblock((2, 30, 70, 1, 64), seed=2, timed=False)  # ragged tiles
    check_first_dblock((1, 128, 128, 3, 64), seed=5, timed=False)  # fewer items than blocks
    check_first_dblock((5, 128, 128, 3, 64), seed=6, timed=False)  # items not a grid multiple
    check_first_dblock_grad((2, 16, 12, 3, 64), seed=7)
    check_first_dblock_grad((2, 8, 12, 1, 128), seed=8)
    vq_d, vq_k = 64, 512  # the CIFAR10 VQ-VAE's codebook; 8x8 codes per image
    timers = []  # the kernels' device times are read after every timed phase
    # the main path's traffic: a train step's rows, codes and codebook, after
    # as many steps as the timed VQ-VAE run takes
    step_inputs = vq_step_inputs(vqvae_cfg(), TRAIN_WARMUP + TRAIN_STEPS)
    assign_train = check_vq_assign(128 * 64, vq_d, vq_k, seed=20, timers=timers)
    assign_step = check_vq_assign(128 * 64, vq_d, vq_k, seed=0, timers=timers,
                                  case="a VQ-VAE train step's rows and codebook",
                                  inputs=(step_inputs[0], step_inputs[2]["embedding"]))
    assign_eval = check_vq_assign(512 * 64, vq_d, vq_k, seed=21, timers=timers)
    check_vq_assign(17 * 64, vq_d, vq_k, seed=22)  # the digits' ragged batch
    check_vq_assign(1, vq_d, vq_k, seed=23)
    check_vq_assign(4096, vq_d, vq_k, seed=24, tie=True)
    check_vq_assign(4096, vq_d, vq_k, seed=33, case="near ties",
                    inputs=vq_near_tie_inputs(4096, vq_d, vq_k, seed=33))
    check_vq_assign(8192, vq_d, vq_k, seed=34, case="rows and codebook x 30", scale=30.0)
    check_vq_assign(4096, 256, vq_k, seed=35, case="D 256 (codebook in chunks)")
    check_vq_assign(1000, 8, 16, seed=25)  # a tiny codebook: one ragged tile
    check_vq_assign(1000, 12, 16, seed=36, case="D 12", variant="ffma")
    # more tiles than blocks (512 tiles on 132 SMs): the tiles' pipeline, and
    # the chunked codebook reloaded per tile, with most rows decided in f32
    check_vq_assign(512 * 64, vq_d, vq_k, seed=37, tie=True)
    check_vq_assign(512 * 64, vq_d, vq_k, seed=38, case="near ties",
                    inputs=vq_near_tie_inputs(512 * 64, vq_d, vq_k, seed=38))
    check_vq_assign(512 * 64, 256, vq_k, seed=39, case="D 256 (codebook in chunks)")
    ema_step = check_vq_ema(128 * 64, vq_d, vq_k, seed=32, timers=timers, inputs=step_inputs)
    del step_inputs
    ema_spread = check_vq_ema(128 * 64, vq_d, vq_k, seed=26, timers=timers)
    ema_masked = check_vq_ema(128 * 64, vq_d, vq_k, seed=27, timers=timers, weighted=True)
    ema_collapsed = check_vq_ema(128 * 64, vq_d, vq_k, seed=31, timers=timers,
                                 collapsed=True)
    check_vq_ema(17 * 64, vq_d, vq_k, seed=28)
    check_vq_ema(1, vq_d, vq_k, seed=29)
    check_vq_ema(3000, 8, 16, seed=30, weighted=True)
    log(f"vq_ema: {ema_kernels()} kernel launches a call")  # before any path is counted
    mc_head, mc_others = phase("mc_gated_matmul checks", check_mc_gated_matmul_all, timers)
    mc_glow, mc_glow_bwd = phase("mc_gated_matmul glow checks", check_mc_gated_matmul_glow,
                                 timers)

    serve_launches, _, g_then_d = phase("slice", run_slice, name_limit)
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as the bench script runs
    train_launches, _, profile_train = phase("train", run_train, name_limit)
    fused_launches, _ = phase("gan fused g pass", run_gan_fused, name_limit)
    work = os.path.join(str(build.BUILD_DIR), "trainer_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        trainer_launches, _, profile_trainer = phase("trainer", run_trainer, name_limit, work)
        data_dir = os.path.join(work, "data")  # the CIFAR10-shaped files, reused
        vae_launches, _ = phase("vae", run_vae, name_limit, data_dir, os.path.join(work, "vae"))
        # after the background exporter has had the time it needs
        export_launches, int8_timed, int8_quantize_rec, int8_checks = phase(
            "export", run_export, name_limit, timers, exporter)
        vqvae_launches, _, profile_vqvae = phase("vqvae", run_vqvae, name_limit, data_dir,
                                                 os.path.join(work, "vqvae"))
        # on the codes of the VQ-VAE just trained (its _best in work/vqvae)
        px_launches, _, profile_px = phase("pixelcnn", run_pixelcnn, name_limit, data_dir,
                                           os.path.join(work, "vqvae"))
        glow_launches, _, profile_glow = phase("glow", run_glow, name_limit, data_dir,
                                               os.path.join(work, "glow"))
        reversible_launches, _ = phase("glow reversible", run_glow_reversible, name_limit)
        remat_launches, _ = phase("remat single", run_remat_single, name_limit)
        phase("preempt", run_preempt, name_limit, data_dir, os.path.join(work, "preempt"))
        phase("reference import", run_reference_import, name_limit)
        # the trainer's MCGAN and InceptionV3 weights, before the folder goes
        phase("scores cifar10", run_scores_cifar10, name_limit, data_dir,
              os.path.join(work, "output"))
        shutil.rmtree(work, ignore_errors=True)
        cgan_launches, _, profile_cgan = phase("cgan", run_cgan, name_limit)
        real_launches, _, (base, out_dir) = phase("real", run_real, name_limit, work)
        wf_launches, _ = phase("workflows", run_workflows, name_limit, base, out_dir)
        real_vae_launches, _ = phase("real vae", run_real_vae, name_limit, base, out_dir)
        real_px_launches, _ = phase("real pixelcnn", run_real_pixelcnn, name_limit, base,
                                    out_dir)
        real_glow_launches, _ = phase("real glow", run_real_glow, name_limit, base, out_dir)
        scores_launches, _ = phase("scores real", run_scores_real, name_limit, base, out_dir)
        # the kernels' device times first: their short sessions lost events
        # after the whole-step profiles below
        kernel_device_times(timers)
        # last, so that no timed run follows a profiler session
        rec = profile_cgan(args.profile or os.path.join(work, "profile"))
        log("cgan profile:", json.dumps({k: rec[k] for k in (
            "window_ms", "device_busy_ms", "device_busy_share", "kernel_launches",
            "category_ms")}))
        log("vqvae profile:", json.dumps(profile_vqvae(args.profile
                                                       or os.path.join(work, "profile"))))
        # after the kernels' device times: a session of ~53,000 launches left
        # the next short sessions missing events
        log("glow profile:", json.dumps(profile_glow(args.profile
                                                     or os.path.join(work, "profile"))))
        # last: one sampler chunk is ~20,000 launches under the profiler
        log("pixelcnn profile:", json.dumps(profile_px(args.profile
                                                       or os.path.join(work, "profile"))))
        if args.profile:
            log("profile:", json.dumps(profile_pass(g_then_d, args.profile)))
            log("train profile:", json.dumps(profile_train(args.profile)))
            log("trainer profile:", json.dumps(profile_trainer(args.profile)))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{
        "name": "first_dblock", "route": "cuda",
        "source": "mcgm_tpu_torch/csrc/first_dblock.cu",
        "replaces": "tools/ab_first_block.py:159",
        "launches": train_launches["first_dblock"], "max_abs_err": train_d["max_abs_err"],
        "ms": train_d["ms"], "ms_source": train_d["ms_source"], "plain_ms": train_d["plain_ms"],
        "bound_ms": train_d["bound_ms"],
        "bound_by": train_d["bound_by"], "library_ms": train_d["library_ms"],
        "library": "cuDNN bf16 chain: conv3x3, relu*code, conv4x4/s2, avgpool+conv1x1",
        "shape": train_d["shape"], "wrapper_ms": train_d["wrapper_ms"],
        "roofline_share": train_d["roofline_share"],
        "launches_by_path": {"train_cifar10": train_launches["first_dblock"],
                             "serve_128px": serve_launches["first_dblock"],
                             "trainer_cifar10": trainer_launches["first_dblock"],
                             "cgan": cgan_launches["first_dblock"],
                             "real_mcgan": real_launches["mcgan"],
                             "real_cgan": real_launches["cgan"],
                             "workflows": wf_launches["first_dblock"],
                             "train_cifar10_fuse_g_pass": fused_launches["fuse_g_pass"],
                             "train_cifar10_remat": fused_launches["remat"],
                             "train_cifar10_fuse_g_pass_remat": fused_launches["both"],
                             **{f"vae_{m}": c["first_dblock"] for m, c in vae_launches.items()},
                             **{f"real_{m}": c["first_dblock"]
                                for m, c in real_vae_launches.items()}},
        "other_shapes": [{k: r[k] for k in ("shape", "ms", "ms_source", "wrapper_ms", "bound_ms",
                                            "bound_by", "plain_ms", "library_ms",
                                            "max_abs_err")}
                         for r in (train_g, real_d, real_g, full, tail, cifar)],
    }]
    vq_shapes = ("shape", "case", "ms", "ms_source", "wrapper_ms", "bound_ms", "bound_by",
                 "plain_ms", "library_ms", "max_abs_err")
    for kname, rec, others, library, replaces in (
            ("vq_assign", assign_train, [assign_step, assign_eval],
             "torch.addmm (|e|^2 - 2 x.e) + argmin, f32 (TF32 off)",
             "mcgm_tpu/ops/pallas_kernels.py:112 at 0303c43 (vq_assign; live XLA form "
             "mcgm_tpu/ops/vq.py:56)"),
            ("vq_ema", ema_step, [ema_spread, ema_masked, ema_collapsed],
             "torch.bincount + index_add_ (the sums only)",
             "mcgm_tpu/ops/vq.py:69 (the EMA update beside vq_assign, XLA)")):
        kernels.append({
            "name": kname, "route": "cuda", "source": f"mcgm_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces,
            "launches": vqvae_launches["step"][kname], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "ms_source": rec["ms_source"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"], "library": library,
            "shape": rec["shape"], "case": rec["case"], "wrapper_ms": rec["wrapper_ms"],
            "roofline_share": rec["roofline_share"],
            **({k: rec[k] for k in ("ms_by_kernel", "span_ms", "bound_f32_ms", "variant",
                                    "rows_rescored", "rows_paired") if k in rec}),
            "launches_by_path": {"vqvae_step": vqvae_launches["step"][kname],
                                 "vqvae_step_remat": remat_launches["vqvae"][kname],
                                 "vqvae_eval_batch": vqvae_launches["eval"][kname],
                                 "vqvae_trainer": vqvae_launches["trainer"][kname],
                                 "real_vqvae": real_vae_launches["vqvae"][kname],
                                 **{f"vae_{m}": c[kname] for m, c in vae_launches.items()},
                                 **{f"pixelcnn_trainer_{m}": c["trainer"][kname]
                                    for m, c in px_launches.items()},
                                 **{f"real_{m}": c[kname] for m, c in real_px_launches.items()}},
            "other_shapes": [{k: r[k] for k in vq_shapes + (
                "span_ms", "bound_f32_ms", "variant", "rows_rescored", "rows_paired")
                if k in r} for r in others]})
    px = px_launches["mcpixelcnn"]
    kernels.append({
        "name": "mc_gated_matmul", "route": "cuda",
        "source": "mcgm_tpu_torch/csrc/mc_gated_matmul.cu",
        "replaces": "mcgm_tpu/ops/pallas_kernels.py:49 at 0303c43 (mc_gated_matmul; "
                    "pl.pallas_call at :66)",
        "launches": px["sample_chunk"]["mc_gated_matmul"],
        "max_abs_err": mc_head["max_abs_err"], "ms": mc_head["ms"],
        "ms_source": mc_head["ms_source"],
        "plain_ms": mc_head["plain_ms"], "bound_ms": mc_head["bound_ms"],
        "bound_by": mc_head["bound_by"], "library_ms": mc_head["library_ms"],
        "library": "torch.addmm (P = 1) / baddbmm (P = 64) with BatchNorm folded into the "
                   "weight and bias, relu_, mul_ by the code: cuBLAS and two elementwise "
                   "launches",
        "shape": mc_head["shape"], "case": mc_head["case"],
        "wrapper_ms": mc_head["wrapper_ms"], "roofline_share": mc_head["roofline_share"],
        "variant": mc_head["variant"],
        "launches_by_path": {
            "pixelcnn_eval_batch": px["eval_batch"]["mc_gated_matmul"],
            "pixelcnn_sample_chunk": px["sample_chunk"]["mc_gated_matmul"],
            "pixelcnn_trainer": sum(c["trainer"]["mc_gated_matmul"]
                                    for c in px_launches.values()),
            "real_mcpixelcnn": real_px_launches["mcpixelcnn"]["mc_gated_matmul"],
            "real_cpixelcnn": real_px_launches["cpixelcnn"]["mc_gated_matmul"],
            "pixelcnn_workflows": sum(c["workflows"]["mc_gated_matmul"]
                                      for c in px_launches.values()),
            **{f"glow_{m}_{path}": (c[path] if path == "step" else c[path]["mc_gated_matmul"])
               for m, c in glow_launches.items()
               for path in ("step", "eval_batch", "generate_sweeps", "trainer")},
            **{f"real_{m}_{path}": c[path]["mc_gated_matmul"]
               for m, c in real_glow_launches.items() for path in ("trainer", "workflows")},
            "scores_real": scores_launches["mc_gated_matmul"],
            **{f"glow_{m}_step_reversible": n["forward"]
               for m, n in reversible_launches.items()}},
        "other_shapes": [{k: r[k] for k in vq_shapes + ("variant", "roofline_share")
                          if k in r} for r in mc_others + mc_glow]})
    bwd = mc_glow_bwd[0]  # Glow level 1
    kernels.append({
        "name": "mc_gated_matmul_backward", "route": "cuda",
        "source": "mcgm_tpu_torch/csrc/mc_gated_matmul.cu",
        "replaces": "mcgm_tpu/ops/pallas_kernels.py:91 at 0303c43 (_mc_bwd, mc_gated_matmul's "
                    "VJP, left to XLA beside the Pallas kernel: the recompute, the epilogue's "
                    "gradient and the dalpha / dbeta sums)",
        "launches": glow_launches["mcglow"]["step_backward"],
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"], "ms_source": bwd["ms_source"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "library": "bf16 bmm recompute, f32 mask / sums / scale, bf16 bmm for dx and einsum for "
                   "dw (a PyTorch chain; no single call computes it)",
        "shape": bwd["shape"], "case": bwd["case"], "wrapper_ms": bwd["wrapper_ms"],
        "roofline_share": bwd["roofline_share"], "variant": bwd["variant"],
        "errors": bwd["errors"], "parts_ms": bwd["parts_ms"],
        "parts_bound_ms": bwd["parts_bound_ms"],
        "launches_by_path": {
            **{f"glow_{m}_step": c["step_backward"] for m, c in glow_launches.items()},
            **{f"glow_{m}_trainer": c["trainer"]["mc_gated_matmul_backward"]
               for m, c in glow_launches.items()},
            **{f"glow_{m}_step_reversible": n["backward"]
               for m, n in reversible_launches.items()},
            **{f"real_{m}_trainer": c["trainer"]["mc_gated_matmul_backward"]
               for m, c in real_glow_launches.items()}},
        "other_shapes": [{k: r[k] for k in vq_shapes + ("variant", "roofline_share",
                                                        "parts_ms")}
                         for r in mc_glow_bwd[1:]]})
    # GAN Conv_1 3x3 at 32 px, the artifacts' batch
    conv = next(r for r in int8_timed if r["case"] == INT8_TIMED[0])
    int8_keys = ("shape", "case", "variant", "ms", "ms_source", "wrapper_ms", "bound_ms",
                 "bound_by", "plain_ms", "library_ms", "library_bf16_ms", "max_abs_err",
                 "roofline_share")
    int8_paths = {f"export_{k.replace(':', '_')}": v for k, v in export_launches.items()}
    kernels.append({
        "name": "int8_conv", "route": "cuda", "source": "mcgm_tpu_torch/csrc/int8_conv.cu",
        "replaces": "mcgm_tpu/ops/layers.py:113 _int8_conv / :135 _int8_apply (XLA s8 x s8 -> "
                    "s32 convs; no Pallas source)",
        "launches": export_launches["mcgan:int8"]["int8_conv"],
        "max_abs_err": conv["max_abs_err"], "ms": conv["ms"], "ms_source": conv["ms_source"],
        "plain_ms": conv["plain_ms"],
        "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
        "library_ms": conv["library_ms"],
        "library": "im2col + torch._int_mm (cuBLASLt s8 x s8 -> s32) and the same "
                   "dequantization; library_bf16_ms: cuDNN's bf16 conv of the same shape",
        "library_bf16_ms": conv["library_bf16_ms"], "shape": conv["shape"],
        "case": conv["case"], "variant": conv["variant"], "wrapper_ms": conv["wrapper_ms"],
        "roofline_share": conv["roofline_share"],
        "checks": {"cases": len(int8_checks),
                   "bit_equal": sum(r["units"] == 0 for r in int8_checks),
                   "max_units": max(r["units"] for r in int8_checks)},
        "launches_by_path": {k: v["int8_conv"] for k, v in int8_paths.items()},
        "other_shapes": [{k: r[k] for k in int8_keys} for r in int8_timed if r is not conv]})
    qrec = int8_quantize_rec
    kernels.append({
        "name": "int8_quantize", "route": "cuda", "source": "mcgm_tpu_torch/csrc/int8_conv.cu",
        "replaces": "mcgm_tpu/ops/layers.py:104 _quantize_sym on activations, in "
                    ":113 _int8_conv / :135 _int8_apply (XLA; no Pallas source)",
        "launches": export_launches["mcgan:int8"]["int8_quantize"],
        **{k: qrec[k] for k in ("max_abs_err", "ms", "ms_source", "plain_ms", "bound_ms",
                                "bound_by",
                                "library_ms", "shape", "case", "variant", "wrapper_ms",
                                "roofline_share")},
        **({k: qrec[k] for k in ("ms_by_kernel", "span_ms") if k in qrec}),
        "launches_by_path": {k: v["int8_quantize"] for k, v in int8_paths.items()}})
    log("phases:", json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    log(f"wall: {time.perf_counter() - t_start:.1f} s for the whole script")
    log(name_limit)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
