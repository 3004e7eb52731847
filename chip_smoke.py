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
   ``INCEPTION_TOL * max|cpu|``.

The last three lines are the card's name and power limit as ``nvidia-smi``
gives them, one JSON object listing every kernel, and
``{"ok": true, "device": {...}}``. With ``--profile DIR`` one more G->D pass,
one more train step, one more trainer epoch and one chunk of its eval sweep
run under ``torch.profiler`` after the checks. There
is no CPU path: without a card the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from mcgm_tpu_torch.bench import train_gan
from mcgm_tpu_torch.cli import train as cli_train
from mcgm_tpu_torch.config import process_control
from mcgm_tpu_torch.data.datasets import _save_processed
from mcgm_tpu_torch.evals.inception import InceptionV3, inception_feature_fn
from mcgm_tpu_torch.io.checkpoint import to_numpy
from mcgm_tpu_torch.io.jax_import import to_jax_inception
from mcgm_tpu_torch.kernels import build
from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.ops.layers import fold_pool
from mcgm_tpu_torch.report.logger import Logger
from mcgm_tpu_torch.train.state import make_gan_train_step
from mcgm_tpu_torch.utils import card_name_and_limit, save
from mcgm_tpu_torch.workflows.generate import class_sweep
from mcgm_tpu_torch.workflows.sampling import Sampler

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 2e-2  # max|kernel - plain| <= KERNEL_TOL * max|plain|, both bf16 out
SLICE_TOL = 5e-2   # max|bf16 path - f32 plain path| <= SLICE_TOL * max|f32 plain path|
TRAIN_TOL = 5e-2   # kernel path vs plain path, one train step: losses, first D gradients
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
NUM_MODE = 20
DEV = torch.device("cuda")
INCEPTION_TOL = 1e-3  # max|card - cpu| <= INCEPTION_TOL * max|cpu|, both f32
TRAINER_STEPS, TRAINER_EPOCHS = 20, 2
TRAINER_IMAGES = {"train": 50_000, "test": 10_000}  # CIFAR10's splits
CIFAR10_CLASSES = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
                   "ship", "truck"]


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
    """Counts of HMMA / HGMMA instructions in the built library's SASS, or
    None where ``cuobjdump`` is not installed."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
        if tool is None:
            return None
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HMMA", "HGMMA")}


# ------------------------------------------------------------------- slice
PHASES = ("generate", "discriminate")


def kernel_category(name: str) -> str:
    if "first_dblock" in name:
        return "first_dblock (hand kernel)"
    if any(k in name for k in ("xmma", "cudnn", "dgrad", "wgrad", "convolve", "winograd")):
        return "conv (cuDNN)"
    if any(k in name for k in ("gemv", "gemm", "nvjet", "cublas", "dot_kernel", "cutlass")):
        return "matmul (cuBLAS: Dense, SN power iterations)"
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
           "top_kernels": [{"name": n[:120], "ms": ms, "calls": c} for n, ms, c in kernels[:10]]}
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


def train_kernel_vs_plain(cfg, step) -> dict:
    """One step from the same state, batch and z through the kernels and
    through the plain versions: the losses (against the largest of them, since
    ``Loss`` may be near 0) and the first D update's gradients, each within
    ``TRAIN_TOL * max|plain|``."""
    (ts_k, batch), (ts_p, _) = train_gan.bench_state(cfg), train_gan.bench_state(cfg, plain=True)
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
             if n.startswith("blocks._MCFirstDisResBlock_0.") and not gr.abs().max() > 0]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one G->D pass and one train step; traces and tables go to DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False  # the plain versions are f32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    name_limit = card_name_and_limit()
    log(f"card: {name_limit}")
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
        counts = sass_tensor_core_count(kname)
        log(f"sass {kname}: tensor-core instructions {json.dumps(counts)}"
            + (" (no cuobjdump)" if counts is None else ""))
        if counts is not None and counts["HMMA"] + counts["HGMMA"] == 0:
            raise SystemExit(f"{kname}: no tensor-core instruction in its SASS")

    full = check_first_dblock((128, 128, 128, 3, 64), seed=0, timed=True)
    tail = check_first_dblock((16, 128, 128, 3, 64), seed=3, timed=True)  # the sweep's tail
    cifar = check_first_dblock((512, 32, 32, 3, 128), seed=4, timed=True)  # CIFAR's test batch
    train_d = check_first_dblock((256, 32, 32, 3, 128), seed=9, timed=True)  # fused D pass
    train_g = check_first_dblock((128, 32, 32, 3, 128), seed=10, timed=True)  # G update's D pass
    check_first_dblock((3, 32, 32, 3, 128), seed=1, timed=False)
    check_first_dblock((2, 30, 70, 1, 64), seed=2, timed=False)  # ragged tiles
    check_first_dblock((1, 128, 128, 3, 64), seed=5, timed=False)  # fewer items than blocks
    check_first_dblock((5, 128, 128, 3, 64), seed=6, timed=False)  # items not a grid multiple
    check_first_dblock_grad((2, 16, 12, 3, 64), seed=7)
    check_first_dblock_grad((2, 8, 12, 1, 128), seed=8)

    serve_launches, _, g_then_d = run_slice(name_limit)
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as the bench script runs
    train_launches, _, profile_train = run_train(name_limit)
    work = os.path.join(str(build.BUILD_DIR), "trainer_smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        trainer_launches, _, profile_trainer = run_trainer(name_limit, work)
        if args.profile:  # last, so that no timed run follows a profiler session
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
        "ms": train_d["ms"], "plain_ms": train_d["plain_ms"], "bound_ms": train_d["bound_ms"],
        "bound_by": train_d["bound_by"], "library_ms": train_d["library_ms"],
        "library": "cuDNN bf16 chain: conv3x3, relu*code, conv4x4/s2, avgpool+conv1x1",
        "shape": train_d["shape"], "wrapper_ms": train_d["wrapper_ms"],
        "roofline_share": train_d["roofline_share"],
        "launches_by_path": {"train_cifar10": train_launches["first_dblock"],
                             "serve_128px": serve_launches["first_dblock"],
                             "trainer_cifar10": trainer_launches["first_dblock"]},
        "other_shapes": [{k: r[k] for k in ("shape", "ms", "wrapper_ms", "bound_ms", "bound_by",
                                            "plain_ms", "library_ms", "max_abs_err")}
                         for r in (train_g, full, tail, cifar)],
    }]
    log(name_limit)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
