#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--profile DIR]

Phases, each of which exits non-zero on failure:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``mcgm_tpu_torch/csrc/*.cu`` for sm_90a, with ptxas's report;
3. kernel: each hand-written kernel against its plain PyTorch version at the
   main path's shapes (full chunk and tail chunk) and at other shapes it
   takes, under a stated tolerance, timed at the full chunk beside its plain
   version, a cuDNN yardstick and its bound;
4. slice: the 128px MCGAN (CelebA-HQ / ImageNet protocol) at full width and
   depth, random weights from seed 0, driven as a user would: ``build_model``,
   ``Sampler.sample_chunked`` over the class sweep in chunks of 128, then
   ``discriminate``; launch counts are zeroed just before that run and read
   just after; one chunk is held against the same model run f32 through the
   plain versions.

The last three lines are the card's name and power limit as ``nvidia-smi``
gives them, one JSON object listing every kernel, and
``{"ok": true, "device": {...}}``. With ``--profile DIR`` one more G->D pass
runs under ``torch.profiler`` after the checks. There is no CPU path: without a card the
script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from mcgm_tpu_torch.config import process_control
from mcgm_tpu_torch.kernels import build
from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.ops.layers import fold_pool
from mcgm_tpu_torch.workflows.generate import class_sweep
from mcgm_tpu_torch.workflows.sampling import Sampler

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 2e-2  # max|kernel - plain| <= KERNEL_TOL * max|plain|, both bf16 out
SLICE_TOL = 5e-2   # max|bf16 path - f32 plain path| <= SLICE_TOL * max|f32 plain path|
NUM_MODE = 20
DEV = torch.device("cuda")


def log(*args):
    print(*args, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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
    what one library call per op costs; the port never calls it."""
    x, code, w1, b1, w2f, b2, w3, b3 = args
    bf = torch.bfloat16
    cin, cout = w1.shape[2], w1.shape[3]
    w1o, w2o = (w.to(bf).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                for w in (w1, w2f))
    w3o = w3.to(bf).t().reshape(cout, cin, 1, 1).contiguous()
    b1b, b2b, b3b = b1.to(bf), b2.to(bf), b3.to(bf)
    codeb = code.to(bf)[:, :, None, None]
    xc = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory

    def run():
        h = F.conv2d(xc, w1o, b1b, padding=1).relu_().mul_(codeb)
        y = F.conv2d(h, w2o, b2b, stride=2, padding=1)
        return y.add_(F.conv2d(F.avg_pool2d(xc, 2), w3o, b3b))
    return run


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
        rec["ms"] = cuda_ms(lambda: fd.first_dblock(*args), 20)
        rec["plain_ms"] = cuda_ms(lambda: fd.first_dblock_reference(*args), 10)
        rec["library_ms"] = cuda_ms(block_library_chain(args), 20)
        rec["bound_ms"], rec["bound_by"], flop, nbytes = block_bound(args)
        rec["tflops"] = flop / rec["ms"] / 1e9
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    log("first_dblock", json.dumps(rec))
    if not ok:
        raise SystemExit(f"first_dblock disagrees with its plain version at {shape}: "
                         f"max|d| {err} > {KERNEL_TOL} * {scale}")
    return rec


# ------------------------------------------------------------------- slice
PHASES = ("generate", "discriminate")


def kernel_category(name: str) -> str:
    if "first_dblock" in name:
        return "first_dblock (hand kernel)"
    if "xmma" in name or "cudnn" in name:
        return "conv (cuDNN)"
    if any(k in name for k in ("gemv", "gemm", "nvjet", "cublas", "dot_kernel")):
        return "matmul (cuBLAS: Dense, SN power iterations)"
    if "upsample" in name:
        return "nearest upsample"
    return "elementwise, casts, reductions, pooling"


def profile_pass(g_then_d, out_dir: str) -> dict:
    """One G->D pass of the sweep under ``torch.profiler``: device time by
    kernel, by category and by phase (``generate`` / ``discriminate``), the
    device's busy share of the host window, and a chrome trace in
    ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, t_g, t_gd = g_then_d(7, annotate=True)
    prof.export_chrome_trace(os.path.join(out_dir, "slice_trace.json"))

    # Device-side events: the kernels (and memsets / copies), plus one
    # annotation per phase that spans that phase's kernels on the device's
    # timeline. A kernel launched through ctypes has no aten op above it, so
    # only these device-side events see it.
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name: e.time_range for e in dev if e.name in PHASES}
    kern = [e for e in dev if e.name not in PHASES]
    by_name, by_cat = {}, {}
    phase_busy = dict.fromkeys(PHASES, 0.0)
    for e in kern:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + ms, n + 1)
        cat = kernel_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        for p, r in spans.items():
            if r.start <= e.time_range.start < r.end:
                phase_busy[p] += ms
    kernels = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda k: -k[1])
    busy = sum(ms for _, ms, _ in kernels)
    rec = {"window_ms": t_gd * 1e3, "generate_window_ms": t_g * 1e3, "device_busy_ms": busy,
           "device_busy_share": busy / (t_gd * 1e3),
           "phase_device_span_ms": {p: (r.end - r.start) / 1e3 for p, r in spans.items()},
           "phase_device_busy_ms": phase_busy,
           "category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
           "top_kernels": [{"name": n[:120], "ms": ms, "calls": c} for n, ms, c in kernels[:10]]}
    with open(os.path.join(out_dir, "slice_profile.json"), "w") as f:
        json.dump(dict(rec, all_kernels=[{"name": n, "ms": ms, "calls": c}
                                         for n, ms, c in kernels]), f, indent=1)
    return rec


def run_slice(name_limit: str, profile_dir: str | None = None):
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
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    times = [g_then_d(2 + i)[2:] for i in range(3)]
    gen_ips = len(C) / statistics.median(t for t, _ in times)
    gd_ips = len(C) / statistics.median(t for _, t in times)
    log(f"slice: counted run {t_g * 1e3:.1f} ms generate, {t_gd * 1e3:.1f} ms G->D; "
        f"launches {launches}")

    bad = []
    if launches["first_dblock"] < 1:
        bad.append("the main path never launched first_dblock")
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
    if profile_dir:
        log("profile:", json.dumps(profile_pass(g_then_d, profile_dir)))
    return launches, result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one G->D pass; trace and tables go to DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False  # the plain versions are f32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    name_limit = card()
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

    full = check_first_dblock((128, 128, 128, 3, 64), seed=0, timed=True)
    check_first_dblock((16, 128, 128, 3, 64), seed=3, timed=False)  # the sweep's tail chunk
    check_first_dblock((3, 32, 32, 3, 128), seed=1, timed=False)
    check_first_dblock((2, 30, 70, 1, 64), seed=2, timed=False)

    launches, _ = run_slice(name_limit, args.profile)

    kernels = [{
        "name": "first_dblock", "route": "cuda",
        "source": "mcgm_tpu_torch/csrc/first_dblock.cu",
        "replaces": "tools/ab_first_block.py:159",
        "launches": launches["first_dblock"], "max_abs_err": full["max_abs_err"],
        "ms": full["ms"], "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
        "max_err": full["max_abs_err"], "kernel_ms": full["ms"],
        "bound_by": full["bound_by"], "library_ms": full["library_ms"],
        "library": "cuDNN bf16 chain: conv3x3, relu*code, conv4x4/s2, avgpool+conv1x1",
        "shape": full["shape"],
    }]
    log(name_limit)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
