"""Where ``int8_conv``'s time goes: its TMA kernels' warpgroups timed by
phase with the SM clock.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python -m mcgm_tpu_torch.bench.int8_conv_phases

Builds ``csrc/int8_conv.cu`` with ``-DINT8_CONV_PHASES`` into
``build/phases/``, which turns on its ``PHASE`` marks: the first thread of
each warpgroup adds the SM cycles since its previous mark to a per-phase
total. Runs it at the serving artifacts' batch (B = 1,000) at the five
shapes ``chip_smoke.py`` times, checks its output against the committed
kernel's, and prints one JSON line per shape: the marked kernel's time
(``ms``) and the committed one's (``committed_ms``) by CUDA events over
back-to-back launches (20 each, on the same operands), its plan (variant,
chunk, tile, box), and per block the phases' thousands of cycles, for the producer
(warpgroup 0: waiting for a free stage, issuing the TMA loads) and the two
consumers (1, 2: waiting for x and w, the products, the epilogue).
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import torch

from ..kernels import build
from ..kernels import int8 as kint8
from .int8_cases import INT8_CASES, INT8_TIMED, SERVE_BATCH

ROLES = {0: ("wait for a free stage", "issue loads"),
         8: ("wait for x and w", "products", "epilogue"),
         16: ("wait for x and w", "products", "epilogue")}
# chip_smoke.py's timed shapes at the serving artifacts' batch
SHAPES = tuple(next(c for c in INT8_CASES if c[0] == name) for name in INT8_TIMED)
B = SERVE_BATCH


def build_marked() -> ctypes.CDLL:
    out = build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "int8_conv_phases.so"
    p = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DINT8_CONV_PHASES", "-o", str(lib),
                        str(build.CSRC / f"{kint8.KERNEL}.cu")], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_phases: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    lib = build_marked()
    fn = kint8.conv_entry(lib)
    lib.mcgm_int8_conv_phases.argtypes = [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    for name, layout, H, W, C, N, kh, kw, pad, has_bias in SHAPES:
        K = (16 if layout == kint8.UP2 else kh * kw) * C
        x = torch.randn((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
        q, xs = kint8.int8_quantize(x)
        w, ws = kint8.quantize_sym(torch.randn((N, K), generator=g, device=dev) / math.sqrt(K),
                                   (1,))
        ws = ws.reshape(-1)
        bias = (0.1 * torch.randn(N, generator=g, device=dev)).to(torch.bfloat16) \
            if has_bias else None
        want = kint8.int8_conv(q, w, ws, xs, bias, layout, kh, kw, pad, torch.bfloat16)
        out = torch.empty_like(want)
        args, plan = kint8.conv_launch_args(q, w, ws, xs, bias, layout, kh, kw, pad, out)

        committed = kint8.conv_entry(build.load(kint8.KERNEL))

        def timed(entry, reps=20):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(reps):
                entry(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps

        if fn(*args) != 0:
            raise RuntimeError(f"launch failed at {name}")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise SystemExit(f"{name}: the marked kernel's output differs from the committed one")
        committed_ms = timed(committed)  # the kernel without its marks, as it ships
        buf = (ctypes.c_ulonglong * 24)()
        lib.mcgm_int8_conv_phases(buf)  # drop the check's launch
        reps = 20
        ms = timed(fn, reps)
        lib.mcgm_int8_conv_phases(buf)
        blocks = min(sms, plan.get("tiles", 1))
        per_block = [buf[i] / reps / blocks / 1e3 for i in range(24)]
        phases = {f"warpgroup {base // 8}": {n: per_block[base + i] for i, n in enumerate(names)}
                  for base, names in ROLES.items()}
        print(json.dumps({"case": name, "shape": [B, H, W, C, N], "card": card,
                          "plan": {k: plan[k] for k in ("variant", "kc", "bn", "box", "tiles")
                                   if k in plan},
                          "blocks": blocks, "ms": ms, "committed_ms": committed_ms,
                          "kcycles_per_block": phases}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
