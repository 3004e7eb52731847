"""Where ``first_dblock``'s time goes: the kernel timed with phases removed.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python -m mcgm_tpu_torch.bench.first_dblock_phases

Builds copies of ``csrc/first_dblock.cu`` into ``build/phases/`` with
conv1, conv2 or the y stores compiled out (guards are inserted at fixed
places in a copy of the source; the kernel itself has no switches), and
times each against the full kernel at the main path's shapes: CUDA events
over back-to-back launches on packed operands. A phase's cost is the time it
adds on top of the others, e.g. conv1 = t(no_conv2) - t(no_conv1_no_conv2).
Removing a phase leaves its outputs undefined, so only the full kernel's
result is checked against the plain version. Prints one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import torch

from ..kernels import build
from ..kernels import first_dblock as fd

# (anchor in the source, text inserted before it); every anchor must occur once
GUARDS = [
    ("    const int nh = warp % C::NH;\n", "#ifndef NO_CONV1\n"),
    ("    __syncthreads();\n\n    // ---- prefetch the next work item", "#endif\n"),
    ("    if constexpr (C::RESIDENT) {\n      // A of the next tap", "#ifndef NO_CONV2\n"),
    ("    wgmma_wait<0>();\n    hold(acc);\n", "#endif\n"),
    ("      if (m >= Ho || n >= Wo) continue;\n      *reinterpret_cast<uint4*>",
     "#ifdef NO_STORE\n      continue;\n#endif\n"),
]
VARIANTS = {
    "full": [], "no_conv1": ["NO_CONV1"], "no_conv2": ["NO_CONV2"], "no_store": ["NO_STORE"],
    "no_conv1_no_conv2": ["NO_CONV1", "NO_CONV2"],
}
SHAPES = [(128, 128, 128, 3, 64), (16, 128, 128, 3, 64), (512, 32, 32, 3, 128)]


def guarded_source() -> str:
    src = (build.CSRC / f"{fd.KERNEL}.cu").read_text()
    for anchor, text in GUARDS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the kernel source: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    return src


def build_variants() -> dict[str, ctypes.CDLL]:
    out = build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "first_dblock_phases.cu"
    cu.write_text(guarded_source())
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defs), "-o",
         str(out / f"{name}.so"), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, defs in VARIANTS.items()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in VARIANTS}


def inputs(B, H, W, cin, cout, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand((B, H, W, cin), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    code = (torch.rand((B, cout), generator=g, device=dev) < 0.5).float()

    def randn(*shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale
    return [x, code, randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin)),
            randn(cout, scale=0.1), randn(4, 4, cout, cout, scale=1 / math.sqrt(9 * cout)),
            randn(cout, scale=0.1), randn(cin, cout, scale=1 / math.sqrt(cin)),
            randn(cout, scale=0.1)]


def event_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("first_dblock_phases: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_variants()
    for shape in SHAPES:
        B, H, W, cin, cout = shape
        args = inputs(*shape, dev)
        ops = fd.kernel_operands(*args)
        y = torch.empty((B, H // 2, W // 2, cout), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ms = {}
        for name, lib in libs.items():
            fn = lib.mcgm_first_dblock
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

            def call():
                return fn(*(t.data_ptr() for t in ops), y.data_ptr(), B, H, W, cin, cout, stream)
            if call() != 0:
                raise RuntimeError(f"{name}: launch failed at {shape}")
            if name == "full":
                torch.cuda.synchronize()
                ref = fd.first_dblock_reference(*args).float()
                rel = ((y.float() - ref).abs().max() / ref.abs().max()).item()
                if not rel <= 2e-2:
                    raise SystemExit(f"full kernel disagrees with the plain version: {rel}")
            ms[name] = event_ms(call)
        base = ms["no_conv1_no_conv2"]
        print(json.dumps({
            "shape": list(shape), "card": card, "ms": ms,
            "phase_ms": {"conv1": ms["no_conv2"] - base, "conv2": ms["no_conv1"] - base,
                         "y_stores": ms["full"] - ms["no_store"],
                         "rest (loads, pooled shortcut, barriers)": base}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
