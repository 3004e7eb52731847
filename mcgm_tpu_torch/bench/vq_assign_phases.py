"""Where ``vq_assign``'s time goes: its ``tf32`` kernel's warpgroups timed
by phase with the SM clock.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    python -m mcgm_tpu_torch.bench.vq_assign_phases

Builds ``csrc/vq_assign.cu`` with ``-DVQ_ASSIGN_PHASES`` into
``build/phases/``, which turns on its ``PHASE`` marks: the first thread of
each warpgroup adds the SM cycles since its previous mark to a per-phase
total. Runs it at the VQ-VAE's shapes (D 64, K 512: a train step's N =
8,192 and an eval batch's 32,768) on random rows and codebook, checks its
codes against the committed kernel's, and prints one JSON line per shape:
the kernel's time by CUDA events over back-to-back launches, and per block
the phases' thousands of cycles, for the screen's warpgroups (0 and 1:
waiting for a tile's rows, screening it) and for warpgroup 2 (loading and
preparing the next tile's rows, waiting for the screen, deciding /
rescoring / writing a tile), the codebook's staging first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..kernels import build
from ..kernels import vq as kvq

ROLES = {0: ("wait for rows", "screen"), 8: ("wait for rows", "screen"),
         16: ("rows in (next tile)", "wait for the screen", "decide, rescore, write")}
D, K = 64, 512


def build_marked() -> ctypes.CDLL:
    out = build.BUILD_DIR / "phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "vq_assign_phases.so"
    p = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DVQ_ASSIGN_PHASES", "-o", str(lib),
                        str(build.CSRC / f"{kvq.ASSIGN}.cu")], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("vq_assign_phases: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    lib = build_marked()
    fn = lib.mcgm_vq_assign
    fn.argtypes = kvq.ASSIGN_ARGTYPES
    lib.mcgm_vq_assign_phases.argtypes = [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    for N in (8192, 32768):
        if kvq.assign_variant(N, D, K) != "tf32":
            raise SystemExit(f"vq_assign_phases: ({N}, {D}, {K}) does not take the tf32 kernel")
        x = torch.randn((N, D), generator=g, device=dev)
        emb = torch.randn((D, K), generator=g, device=dev)
        idx = torch.empty(N, dtype=torch.int32, device=dev)
        q = torch.empty((N, D), device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            return fn(x.data_ptr(), emb.data_ptr(), idx.data_ptr(), q.data_ptr(), N, D, K,
                      None, stream)
        if call() != 0:
            raise RuntimeError(f"launch failed at N = {N}")
        torch.cuda.synchronize()
        if not torch.equal(idx, kvq.vq_assign(x, emb)[0]):
            raise SystemExit("the marked kernel's codes differ from the committed kernel's")
        buf = (ctypes.c_ulonglong * 24)()
        lib.mcgm_vq_assign_phases(buf)  # drop the check's launches
        reps = 20
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        lib.mcgm_vq_assign_phases(buf)
        blocks = min(sms, (N + 63) // 64)
        per_block = [buf[i] / reps / blocks / 1e3 for i in range(24)]
        phases = {f"warpgroup {base // 8}": {
            "codebook": per_block[base + 7],
            **{name: per_block[base + i] for i, name in enumerate(names)}}
            for base, names in ROLES.items()}
        print(json.dumps({"shape": [N, D, K], "card": card, "blocks": blocks,
                          "ms": start.elapsed_time(end) / reps,
                          "kcycles_per_block": phases}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
