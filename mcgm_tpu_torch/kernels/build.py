"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, so it compiles with
``nvcc`` alone in seconds (no PyTorch headers) into
``build/lib<name>-<hash>.so`` at the root of the checkout. The hash is taken
over the source, so an edited source is rebuilt and a stale library is never
loaded. Nothing is built when a module is imported: the first call that
launches a kernel builds it, or a caller builds them all up front with
:func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernels in ``csrc/`` (one ``.cu`` each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path, ptxas_verbose: bool) -> list[str]:
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_all(names=None, ptxas_verbose: bool = False) -> dict[str, dict]:
    """Compile every named source that has no current library, one ``nvcc``
    each, all started together. Returns ``{name: {"seconds", "log"}}``
    (``log`` holds the compiler's output, with ``-Xptxas -v`` the registers
    and shared memory of each kernel); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = sources() if names is None else list(names)
    report, started = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_verbose:
            report[name] = {"seconds": 0.0, "log": "cached"}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(_command(name, tmp, ptxas_verbose),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.mcgm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mcgm_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError`` after
    the launch: a refused launch never runs, and a synchronise would not
    report it)."""
    if err != 0:
        msg = lib.mcgm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
