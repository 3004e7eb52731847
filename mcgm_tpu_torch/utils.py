"""IO helpers, artifact paths and device resolution.

Port of ``mcgm_tpu/utils.py``: the same artifact layout under
``cfg["output_dir"]`` so checkpoints and dumps written by either package are
found by the other.
"""

from __future__ import annotations

import os
import pickle
import subprocess

import numpy as np
import torch


def makedir_exist_ok(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def save(obj, path: str, mode: str = "pickle") -> None:
    """Persist an object atomically: write ``path + '.tmp'``, then
    ``os.replace`` it into place, so an interrupted writer never leaves a
    truncated file where the last good one was."""
    if mode not in ("pickle", "numpy"):
        raise ValueError("Not valid save mode")
    makedir_exist_ok(os.path.dirname(path) or ".")
    if mode == "numpy" and not path.endswith(".npy"):
        path = path + ".npy"  # np.save's own suffix convention
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        if mode == "pickle":
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        else:
            np.save(f, obj, allow_pickle=True)
    os.replace(tmp, path)


def ckpt_path(cfg: dict, tag: str, kind: str) -> str:
    return os.path.join(cfg["output_dir"], "model", f"{tag}_{kind}.pkl")


def npy_path(cfg: dict, name: str) -> str:
    return os.path.join(cfg["output_dir"], "npy", f"{name}.npy")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one that raises: the port never
    carries on silently on the CPU; pass ``device="cpu"`` to ask for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def card_name_and_limit() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``): the line to keep beside every
    number measured on it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
