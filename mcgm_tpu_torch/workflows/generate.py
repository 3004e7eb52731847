"""Generate workflow, ``save_npy`` path (port of ``mcgm_tpu/workflows/generate.py``).

The class sweep ``tile(arange(classes_size), generate_per_mode)`` is
sampled in chunks of 1000, mapped to [0, 255] and dumped NCHW to
``{output_dir}/npy/generated_{tag}.npy``. The image-grid outputs need
``io/images``, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import npy_path, save
from .sampling import Sampler


def class_sweep(classes_size: int, per_mode: int) -> np.ndarray:
    """torch ``arange(K).repeat(n)`` order."""
    return np.tile(np.arange(classes_size), per_mode)


def generate(sampler: Sampler, tag: str, generator: torch.Generator | None = None) -> np.ndarray:
    cfg = sampler.cfg
    if not cfg.get("save_npy") or cfg.get("save_img"):
        raise NotImplementedError(
            "image grids need io/images, which is not ported yet: "
            "set save_npy=True and save_img=False")
    if generator is None:
        generator = torch.Generator(sampler.device).manual_seed(int(tag.split("_")[0]))
    C = class_sweep(cfg["classes_size"], cfg["generate_per_mode"])
    generated = sampler.sample_chunked(C, generator).cpu().numpy()
    out = ((generated + 1) / 2 * 255).transpose(0, 3, 1, 2)
    save(out, npy_path(cfg, f"generated_{tag}"), mode="numpy")
    return out
