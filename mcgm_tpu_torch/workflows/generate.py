"""Generate workflow (port of ``mcgm_tpu/workflows/generate.py``).

``save_npy``: the class sweep ``tile(arange(classes_size),
generate_per_mode)`` in chunks of 1000, mapped to [0, 255] and dumped NCHW to
``{output_dir}/npy/generated_{tag}.npy``, with ``save_img`` also a grid of
``save_per_mode`` rows of the first (up to 100) modes. Otherwise: grids of
``save_per_mode`` rows for 10, 50 and 100 modes (those the model has),
``{output_dir}/vis/generated_{tag}_{modes}.{save_format}``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.images import save_image_grid
from ..utils import npy_path, save, vis_path
from .sampling import Sampler


def class_sweep(classes_size: int, per_mode: int) -> np.ndarray:
    """torch ``arange(K).repeat(n)`` order."""
    return np.tile(np.arange(classes_size), per_mode)


def sweep_grid(cfg: dict, images: np.ndarray, name: str) -> None:
    """The ``save_img`` grid of a class sweep: its first ``save_per_mode``
    rounds, one row each, of the first (up to 100) modes."""
    n = min(100, cfg["classes_size"])
    rows = [images[i:i + n] for i in range(0, cfg["classes_size"] * cfg["save_per_mode"],
                                           cfg["classes_size"])]
    save_image_grid(np.concatenate(rows), vis_path(cfg, f"{name}.{cfg['save_format']}"), nrow=n)


def generate(sampler: Sampler, tag: str, generator: torch.Generator | None = None):
    """The ``save_npy`` dump (returned, NCHW in [0, 255]) or, without
    ``save_npy``, the grids (returns None). Noise from ``generator``,
    seeded by the tag's seed by default."""
    cfg = sampler.cfg
    if generator is None:
        generator = torch.Generator(sampler.device).manual_seed(int(tag.split("_")[0]))
    if cfg.get("save_npy"):
        C = class_sweep(cfg["classes_size"], cfg["generate_per_mode"])
        generated = sampler.sample_chunked(C, generator).cpu().numpy()
        out = ((generated + 1) / 2 * 255).transpose(0, 3, 1, 2)
        save(out, npy_path(cfg, f"generated_{tag}"), mode="numpy")
        if cfg.get("save_img"):
            sweep_grid(cfg, generated, f"generated_{tag}")
        return out
    for modes in (10, 50, 100):
        if modes > cfg["classes_size"]:
            continue
        C = np.tile(np.arange(modes), cfg["save_per_mode"])
        saved = sampler.sample_chunked(C, generator).cpu().numpy()
        save_image_grid(saved, vis_path(cfg, f"generated_{tag}_{modes}.{cfg['save_format']}"),
                        nrow=modes)
    return None
