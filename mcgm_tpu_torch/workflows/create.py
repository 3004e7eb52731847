"""Create workflow (port of ``mcgm_tpu/workflows/create.py``; GAN, VAE, PixelCNN and Glow families):
generate modes that were never trained, by drawing fresh codebooks and
Dirichlet mixes of the class embeddings (``models.manipulate.create``).

- ``save_npy``: one creation at the trained ``classes_size`` (seed: the
  tag's), its class sweep dumped NCHW in [0, 255] to
  ``{output_dir}/npy/created_{tag}.npy`` (and with ``save_img`` its grid);
- otherwise: for 10, 50 and 100 created modes (seed + modes), the model is
  rebuilt with that many modes and a grid of ``save_per_mode`` rows is
  written, ``{output_dir}/vis/created_{tag}_{modes}.{save_format}``. A Glow
  on CIFAR10 draws 1,000 images per mode and keeps, per mode, the first
  ``save_per_mode`` finite ones (:func:`keep_finite_per_mode`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.images import save_image_grid
from ..models.manipulate import create
from ..utils import npy_path, save, vis_path
from .generate import class_sweep, sweep_grid
from .sampling import Sampler


def created_sampler(sampler: Sampler, classes_size: int, seed: int) -> Sampler:
    """A sampler over ``classes_size`` created modes (``cfg['torch_compat']``
    draws them as the reference's torch stream does)."""
    cfg = sampler.cfg
    state = create(sampler.model, classes_size, rng_seed=seed,
                   torch_compat=bool(cfg.get("torch_compat")), model_name=cfg["model_name"])
    return sampler.with_state(state, classes_size)


GLOW_OVERSAMPLE = 1000  # draws per created mode of a CIFAR10 Glow


def keep_finite_per_mode(images: np.ndarray, modes: int, per_mode: int) -> np.ndarray:
    """From a class sweep ``tile(arange(modes), n)`` of images ``[n * modes,
    H, W, C]``: per mode its first ``per_mode`` finite images, padded with
    its first non-finite ones where too few are finite; returned as the
    grid's rows, ``[per_mode * modes, H, W, C]`` (row ``r`` holds every
    mode's ``r``-th image)."""
    kept = []
    for j in range(modes):
        imgs = images[j::modes]
        ok = np.isfinite(imgs).all(axis=(1, 2, 3))
        good = imgs[ok][:per_mode]
        if len(good) < per_mode:
            good = np.concatenate([good, imgs[~ok][:per_mode - len(good)]])
        kept.append(good)
    grid = np.stack(kept)  # [modes, per_mode, H, W, C]
    return grid.transpose(1, 0, 2, 3, 4).reshape(-1, *grid.shape[2:])


def create_workflow(sampler: Sampler, tag: str, generator: torch.Generator | None = None):
    """The ``save_npy`` dump (returned) or the grids (returns None). Noise
    from ``generator``, seeded ``seed ^ 0xC0DE`` by default."""
    cfg = sampler.cfg
    seed = int(tag.split("_")[0])
    if generator is None:
        generator = torch.Generator(sampler.device).manual_seed(seed ^ 0xC0DE)
    if cfg.get("save_npy"):
        s = created_sampler(sampler, cfg["classes_size"], seed)
        C = class_sweep(cfg["classes_size"], cfg["generate_per_mode"])
        created = s.sample_chunked(C, generator).cpu().numpy()
        out = ((created + 1) / 2 * 255).transpose(0, 3, 1, 2)
        save(out, npy_path(cfg, f"created_{tag}"), mode="numpy")
        if cfg.get("save_img"):
            sweep_grid(cfg, created, f"created_{tag}")
        return out
    glow = "glow" in cfg["model_name"] and cfg["data_name"] == "CIFAR10"
    for modes in (10, 50, 100):
        s = created_sampler(sampler, modes, seed + modes)
        if glow:
            C = np.tile(np.arange(modes), GLOW_OVERSAMPLE)
            grid = keep_finite_per_mode(s.sample_chunked(C, generator).cpu().numpy(), modes,
                                        cfg["save_per_mode"])
        else:
            C = np.tile(np.arange(modes), cfg["save_per_mode"])
            grid = s.sample_chunked(C, generator).cpu().numpy()
        save_image_grid(grid, vis_path(cfg, f"created_{tag}_{modes}.{cfg['save_format']}"),
                        nrow=modes)
    return None
