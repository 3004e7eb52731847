"""Transit workflow (port of ``mcgm_tpu/workflows/transit.py``).

For 10, 50 and 100 modes (those the model has): one z per mode, then for
each of the ``save_per_mode + 1`` alphas in ``linspace(0, 1, ...)`` the
codebooks and embeddings moved toward root mode 0
(``models.manipulate.transit``, always from the trained model) and the same
z generated again; the rows stack into one grid per panel,
``{output_dir}/vis/transited_{tag}_{modes}.{save_format}``.

A PixelCNN has no z: its fixed noise is the generator's state, restored
before each alpha, so every row samples from the same uniforms. (The JAX
package's transit refuses a PixelCNN: its ``sample_with_z`` raises.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.images import save_image_grid
from ..models.manipulate import transit
from ..utils import vis_path
from .sampling import Sampler


def transit_workflow(sampler: Sampler, tag: str, generator: torch.Generator | None = None,
                     root: int = 0) -> dict:
    """Returns ``{modes: grid images [(save_per_mode + 1) * modes, H, W, C]}``."""
    cfg = sampler.cfg
    if generator is None:
        generator = torch.Generator(sampler.device).manual_seed(int(tag.split("_")[0]))
    alphas = np.linspace(0, 1, cfg["save_per_mode"] + 1)
    results = {}
    for modes in (10, 50, 100):
        if modes > cfg["classes_size"]:
            continue
        C = np.arange(modes)
        z = sampler.sample_z(modes, generator)
        state = generator.get_state()
        rows = []
        for a in alphas:
            s = sampler.with_state(transit(sampler.model, root, float(a)))
            if z is None:  # autoregressive: the same uniforms for every alpha
                generator.set_state(state)
                rows.append(s.sample(C, generator).cpu().numpy())
            else:
                rows.append(s.sample_with_z(C, z).cpu().numpy())
        grid = np.concatenate(rows)
        save_image_grid(grid, vis_path(cfg, f"transited_{tag}_{modes}.{cfg['save_format']}"),
                        nrow=modes)
        results[modes] = grid
    return results
