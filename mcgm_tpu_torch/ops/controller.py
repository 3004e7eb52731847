"""MultimodalController: per-mode binary channel gating.

Port of ``mcgm_tpu/ops/controller.py``. Each mode owns a fixed binary mask
over channels, drawn once from Bernoulli(rate) with de-duplication; the
forward pass gates activations by the mask row(s) the indicator selects. The
mask carries no gradient. Activations here are NCHW, so the mask broadcasts
over the trailing spatial axes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def make_codebook_torch_compat(seed: int, num_mode: int, features: int,
                               controller_rate: float = 0.5) -> np.ndarray:
    """The reference implementation's codebook: Bernoulli(rate) batches of
    ``[num_mode, features]`` from torch's generator seeded with ``seed``,
    deduplicated through a set of float tuples, the first ``num_mode`` rows
    in the set's order (the JAX package's ``make_codebook_torch_compat``; a
    generator of its own, so the global one is left as it was)."""
    if controller_rate == 1:
        return np.ones((num_mode, features), np.float32)
    g = torch.Generator().manual_seed(int(seed))
    probs = torch.tensor(float(controller_rate)).expand(num_mode, features)
    codebook: set = set()
    while len(codebook) < num_mode:
        codebook.update(tuple(c) for c in torch.bernoulli(probs, generator=g).tolist())
    return np.asarray(list(codebook)[:num_mode], np.float32)


def make_codebook(seed: int, num_mode: int, features: int,
                  controller_rate: float = 0.5, torch_compat: bool = False) -> np.ndarray:
    """``num_mode`` unique binary masks of length ``features`` as float32.

    The same numpy ``default_rng`` draw and insertion-ordered dedupe as the
    JAX package's ``make_codebook``, so an int seed gives the same rows;
    ``torch_compat``: the reference's rows (:func:`make_codebook_torch_compat`).
    """
    if controller_rate == 1:
        return np.ones((num_mode, features), np.float32)
    if torch_compat:
        return make_codebook_torch_compat(seed, num_mode, features, controller_rate)
    if features < 24 and 2 ** features < num_mode:
        raise ValueError(
            f"cannot draw {num_mode} unique masks from {{0,1}}^{features}")
    rng = np.random.default_rng(int(seed))
    seen: dict[bytes, np.ndarray] = {}
    for _ in range(10000):
        batch = (rng.random((num_mode, features)) < controller_rate).astype(np.uint8)
        for row in batch:
            seen.setdefault(row.tobytes(), row)
        if len(seen) >= num_mode:
            break
    else:
        raise RuntimeError("codebook dedupe did not converge")
    rows = list(seen.values())[:num_mode]
    return np.stack(rows).astype(np.float32)


def one_hot(labels: torch.Tensor, num_mode: int) -> torch.Tensor:
    """Float one-hot indicator rows ``[B, num_mode]``."""
    return F.one_hot(labels.long(), num_mode).float()


def mode_code(indicator: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Per-sample channel mask ``indicator @ codebook`` ``[B, C]``, detached.

    ``indicator`` may be one-hot or a soft row-mixing matrix.
    """
    return (indicator @ codebook.to(indicator.dtype)).detach()


def mc_gate(x: torch.Tensor, indicator: torch.Tensor,
            codebook: torch.Tensor) -> torch.Tensor:
    """Gate channel axis 1 of ``x`` by each sample's mode mask."""
    code = mode_code(indicator, codebook)
    shape = (x.shape[0], code.shape[-1]) + (1,) * (x.ndim - 2)
    return x * code.reshape(shape).to(x.dtype)


class MultimodalController(nn.Module):
    """Holds the ``[num_mode, features]`` codebook as a buffer, so it rides in
    the state_dict but no optimizer sees it."""

    def __init__(self, features: int, num_mode: int,
                 controller_rate: float = 0.5, seed: int = 0):
        super().__init__()
        self.register_buffer("codebook", torch.from_numpy(
            make_codebook(seed, num_mode, features, controller_rate)))

    def forward(self, x: torch.Tensor, indicator: torch.Tensor) -> torch.Tensor:
        return mc_gate(x, indicator, self.codebook)


class Seeds:
    """Draws one codebook seed per controller from a model's generator, so
    that one init seed gives every controller of the model its own masks."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def mc(self, features: int, num_mode: int, rate: float) -> MultimodalController:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator))
        return MultimodalController(features, num_mode, rate, seed)
