"""Sampling backend of the generate / transit / create workflows, GAN
family. Port of ``mcgm_tpu/workflows/sampling.py``.

Noise comes from an explicit ``torch.Generator``; JAX and torch streams
differ, so parity tests hand both packages the same z.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..io.checkpoint import load_model_dict
from ..io.jax_import import from_jax_variables
from ..models import build_model
from ..utils import ckpt_path


class Sampler:
    def __init__(self, cfg: dict, model):
        self.cfg = cfg
        self.model = model

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def with_state(self, state: dict, classes_size: int | None = None) -> "Sampler":
        """A sampler over a copy of the model holding ``state`` (a
        ``state_dict``, as ``models.manipulate`` returns): the counterpart of
        the JAX package's ``with_variables``. With another ``classes_size``
        the model is rebuilt with that many modes and holds the generator
        only: created modes are generated, never discriminated (and the
        reference's torch stream leaves CGAN's D embedding at the trained
        mode count)."""
        cfg = self.cfg
        if classes_size is None or classes_size == cfg["classes_size"]:
            model = copy.deepcopy(self.model)
            model.load_state_dict(state)
            return Sampler(cfg, model)
        cfg = dict(cfg, classes_size=classes_size)
        model = build_model(cfg, self.device)
        model.compute_dtype = self.model.compute_dtype
        del model.discriminator
        model.generator.load_state_dict(
            {k[len("generator."):]: t for k, t in state.items() if k.startswith("generator.")})
        return Sampler(cfg, model)

    def sample_z(self, n: int, generator: torch.Generator) -> torch.Tensor:
        z = torch.randn((n, self.model.latent_size), generator=generator,
                        device=generator.device)
        return z.to(self.device)

    @torch.no_grad()
    def sample_with_z(self, C, z: torch.Tensor) -> torch.Tensor:
        """NHWC images in [-1, 1], f32, on the model's device."""
        C = torch.as_tensor(np.asarray(C), dtype=torch.long, device=self.device)
        return self.model.generate(C, z.to(self.device))

    def sample(self, C, generator: torch.Generator) -> torch.Tensor:
        return self.sample_with_z(C, self.sample_z(len(C), generator))

    def sample_chunked(self, C, generator: torch.Generator, chunk: int = 1000) -> torch.Tensor:
        """Class sweep in fixed-size chunks; the tail is padded with mode 0 to
        the chunk size (one shape for every call) and cut back."""
        C = np.asarray(C)
        out = []
        for i in range(0, len(C), chunk):
            Ci = C[i:i + chunk]
            if len(Ci) < chunk:
                pad = np.zeros(chunk - len(Ci), Ci.dtype)
                out.append(self.sample(np.concatenate([Ci, pad]), generator)[:len(Ci)])
            else:
                out.append(self.sample(Ci, generator))
        return torch.cat(out)


def load_sampler(cfg: dict, tag: str, classes_size: int | None = None, variables=None,
                 device=None) -> Sampler:
    """A Sampler on ``device`` (the card by default) with the weights of
    ``variables`` (flax variables as nested numpy dicts) or, by default, of
    the ``{tag}_best`` checkpoint either package wrote; ``classes_size``
    overrides the config's."""
    cfg = dict(cfg)
    if classes_size is not None:
        cfg["classes_size"] = classes_size
    model = build_model(cfg, device)
    if variables is None:
        variables = load_model_dict(ckpt_path(cfg, tag, "best"))
    model.load_state_dict(from_jax_variables(variables))
    return Sampler(cfg, model)
