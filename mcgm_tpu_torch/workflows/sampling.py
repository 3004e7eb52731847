"""Sampling backend of the generate / transit / create workflows: the GAN,
VAE and Glow families, and the PixelCNN family with its frozen VQ-VAE (a
VQ-VAE alone cannot sample). Port of ``mcgm_tpu/workflows/sampling.py``.
A Glow's z is one normal per level of ``make_z_shapes`` (``[n, h, w, c]``,
level order), which its reverse pass turns into images.

Noise comes from an explicit ``torch.Generator``; JAX and torch streams
differ, so parity tests hand both packages the same z. A PixelCNN draws no
latent: ``sample`` runs the incremental sampler
(``models.pixelcnn.sample_codes_incremental``, its uniforms from the
generator), then the VQ-VAE's ``decode_code``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import process_control
from ..io.checkpoint import load_model_dict
from ..io.jax_import import from_jax_variables
from ..models import build_model
from ..models.pixelcnn import sample_codes_incremental
from ..utils import ckpt_path


class Sampler:
    def __init__(self, cfg: dict, model, ae_model=None):
        self.cfg = cfg
        self.model = model
        self.ae_model = ae_model  # a PixelCNN's frozen VQ-VAE

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def with_state(self, state: dict, classes_size: int | None = None) -> "Sampler":
        """A sampler over a copy of the model holding ``state`` (a
        ``state_dict``, as ``models.manipulate`` returns): the counterpart of
        the JAX package's ``with_variables``. With another ``classes_size``
        the model is rebuilt with that many modes and holds only its
        ``sampling_module`` (a GAN's generator, a VAE's decoder): created
        modes are generated, never discriminated or encoded (and the
        reference's torch stream leaves CGAN's D embedding at the trained
        mode count). A Glow or a PixelCNN samples with all of itself."""
        cfg = self.cfg
        if classes_size is None or classes_size == cfg["classes_size"]:
            model = copy.deepcopy(self.model)
            model.load_state_dict(state)
            return Sampler(cfg, model, self.ae_model)
        cfg = dict(cfg, classes_size=classes_size)
        model = build_model(cfg, self.device)
        model.compute_dtype = self.model.compute_dtype
        if self.ae_model is not None or not hasattr(model, "sampling_module"):
            model.load_state_dict(state)
            return Sampler(cfg, model, self.ae_model)
        keep = model.sampling_module
        for name, _ in list(model.named_children()):
            if name != keep:
                delattr(model, name)
        getattr(model, keep).load_state_dict(
            {k[len(keep) + 1:]: t for k, t in state.items() if k.startswith(keep + ".")})
        return Sampler(cfg, model)

    def sample_z(self, n: int, generator: torch.Generator):
        """``[n, latent]`` normal noise (a Glow: a list, one per level); None
        for a PixelCNN, whose uniforms are drawn position by position at
        sample time."""
        if self.ae_model is not None:
            return None
        if hasattr(self.model, "make_z_shapes"):
            return [z.to(self.device) for z in self.model.sample_z(n, generator)]
        if not hasattr(self.model, "latent_size"):
            raise ValueError(f"{self.cfg['model_name']} cannot sample: it decodes codes, "
                             "not latents (its sampler is the PixelCNN's)")
        z = torch.randn((n, self.model.latent_size), generator=generator,
                        device=generator.device)
        return z.to(self.device)

    @torch.no_grad()
    def sample_with_z(self, C, z) -> torch.Tensor:
        """NHWC images in [-1, 1], f32, on the model's device."""
        if self.ae_model is not None:
            raise ValueError("pixelcnn sampling is autoregressive: call sample(C, generator)")
        C = torch.as_tensor(np.asarray(C), dtype=torch.long, device=self.device)
        z = [t.to(self.device) for t in z] if isinstance(z, list) else z.to(self.device)
        return self.model.generate(C, z)

    def sample(self, C, generator: torch.Generator) -> torch.Tensor:
        if self.ae_model is None:
            return self.sample_with_z(C, self.sample_z(len(C), generator))
        side = self.cfg["data_shape"][0] // 4  # the VQ-VAE's code grid
        codes = sample_codes_incremental(self.model, C, generator, (side, side))
        with torch.no_grad():
            return self.ae_model.decode_code(codes)

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
    overrides the config's. A PixelCNN's sampler also loads its VQ-VAE,
    ``{seed}_{data}_{subset}_{ae_name}_best`` with the seed of ``tag``."""
    cfg = dict(cfg)
    if classes_size is not None:
        cfg["classes_size"] = classes_size
    model = build_model(cfg, device)
    if variables is None:
        variables = load_model_dict(ckpt_path(cfg, tag, "best"))
    model.load_state_dict(from_jax_variables(variables))
    ae_model = None
    if cfg["model_name"] in ("mcpixelcnn", "cpixelcnn"):
        ae_tag = "_".join(p for p in (tag.split("_")[0], cfg["data_name"], cfg["subset"],
                                      cfg["ae_name"]) if p)
        ae_cfg = dict(process_control({**cfg, "model_name": cfg["ae_name"]}),
                      classes_size=cfg["classes_size"])
        ae_model = build_model(ae_cfg, device)
        ae_model.load_state_dict(from_jax_variables(load_model_dict(ckpt_path(cfg, ae_tag,
                                                                              "best"))))
    return Sampler(cfg, model, ae_model)
