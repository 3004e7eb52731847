"""Model factory (port of ``mcgm_tpu/models/__init__.py``: mcgan, cgan,
mcvae, cvae, vqvae and the classifier)."""

from __future__ import annotations

from torch import nn

from ..ops.layers import resolve_compute_dtype
from ..utils import resolve_device
from .classifier import Classifier
from .gan import CGAN, MCGAN
from .vae import CVAE, MCVAE
from .vqvae import VQVAE

PORTED = ("mcgan", "cgan", "mcvae", "cvae", "vqvae", "classifier")


def build_model(cfg: dict, device=None) -> nn.Module:
    """Build the model a processed config names, in eval mode on ``device``
    (the card unless the caller passes ``"cpu"``), with random weights from
    ``cfg["init_seed"]`` (default 0).

    ``cfg["classes_size"]`` must be set (but for vqvae); ``cfg["compute_dtype"]``
    ('auto' by default) picks the activation dtype of the GANs, the VAEs and
    the VQ-VAE. The classifier runs f32.
    """
    name = cfg["model_name"]
    if name not in PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue A)")
    dev = resolve_device(device)
    shape, seed = tuple(cfg["data_shape"]), cfg.get("init_seed", 0)
    if name == "classifier":
        model = Classifier(shape, tuple(cfg["classifier"]["hidden_size"]), cfg["classes_size"],
                           seed)
        return model.to(dev).eval()
    dtype = resolve_compute_dtype(cfg.get("compute_dtype"), dev)
    if name in ("mcvae", "cvae"):
        p = cfg["vae"]
        if name == "mcvae":
            model = MCVAE(shape, tuple(p["hidden_size"]), p["latent_size"], p["num_res_block"],
                          cfg["classes_size"], cfg.get("controller_rate", 0.5), dtype, seed)
        else:
            model = CVAE(shape, tuple(p["hidden_size"]), p["latent_size"], p["num_res_block"],
                         cfg["classes_size"], p["embedding_size"], dtype, seed)
        return model.to(dev).eval()
    if name == "vqvae":
        p = cfg["vqvae"]
        model = VQVAE(shape, tuple(p["hidden_size"]), p["num_res_block"], p["embedding_size"],
                      p["num_embedding"], p["vq_commit"], dtype, seed)
        return model.to(dev).eval()
    p = cfg["gan"]
    cifar_style = cfg["data_name"] in ("CIFAR10", "CIFAR100")
    if name == "mcgan":
        model = MCGAN(shape, p["latent_size"], tuple(p["generator_hidden_size"]),
                      tuple(p["discriminator_hidden_size"]), cfg["classes_size"],
                      cfg.get("controller_rate", 0.5), cifar_style, dtype, seed)
    else:
        model = CGAN(shape, p["latent_size"], tuple(p["generator_hidden_size"]),
                     tuple(p["discriminator_hidden_size"]), cfg["classes_size"],
                     p["embedding_size"], cifar_style, dtype, seed)
    return model.to(dev).eval()
