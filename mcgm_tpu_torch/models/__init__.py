"""Model factory (port of ``mcgm_tpu/models/__init__.py``: mcgan, cgan,
mcvae, cvae, vqvae, mcpixelcnn, cpixelcnn, mcglow, cglow and the
classifier)."""

from __future__ import annotations

from torch import nn

from ..ops.layers import resolve_compute_dtype
from ..utils import resolve_device
from .classifier import Classifier
from .gan import CGAN, MCGAN
from .glow import CGlow, MCGlow
from .pixelcnn import CPixelCNN, MCPixelCNN
from .vae import CVAE, MCVAE
from .vqvae import VQVAE

PORTED = ("mcgan", "cgan", "mcvae", "cvae", "vqvae", "mcpixelcnn", "cpixelcnn", "mcglow", "cglow",
          "classifier")


def build_model(cfg: dict, device=None) -> nn.Module:
    """Build the model a processed config names, in eval mode on ``device``
    (the card unless the caller passes ``"cpu"``), with random weights from
    ``cfg["init_seed"]`` (default 0).

    ``cfg["classes_size"]`` must be set (but for vqvae); ``cfg["compute_dtype"]``
    ('auto' by default) picks the activation dtype of the GANs, the VAEs,
    the VQ-VAE, the PixelCNNs and Glow's convs. The classifier runs f32.
    A Glow takes ``reversible_flows`` (the ``glow`` section's or the
    config's own); a pipeline axis is refused.
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
    if name in ("mcpixelcnn", "cpixelcnn"):
        p = cfg["pixelcnn"]
        if name == "mcpixelcnn":
            model = MCPixelCNN(p["num_embedding"], p["hidden_size"], p["num_layer"],
                               cfg["classes_size"], cfg.get("controller_rate", 0.5), dtype, seed)
        else:
            model = CPixelCNN(p["num_embedding"], p["hidden_size"], p["num_layer"],
                              cfg["classes_size"], dtype, seed)
        return model.to(dev).eval()
    if name in ("mcglow", "cglow"):
        p = cfg["glow"]
        opts = dict(scan_flows=p.get("scan_flows", True), scan_chunk=p.get("scan_chunk", 1),
                    remat_flows=p.get("remat_flows", True), scan_unroll=p.get("scan_unroll", 1),
                    reversible_flows=p.get("reversible_flows", False)
                    or cfg.get("reversible_flows", False),
                    pipe_axis=p.get("pipe_axis")
                    or ("pipe" if int(cfg.get("pipe_size", 1) or 1) > 1 else None))
        args = (shape, p["hidden_size"], p["K"], p["L"], p["affine"], p["conv_lu"],
                cfg["classes_size"])
        if name == "mcglow":
            model = MCGlow(*args, cfg.get("controller_rate", 0.5), dtype, seed, **opts)
        else:
            model = CGlow(*args, dtype, seed, **opts)
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
