"""Model factory (port of ``mcgm_tpu/models/__init__.py``: mcgan, cgan and
the classifier)."""

from __future__ import annotations

from torch import nn

from ..ops.layers import resolve_compute_dtype
from ..utils import resolve_device
from .classifier import Classifier
from .gan import CGAN, MCGAN


def build_model(cfg: dict, device=None) -> nn.Module:
    """Build the model a processed config names, in eval mode on ``device``
    (the card unless the caller passes ``"cpu"``), with random weights from
    ``cfg["init_seed"]`` (default 0).

    ``cfg["classes_size"]`` must be set; ``cfg["compute_dtype"]`` ('auto' by
    default) picks the GANs' activation dtype. The classifier runs f32.
    """
    name = cfg["model_name"]
    if name not in ("mcgan", "cgan", "classifier"):
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue A)")
    dev = resolve_device(device)
    shape, seed = tuple(cfg["data_shape"]), cfg.get("init_seed", 0)
    if name == "classifier":
        model = Classifier(shape, tuple(cfg["classifier"]["hidden_size"]), cfg["classes_size"],
                           seed)
        return model.to(dev).eval()
    p = cfg["gan"]
    cifar_style = cfg["data_name"] in ("CIFAR10", "CIFAR100")
    dtype = resolve_compute_dtype(cfg.get("compute_dtype"), dev)
    if name == "mcgan":
        model = MCGAN(shape, p["latent_size"], tuple(p["generator_hidden_size"]),
                      tuple(p["discriminator_hidden_size"]), cfg["classes_size"],
                      cfg.get("controller_rate", 0.5), cifar_style, dtype, seed)
    else:
        model = CGAN(shape, p["latent_size"], tuple(p["generator_hidden_size"]),
                     tuple(p["discriminator_hidden_size"]), cfg["classes_size"],
                     p["embedding_size"], cifar_style, dtype, seed)
    return model.to(dev).eval()
