"""Model factory (port of ``mcgm_tpu/models/__init__.py``; MCGAN only)."""

from __future__ import annotations

from ..ops.layers import resolve_compute_dtype
from ..utils import resolve_device
from .gan import MCGAN


def build_model(cfg: dict, device=None) -> MCGAN:
    """Build the model a processed config names, in eval mode on ``device``
    (the card unless the caller passes ``"cpu"``), with random weights from
    ``cfg["init_seed"]`` (default 0).

    ``cfg["classes_size"]`` must be set; ``cfg["compute_dtype"]`` ('auto' by
    default) picks the activation dtype.
    """
    name = cfg["model_name"]
    if name != "mcgan":
        raise NotImplementedError(f"model {name!r} is not ported yet (ROADMAP Queue A)")
    dev = resolve_device(device)
    p = cfg["gan"]
    model = MCGAN(
        tuple(cfg["data_shape"]), p["latent_size"], tuple(p["generator_hidden_size"]),
        tuple(p["discriminator_hidden_size"]), cfg["classes_size"],
        cfg.get("controller_rate", 0.5), cfg["data_name"] in ("CIFAR10", "CIFAR100"),
        resolve_compute_dtype(cfg.get("compute_dtype"), dev),
        cfg.get("init_seed", 0))
    return model.to(dev).eval()
