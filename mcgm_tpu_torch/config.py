"""Per-dataset shapes and derived model hyperparameters.

Port of ``mcgm_tpu/config.py`` (``_DATA_SHAPES`` and the GAN branch of
``process_control``). Shapes are NHWC ``(H, W, C)`` as in the JAX package.
"""

from __future__ import annotations

import copy

# Per-dataset shape / sampling protocol: (data_shape, generate_per_mode).
_DATA_SHAPES = {
    "MNIST": ((32, 32, 1), 1000),
    "FashionMNIST": ((32, 32, 1), 1000),
    "EMNIST": ((32, 32, 1), 1000),
    "Omniglot": ((32, 32, 1), 20),
    "SVHN": ((32, 32, 3), 1000),
    "CIFAR10": ((32, 32, 3), 1000),
    "CIFAR100": ((32, 32, 3), 1000),
    "COIL100": ((32, 32, 3), 100),
    "ImageNet32": ((32, 32, 3), 20),
    "Synthetic": ((32, 32, 3), 8),
    "SyntheticGray": ((32, 32, 1), 8),
    "CelebA-HQ": ((128, 128, 3), 20),
    "ImageNet": ((128, 128, 3), 20),
}

_GAN_FAMILY = ("cgan", "mcgan")


def process_control(cfg: dict) -> dict:
    """Derive ``data_shape``, ``generate_per_mode``, the ``gan`` dict and
    ``batch_size`` from ``data_name`` / ``model_name``.

    Only the GAN family is ported; the others raise until their slice lands
    (ROADMAP Queue A). With ``derive_model_params=False`` a caller-supplied
    ``gan`` dict is kept, as the JAX package's tests do for tiny models.
    """
    cfg = copy.deepcopy(cfg)
    if "controller_rate" in cfg.get("control", {}):
        cfg["controller_rate"] = float(cfg["control"]["controller_rate"])
    data_name = cfg["data_name"]
    if data_name not in _DATA_SHAPES:
        raise ValueError(f"Not valid dataset: {data_name}")
    shape, per_mode = _DATA_SHAPES[data_name]
    cfg["data_shape"] = list(shape)
    cfg["generate_per_mode"] = per_mode
    res = shape[0]
    if "batch_size" not in cfg or cfg.get("derive_batch_size", True):
        cfg["batch_size"] = ({"train": 128, "test": 512} if res == 32
                             else {"train": 32, "test": 128})
    if not cfg.get("derive_model_params", True):
        return cfg
    name = cfg["model_name"]
    if name not in _GAN_FAMILY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP Queue A)")
    if res == 32:
        if data_name in ("CIFAR10",):
            g_hidden, d_hidden = [256] * 4, [128] * 4
        else:
            g_hidden, d_hidden = [512, 256, 128, 64], [64, 128, 256, 512]
    else:
        g_hidden = [1024, 512, 256, 128, 64]
        d_hidden = [64, 128, 256, 512, 1024]
    cfg["gan"] = {
        "latent_size": 128,
        "generator_hidden_size": g_hidden,
        "discriminator_hidden_size": d_hidden,
        "embedding_size": 32,
    }
    return cfg
