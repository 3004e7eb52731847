"""Configuration: the YAML defaults, the control string, the model tag, and
the per-dataset shapes and derived hyperparameters.

Port of ``mcgm_tpu/config.py`` (``load_config``, ``apply_control_name``,
``make_model_tag``, ``_DATA_SHAPES`` and ``process_control`` for the GAN
family, the VAE family, the VQ-VAE and the classifier). Shapes are NHWC ``(H, W, C)`` as in the JAX package. The defaults
are the port's own ``config.yml``: the JAX package's keys less those of its
TPU machinery (meshes, seed-parallel sweeps, dispatch groups, compile cache),
with ``device: cuda``.
"""

from __future__ import annotations

import copy
import os
import re

import yaml

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "config.yml")


def load_config(path: str | None = None, overrides: dict | None = None) -> dict:
    """The YAML defaults (the packaged ``config.yml`` unless ``path``), with
    every override that is not ``None`` applied; a fresh dict."""
    with open(path or _DEFAULT_PATH) as f:
        cfg = yaml.safe_load(f)
    for k, v in (overrides or {}).items():
        if v is not None:
            cfg[k] = v
    return cfg


def apply_control_name(cfg: dict, control_name: str | None) -> dict:
    """Zip a positional ``control_name`` (``'0.5'``) onto ``cfg['control']``'s
    keys; the string ``'None'`` clears the control dict (the ``c*``
    baselines, whose tag then has no rate). Sets ``cfg['control_name']``."""
    cfg = copy.deepcopy(cfg)
    if control_name:
        if control_name == "None":
            cfg["control"] = {}
        else:
            cfg["control"] = dict(zip(cfg["control"].keys(), control_name.split("_")))
    cfg["control_name"] = "_".join(str(cfg["control"][k]) for k in cfg["control"])
    return cfg


def make_model_tag(cfg: dict, seed: int | None = None) -> str:
    """``{seed}_{data}_{subset}_{model}[_{control}]``: the name every
    artifact of one run carries, in both packages."""
    seed = cfg["init_seed"] if seed is None else seed
    parts = [str(seed), cfg["data_name"], cfg["subset"], cfg["model_name"],
             cfg.get("control_name", "")]
    return "_".join(p for p in parts if p)


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
_VAE_FAMILY = ("cvae", "mcvae")
_PORTED = _GAN_FAMILY + _VAE_FAMILY + ("vqvae", "classifier")


def _batch_size(cfg: dict, res: int) -> None:
    if "batch_size" not in cfg or cfg.get("derive_batch_size", True):
        cfg["batch_size"] = ({"train": 128, "test": 512} if res == 32
                             else {"train": 32, "test": 128})


def process_control(cfg: dict) -> dict:
    """Derive ``data_shape``, ``generate_per_mode``, ``batch_size`` and the
    model's hyperparameters from ``data_name`` / ``model_name``.

    ``Synthetic{K}`` / ``SyntheticGray{K}`` take the shape of their base and
    the per-mode protocol of a dataset with that many modes. The GAN
    family's, the VAE family's, the VQ-VAE's and the classifier's
    hyperparameters are ported; other models raise until their slice lands
    (ROADMAP Queue A). With ``derive_model_params=False`` a caller-supplied
    ``gan`` / ``vae`` / ``vqvae`` dict is kept, as the tests do for tiny
    models.
    """
    cfg = copy.deepcopy(cfg)
    if "controller_rate" in cfg.get("control", {}):
        cfg["controller_rate"] = float(cfg["control"]["controller_rate"])
    data_name = cfg["data_name"]
    m = re.fullmatch(r"(Synthetic|SyntheticGray)(\d+)", data_name)
    if m:
        k = int(m.group(2))
        shape = _DATA_SHAPES[m.group(1)][0]
        per_mode = 20 if k >= 1000 else (100 if k > 10 else 8)
    elif data_name not in _DATA_SHAPES:
        raise ValueError(f"Not valid dataset: {data_name}")
    else:
        shape, per_mode = _DATA_SHAPES[data_name]
    cfg["data_shape"] = list(shape)
    cfg["generate_per_mode"] = per_mode
    res = shape[0]
    if not cfg.get("derive_model_params", True):
        cfg.setdefault("classifier", {"hidden_size": [8, 16, 32, 64]})
        _batch_size(cfg, res)
        return cfg
    name = cfg["model_name"]
    if name not in _PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP Queue A)")
    if cfg.get("ae_name") == "vqvae":
        cfg["vqvae"] = {"hidden_size": [128, 128] if res == 32 else [128, 128, 128, 128],
                        "num_res_block": 2, "embedding_size": 64, "num_embedding": 512,
                        "vq_commit": 0.25}
    if name in _GAN_FAMILY:
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
    elif name in _VAE_FAMILY:
        cfg["vae"] = {
            "hidden_size": [64, 128, 256] if res == 32 else [64, 128, 256, 512, 512],
            "latent_size": 128 if res == 32 else 256,
            "num_res_block": 2,
            "embedding_size": 32,
        }
    cfg["classifier"] = {"hidden_size": [8, 16, 32, 64]}
    _batch_size(cfg, res)
    return cfg
