"""Feature models for IS / FID. Port of ``mcgm_tpu/evals/features.py``.

Resolution order, as in the JAX package:

1. COIL100 / Omniglot: the repo-trained classifier checkpoint
   (``0_{data}_{subset}_classifier_best``);
2. any dataset: InceptionV3 if ``{output_dir}/inception/inception_v3.pkl``
   exists (``evals.inception``);
3. the classifier checkpoint for that dataset, if there is one;
4. otherwise ``None``, and the caller skips IS / FID (a message says so).

Each feature function maps NHWC images in [-1, 1] to ``(features, class
probabilities)`` on its device.
"""

from __future__ import annotations

import os

import torch

from ..data.loader import normalize_images
from ..io.checkpoint import load_checkpoint
from ..io.jax_import import from_jax_classifier
from ..models.classifier import Classifier
from ..utils import resolve_device


def classifier_feature_fn(cfg: dict, variables, device=None):
    """``img -> (features, probs)`` of the classifier with ``variables``
    (the JAX package's tree, as its checkpoints hold it)."""
    dev = resolve_device(device)
    model = Classifier(tuple(cfg["data_shape"]), tuple(cfg["classifier"]["hidden_size"]),
                       cfg["classes_size"])
    model.load_state_dict(from_jax_classifier(variables))
    model = model.to(dev).eval()

    @torch.no_grad()
    def fn(img: torch.Tensor):
        img = img.to(dev, torch.float32)
        feats = model(img, feature_only=True)
        return feats, torch.softmax(model.classifier(feats).float(), -1)

    return fn


def classifier_tag(cfg: dict) -> str:
    """The classifier's tag (seed 0), as the reference names it."""
    return "_".join(p for p in ["0", cfg["data_name"], cfg["subset"], "classifier"] if p)


def make_feature_fn(cfg: dict, device=None, verbose: bool = True):
    """The feature model by the order above, on ``device`` (the card
    unless the caller passes ``"cpu"``); ``None`` if there is none."""
    dev = resolve_device(device)
    tag = classifier_tag(cfg)
    ckpt = load_checkpoint(cfg, tag, "best")
    inception_path = os.path.join(cfg["output_dir"], "inception", "inception_v3.pkl")

    def try_inception():
        if os.path.exists(inception_path):
            from .inception import inception_feature_fn

            return inception_feature_fn(inception_path, dev)
        return None

    def try_classifier():
        return classifier_feature_fn(cfg, ckpt["model_dict"], dev) if ckpt is not None else None

    order = ([try_classifier, try_inception] if cfg["data_name"] in ("COIL100", "Omniglot")
             else [try_inception, try_classifier])
    for t in order:
        fn = t()
        if fn is not None:
            return fn
    if verbose:
        print(f"no feature model available for {cfg['data_name']} "
              f"(train a classifier first: tag {tag}); IS/FID will be skipped")
    return None


def extract_real_features(feature_fn, images_u8, batch_size: int = 256) -> torch.Tensor:
    """Features of the real images (FID's real side) as one tensor on the
    feature model's device. ``images_u8``: uint8 NHWC, a tensor (on the
    card, as the loader stages it) or a numpy array; each chunk is
    normalised to [-1, 1] where it lies."""
    images_u8 = torch.as_tensor(images_u8)
    return torch.cat([feature_fn(normalize_images(images_u8[i:i + batch_size]))[0]
                      for i in range(0, len(images_u8), batch_size)])
