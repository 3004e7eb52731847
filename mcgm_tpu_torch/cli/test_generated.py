"""Score the dumps of ``cli.sample ... --save_npy true`` (port of
``mcgm_tpu/cli/test_generated.py``):

    python -m mcgm_tpu_torch.cli.test_generated generated --data_name MNIST \
        --model_name mcgan --control_name 0.5 [--raw true] [--device cpu]
    python -m mcgm_tpu_torch.cli.test_generated created --data_name MNIST \
        --model_name mcgan --control_name 0.5

- ``generated``: IS (10 splits unless ``--is_splits``) and FID of
  ``{output_dir}/npy/generated_{tag}.npy`` ([0, 255] NCHW; rows holding a
  NaN are dropped), with the features of the model ``evals.features``
  resolves, on the card unless ``--device cpu`` is given. FID's real side is
  ``cli.make_stats``'s ``fid_stats_{data}_train.npz`` where it exists, else a
  sweep of the train split. ``--raw true`` scores the real train split in
  place of a dump. Writes ``is_generated_{tag}.npy`` / ``fid_generated_{tag}.npy``
  under ``{output_dir}/result/``.
- ``created``: DBI of ``created_{tag}.npy`` on its pixels, labelled by the
  class sweep (``arange(classes_size)`` tiled ``generate_per_mode`` times)
  with the NaN rows dropped; writes ``dbi_created_{tag}.npy``.

``main`` returns each seed's scores.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import make_model_tag, process_control
from ..data.datasets import fetch_dataset, process_dataset
from ..evals.features import extract_real_features, feature_moments, make_feature_fn
from ..evals.metrics import Metric, dbi
from ..train.loop import apply_family_overrides
from ..utils import npy_path, resolve_device, result_path, save
from ._common import parse_cfg
from .make_stats import fid_stats_path


def _load_images(path: str) -> tuple[np.ndarray, np.ndarray]:
    """A dump ``[N, C, H, W]`` in [0, 255] as NHWC in [-1, 1] without the
    rows that hold a NaN, and the mask of the rows kept."""
    arr = np.load(path, allow_pickle=True).astype(np.float32).transpose(0, 2, 3, 1)
    arr = arr / 255.0 * 2.0 - 1.0
    valid = ~np.isnan(arr.reshape(len(arr), -1)).any(axis=1)
    return arr[valid], valid


def score_generated(cfg: dict, tag: str, kind: str = "generated") -> dict:
    """IS and FID of ``{kind}_{tag}.npy`` (or of the train split, with
    ``cfg['raw']``); returns ``{"InceptionScore", "FID", "images"}``."""
    dataset = fetch_dataset(cfg["data_name"], cfg["subset"], cfg.get("data_dir", "./data"),
                            verbose=False)
    cfg = process_dataset(dataset["train"], cfg)
    dev = resolve_device(cfg.get("device"))
    if cfg.get("raw"):
        img = dataset["train"].img.astype(np.float32) / 127.5 - 1.0
    else:
        img, _ = _load_images(npy_path(cfg, f"{kind}_{tag}"))
    feature_fn = make_feature_fn(cfg, dev)
    if feature_fn is None:
        raise RuntimeError(f"no feature model for {cfg['data_name']}: place InceptionV3 "
                           f"weights or train the classifier first")
    stats_path = fid_stats_path(cfg)
    if os.path.exists(stats_path):
        with np.load(stats_path) as z:
            real_stats = (z["mu"], z["sigma"])
    else:
        real_stats = feature_moments(extract_real_features(
            feature_fn, torch.from_numpy(dataset["train"].img).to(dev), cfg["batch_size"]["test"]))
    metric = Metric(cfg, feature_fn, real_stats=real_stats)
    ev = metric.evaluate(["InceptionScore", "FID"], {}, {"img": torch.from_numpy(img).to(dev)})
    save(np.float64(ev["InceptionScore"]), result_path(cfg, f"is_{kind}_{tag}"), mode="numpy")
    save(np.float64(ev["FID"]), result_path(cfg, f"fid_{kind}_{tag}"), mode="numpy")
    print(f"{tag}: IS={ev['InceptionScore']:.4f} FID={ev['FID']:.4f} ({len(img)} images)")
    return dict(ev, images=len(img))


def score_created(cfg: dict, tag: str) -> dict:
    """DBI of ``created_{tag}.npy``; returns ``{"DBI", "images"}``."""
    dataset = fetch_dataset(cfg["data_name"], cfg["subset"], cfg.get("data_dir", "./data"),
                            verbose=False)
    cfg = process_dataset(dataset["train"], cfg)
    img, valid = _load_images(npy_path(cfg, f"created_{tag}"))
    labels = np.tile(np.arange(cfg["classes_size"]), cfg["generate_per_mode"])[valid]
    value = dbi(img, labels)
    save(np.float64(value), result_path(cfg, f"dbi_created_{tag}"), mode="numpy")
    print(f"{tag}: DBI={value:.4f} ({len(img)} images)")
    return {"DBI": value, "images": len(img)}


def main(kind: str, argv=None, **defaults) -> list[dict]:
    """Score ``kind`` (``generated`` or ``created``) for each seed."""
    if kind not in ("generated", "created"):
        raise SystemExit(f"kind must be 'generated' or 'created', got {kind!r}")
    defaults.setdefault("is_splits", 10)  # the standalone scorer's convention
    cfg = apply_family_overrides(process_control(parse_cfg(argv, **defaults)))
    out = []
    for i in range(int(cfg.get("num_experiments", 1))):
        tag = make_model_tag(cfg, cfg["init_seed"] + i)
        print(f"Experiment: {tag}")
        out.append(score_created(dict(cfg), tag) if kind == "created"
                   else score_generated(dict(cfg), tag))
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
