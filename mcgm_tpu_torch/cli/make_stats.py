"""Real-data assets for offline scoring (port of ``mcgm_tpu/cli/make_stats.py``):

    python -m mcgm_tpu_torch.cli.make_stats dump --data_name MNIST [--device cpu]
    python -m mcgm_tpu_torch.cli.make_stats stats --data_name MNIST [--device cpu]

- ``dump``: the real train split as ``{output_dir}/npy/generated_0_{data}.npy``,
  float32 NCHW in [0, 255], so the real set can be scored like a generated
  dump;
- ``stats``: FID's real-side Gaussian, ``{output_dir}/fid_stats/fid_stats_{data}_train.npz``
  (``mu``, ``sigma``), from the features of the model ``evals.features``
  resolves (InceptionV3 or the dataset's classifier), extracted on the card
  unless ``--device cpu`` is given; ``cli.test_generated`` then reads it in
  place of a sweep of the train split.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import process_control
from ..data.datasets import fetch_dataset, process_dataset
from ..evals.features import extract_real_features, feature_moments, make_feature_fn
from ..utils import makedir_exist_ok, npy_path, resolve_device, save
from ._common import parse_cfg


def fid_stats_path(cfg: dict) -> str:
    return os.path.join(cfg["output_dir"], "fid_stats", f"fid_stats_{cfg['data_name']}_train.npz")


def dump_real(cfg: dict) -> str:
    """Write the real train split as a dump; returns its path."""
    dataset = fetch_dataset(cfg["data_name"], cfg["subset"], cfg.get("data_dir", "./data"))
    path = npy_path(cfg, f"generated_0_{cfg['data_name']}")
    save(dataset["train"].img.astype(np.float32).transpose(0, 3, 1, 2), path, mode="numpy")
    print(f"dumped {len(dataset['train'])} real images to {path}")
    return path


def make_fid_stats(cfg: dict) -> str:
    """Write the train split's feature mean and covariance (float64);
    returns the file's path."""
    dataset = fetch_dataset(cfg["data_name"], cfg["subset"], cfg.get("data_dir", "./data"))
    cfg = process_dataset(dataset["train"], cfg)
    dev = resolve_device(cfg.get("device"))
    feature_fn = make_feature_fn(cfg, dev)
    if feature_fn is None:
        raise RuntimeError(f"no feature model for {cfg['data_name']}: place InceptionV3 "
                           f"weights or train the classifier first")
    feats = extract_real_features(feature_fn, torch.from_numpy(dataset["train"].img).to(dev),
                                  cfg["batch_size"]["test"])
    mu, sigma = feature_moments(feats)
    out = fid_stats_path(cfg)
    makedir_exist_ok(os.path.dirname(out))
    np.savez(out, mu=mu, sigma=sigma)
    print(f"wrote {out} ({feats.shape[0]} x {feats.shape[1]} features)")
    return out


def main(kind: str, argv=None, **defaults) -> str:
    """``kind`` is ``dump`` or ``stats``; returns the path written."""
    cfg = process_control(parse_cfg(argv, **defaults))
    if kind == "dump":
        return dump_real(cfg)
    if kind == "stats":
        return make_fid_stats(cfg)
    raise SystemExit(f"kind must be 'dump' or 'stats', got {kind!r}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
