"""Per-channel image statistics of a dataset. Port of ``mcgm_tpu/data/stats.py``.

A Welford merge over the packed uint8 array in chunks, in float64, cached
at ``{data_dir}/stats/{name}.pkl``. Either package's cache is read: the
JAX package's ``Stats`` unpickles into this one (the same fields) through
the restricted unpickler of ``io.checkpoint``, which imports nothing of it.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.checkpoint import load_pickle
from ..utils import makedir_exist_ok, save


class Stats:
    """Welford-merge accumulator of per-channel mean and std over NHWC
    images (uint8 scaled to [0, 1]; float taken as it is)."""

    def __init__(self, n_channels: int):
        self.n_channels = n_channels
        self.count = 0
        self.mean = np.zeros(n_channels, np.float64)
        self.m2 = np.zeros(n_channels, np.float64)

    def update(self, img: np.ndarray) -> None:
        """Merge a ``[N, H, W, C]`` chunk."""
        x = np.asarray(img, np.float64) / (255.0 if img.dtype == np.uint8 else 1.0)
        x = x.reshape(-1, x.shape[-1])
        n_b = x.shape[0]
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        delta = mean_b - self.mean
        total = self.count + n_b
        self.mean += delta * (n_b / total)
        self.m2 += m2_b + delta ** 2 * (self.count * n_b / total)
        self.count = total

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.m2 / max(self.count - 1, 1))

    def state(self) -> dict:
        return {"mean": self.mean.tolist(), "std": self.std.tolist(), "count": self.count}


def make_stats(dataset, data_dir: str = "./data", chunk: int = 4096,
               recompute: bool = False) -> Stats:
    """Channel statistics of an ``ArrayDataset``, cached at
    ``{data_dir}/stats/{data_name}.pkl`` (read back unless ``recompute``)."""
    path = os.path.join(data_dir, "stats", f"{dataset.data_name}.pkl")
    if not recompute and os.path.exists(path):
        return load_pickle(path, {(m, "Stats"): Stats for m in ("mcgm_tpu.data.stats", __name__)})
    stats = Stats(dataset.img.shape[-1])
    for i in range(0, len(dataset), chunk):
        stats.update(dataset.img[i:i + chunk])
    makedir_exist_ok(os.path.dirname(path))
    save(stats, path)
    return stats
