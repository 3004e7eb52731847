"""Batches served from the card. Port of ``mcgm_tpu/data/loader.py``
(single-device path).

The packed uint8 images and their labels are copied to the device once
(CIFAR10's train split is 150 MB); each epoch's order goes over once as one
index vector, and every batch is a gather plus normalisation to [-1, 1] on
the device. Per step the host copies nothing. The order is a pure function
of ``(seed, epoch)`` through ``np.random.default_rng([seed, epoch])``, so
the port draws the same batches as the JAX package and a resumed epoch
replays what an uninterrupted one would have.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def normalize_images(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]: ``x / 127.5 - 1`` as one fused
    multiply-add by the f32 reciprocal, as XLA compiles the JAX loader's, so
    the batches are equal bit for bit."""
    x = img.float()
    return torch.addcmul(x.new_tensor(-1.0), x, x.new_tensor(1 / 127.5))


class DataLoader:
    """Epoch-deterministic batches over an ``ArrayDataset``, on ``device``.

    Yields ``{'img': f32 [-1, 1] NHWC, 'label': int64, 'n': int}``, and with
    ``pad_to_batch`` a ``'w'`` mask that is 0 on the rows that pad the last
    batch (taken from the head of the epoch). ``drop_last`` drops a final
    partial batch instead. Each completed iteration advances the epoch;
    ``set_epoch`` pins it, as the train loop does.
    """

    def __init__(self, dataset, batch_size: int, device, shuffle: bool = False,
                 seed: int = 0, pad_to_batch: bool = False, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.pad_to_batch = pad_to_batch
        self.drop_last = drop_last
        self.epoch = 0
        self._dev = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng([self.seed, self.epoch]).permutation(n)

    def staged(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The uint8 images and int64 labels on the device (copied once)."""
        if self._dev is None:
            self._dev = (torch.from_numpy(self.dataset.img).to(self.device),
                         torch.from_numpy(self.dataset.labels.astype(np.int64)).to(self.device))
        return self._dev

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_batch: int):
        """The epoch from batch ``start_batch`` on; the skipped batches are
        never gathered (mid-epoch resume)."""
        order = self._order()
        self.epoch += 1
        n, bs = len(order), self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        starts = range(start_batch * bs, stop, bs)
        if not starts:
            return
        true_n = [min(bs, stop - s) for s in starts]
        if self.pad_to_batch and true_n[-1] < bs:
            order = np.concatenate([order, np.take(order, np.arange(bs - true_n[-1]),
                                                   mode="wrap")])
        img_u8, labels = self.staged()
        idx = torch.from_numpy(order).to(self.device)  # one copy per epoch
        for s, k in zip(starts, true_n):
            rows = idx[s:s + (bs if self.pad_to_batch else k)]
            out = {"img": normalize_images(img_u8.index_select(0, rows)),
                   "label": labels.index_select(0, rows), "n": k}
            if self.pad_to_batch:
                out["w"] = (torch.arange(len(rows), device=self.device) < k).float()
            yield out


def make_data_loader(dataset: dict, cfg: dict, device, seed: int = 0) -> dict:
    """One loader per split on ``device``: train shuffles, the others do not."""
    return {k: DataLoader(ds, cfg["batch_size"][k], device, shuffle=k == "train", seed=seed)
            for k, ds in dataset.items()}
