"""Datasets as packed arrays. Port of ``mcgm_tpu/data/datasets.py``.

Every dataset is a contiguous uint8 NHWC array at its training resolution
with int32 labels, kept as ``{data_dir}/{name}/processed/{split}.npz``
(``img``, ``labels``, and ``meta``: JSON with the class names, as uint8
bytes). That file is the repo's format for custom data too, and both
packages read and write the same files. What is ported:

- the processed-file cache (read, write);
- CIFAR10 / CIFAR100 packed from the python batches already unpacked under
  ``{data_dir}/{name}/raw/`` (nothing is downloaded: a missing folder raises
  and names it);
- ``Synthetic[K]`` / ``SyntheticGray[K]``: seeded class-blob images made in
  memory, the same arrays the JAX package makes.

The other datasets' packers (MNIST family, SVHN, COIL100, Omniglot) are
still to port (ROADMAP Queue A).
"""

from __future__ import annotations

import json
import os
import pickle
import re

import numpy as np

_RES = 32
_DIGITS = [str(i) for i in range(10)]


class ArrayDataset:
    """A split: packed uint8 NHWC images, int32 labels and the taxonomy."""

    def __init__(self, img: np.ndarray, labels: np.ndarray, num_classes: int,
                 classes: list[str] | None = None, data_name: str = ""):
        if img.ndim != 4 or img.dtype != np.uint8:
            raise ValueError(f"images must be uint8 NHWC, got {img.dtype} {img.shape}")
        self.img = img
        self.labels = np.asarray(labels, np.int32)
        self.num_classes = int(num_classes)
        self.classes = classes
        self.data_name = data_name

    def __len__(self) -> int:
        return len(self.img)

    def __repr__(self):
        return (f"ArrayDataset({self.data_name}, n={len(self)}, "
                f"shape={tuple(self.img.shape[1:])}, classes={self.num_classes})")


def process_dataset(dataset: ArrayDataset, cfg: dict) -> dict:
    """``cfg`` with the split's ``classes_size`` and ``data_shape``."""
    cfg = dict(cfg)
    cfg["classes_size"] = dataset.num_classes
    cfg["data_shape"] = list(dataset.img.shape[1:])
    return cfg


# ------------------------------------------------------------ cache layer
def _processed_path(root: str, split: str, subset: str) -> str:
    tag = split if subset in ("", "label") else f"{split}_{subset}"
    return os.path.join(root, "processed", f"{tag}.npz")


def _save_processed(root: str, split: str, subset: str, img, labels, classes,
                    extra_meta: dict | None = None) -> None:
    os.makedirs(os.path.join(root, "processed"), exist_ok=True)
    meta = json.dumps({"classes": classes, **(extra_meta or {})})
    np.savez_compressed(_processed_path(root, split, subset), img=img,
                        labels=np.asarray(labels, np.int32),
                        meta=np.frombuffer(meta.encode(), np.uint8))


def _load_processed(root: str, split: str, subset: str,
                    data_name: str) -> ArrayDataset | None:
    path = _processed_path(root, split, subset)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        img, labels = z["img"], z["labels"]
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z else {}
    classes = meta.get("classes")
    n_cls = len(classes) if classes else int(labels.max()) + 1
    return ArrayDataset(img, labels, n_cls, classes, data_name)


# ---------------------------------------------------------------- packers
def _pack_cifar(root: str, name: str) -> None:
    """Pack the CIFAR python batches under ``root/raw`` into
    ``processed/{train,test}.npz`` (label order as shipped). The CIFAR100
    superclass subset is not ported yet."""
    raw = os.path.join(root, "raw")
    if name == "CIFAR10":
        folder = os.path.join(raw, "cifar-10-batches-py")
        split_files = {"train": [f"data_batch_{i}" for i in range(1, 6)],
                       "test": ["test_batch"]}
        meta_file, meta_key = "batches.meta", "label_names"
    else:
        folder = os.path.join(raw, "cifar-100-python")
        split_files = {"train": ["train"], "test": ["test"]}
        meta_file, meta_key = "meta", "fine_label_names"
    if not os.path.isdir(folder):
        raise FileNotFoundError(
            f"{name}: no processed/{{train,test}}.npz under {root} and no raw batches in "
            f"{folder}; this package downloads nothing: unpack the python batches there")
    with open(os.path.join(folder, meta_file), "rb") as f:
        classes = pickle.load(f, encoding="latin1")[meta_key]
    for split, files in split_files.items():
        img, labels = [], []
        for fn in files:
            with open(os.path.join(folder, fn), "rb") as f:
                entry = pickle.load(f, encoding="latin1")
            img.append(entry["data"])
            labels.extend(entry.get("labels", entry.get("fine_labels")))
        img = np.vstack(img).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        _save_processed(root, split, "label", np.ascontiguousarray(img), labels, classes)


_PACKERS = {
    "CIFAR10": lambda root: _pack_cifar(root, "CIFAR10"),
    "CIFAR100": lambda root: _pack_cifar(root, "CIFAR100"),
}


# ------------------------------------------------------------- synthetic
def _make_synthetic(channels: int, n_train: int = 1024, n_test: int = 512,
                    num_classes: int = 10):
    """Class-separable blob images (class-keyed base pattern plus noise),
    ``[(train_img, train_labels), (test_img, test_labels)]``: the JAX
    package's draw, value for value. Up to 10 classes sit on a fixed grid;
    more draw each class's blob and wave from a second seeded generator and
    are balanced and shuffled."""
    rng = np.random.default_rng(20260816)
    yy, xx = np.mgrid[0:_RES, 0:_RES].astype(np.float32) / (_RES - 1)
    if num_classes <= 10:
        bases = []
        for c in range(num_classes):
            cx, cy = 0.15 + 0.7 * (c % 5) / 4, 0.25 + 0.5 * (c // 5)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
            wave = 0.5 + 0.5 * np.sin(2 * np.pi * (xx * (1 + c % 3) + yy * (1 + c // 3)))
            bases.append(np.stack([blob, wave, 0.5 * blob + 0.5 * wave][:channels], -1))
        bases = np.stack(bases)  # [K,H,W,C]
    else:
        prng = np.random.default_rng(915_20260816)
        K = num_classes

        def per_class(draw):
            return draw.astype(np.float32)[:, None, None]

        cx = per_class(prng.uniform(0.12, 0.88, K))
        cy = per_class(prng.uniform(0.12, 0.88, K))
        wdt = per_class(prng.uniform(0.008, 0.04, K))
        fx = per_class(prng.integers(1, 5, K))
        fy = per_class(prng.integers(1, 5, K))
        ph = per_class(prng.uniform(0, 2 * np.pi, K))
        blob = np.exp(-(((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2) / wdt))
        wave = 0.5 + 0.5 * np.sin(2 * np.pi * (xx[None] * fx + yy[None] * fy) + ph)
        bases = np.stack([blob, wave, 0.5 * blob + 0.5 * wave][:channels],
                         -1).astype(np.float32)
    out = []
    for n in (n_train, n_test):
        if num_classes > 10:
            labels = rng.permutation(np.arange(n) % num_classes)
        else:
            labels = rng.integers(0, num_classes, n)
        noise = rng.normal(0, 0.08, (n, _RES, _RES, channels))
        img = np.clip(bases[labels] + noise, 0, 1)
        out.append((np.round(img * 255).astype(np.uint8), labels.astype(np.int32)))
    return out


def fetch_dataset(data_name: str, subset: str = "label", data_dir: str = "./data",
                  verbose: bool = True) -> dict[str, ArrayDataset]:
    """``{'train': ArrayDataset, 'test': ArrayDataset}``: ``Synthetic[K]``
    made in memory, anything else read from ``{data_dir}/{data_name}/processed``
    (packed there first from the raw files where a packer is ported)."""
    if verbose:
        print(f"fetching data {data_name}...")
    m = re.fullmatch(r"(Synthetic|SyntheticGray)(\d+)?", data_name)
    if m:
        channels = 1 if m.group(1) == "SyntheticGray" else 3
        K = int(m.group(2)) if m.group(2) else 10
        (tr_img, tr_lab), (te_img, te_lab) = _make_synthetic(
            channels, max(1024, 8 * K), max(512, K), K)
        classes = _DIGITS if K == 10 else [str(i) for i in range(K)]
        return {"train": ArrayDataset(tr_img, tr_lab, K, classes, data_name),
                "test": ArrayDataset(te_img, te_lab, K, classes, data_name)}
    root = os.path.join(data_dir, data_name)
    sub = subset if data_name in ("EMNIST", "CIFAR100") else "label"
    dataset = {}
    for split in ("train", "test"):
        ds = _load_processed(root, split, sub, data_name)
        if ds is None:
            if data_name not in _PACKERS:
                raise ValueError(
                    f"no processed/{split}.npz (img uint8 NHWC, labels, meta) under {root}/, "
                    f"and {data_name!r} has no packer in this package")
            _PACKERS[data_name](root)
            ds = _load_processed(root, split, sub, data_name)
        dataset[split] = ds
    if verbose:
        print("data ready")
    return dataset
