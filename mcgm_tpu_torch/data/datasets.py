"""Datasets as packed arrays. Port of ``mcgm_tpu/data/datasets.py``.

Every dataset is a contiguous uint8 NHWC array at its training resolution
with int32 labels, kept as ``{data_dir}/{name}/processed/{split}.npz``
(``img``, ``labels``, and ``meta``: JSON with the class names, as uint8
bytes). That file is the repo's format for custom data too, and both
packages read and write the same files. Packing happens once, from the raw
files the user has placed under ``{data_dir}/{name}/raw/`` with the names
of their public URLs (nothing is downloaded; ``data.raw.ensure_raw``
checks and unpacks them, and a missing file's error names its URL and
md5). The packers, each writing what the JAX package writes from the same
files:

- MNIST / FashionMNIST: gzipped IDX files, 10 classes, resized 28 -> 32
  (``data.resize``, the JAX package's native resampler, byte for byte);
- EMNIST: ``gzip.zip``, all six taxonomies (``subset``), images
  transposed, ``letters`` shifted to 0..25;
- CIFAR10 / CIFAR100: the python batches (the archive, or its folder
  already unpacked), label order as shipped; CIFAR100 also the
  20-superclass subset (``subset="superclass"``), its fine classes in the
  meta's ``tree``;
- SVHN: the cropped-digit ``.mat`` files, label 10 -> 0;
- COIL100: 100 objects x 72 views, 128 -> 32, classes the lexicographic
  ``obj*`` names, train == test;
- Omniglot: both alphabet sets, class ``alphabet/character``, 105 -> 32,
  train == test.

COIL100's and Omniglot's images are decoded by ``io.images`` (PNG, binary
PPM; no JPEG) and resized by ``data.resize``, where the JAX package uses
PIL (whose fixed-point resampler rounds between its two passes): pixels
agree within 1. ``Synthetic[K]`` / ``SyntheticGray[K]`` are seeded
class-blob images made in memory, the same arrays the JAX package makes.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import struct

import numpy as np

from ..io.images import read_image
from .raw import ensure_raw, extract_file
from .resize import resize_bilinear_u8

_RES = 32  # every reference benchmark runs at 32x32
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


# ------------------------------------------------------- raw-format readers
def read_idx(path: str) -> np.ndarray:
    """An IDX (MNIST family) file: images ``[N, rows, cols]`` uint8 (magic
    2051) or labels ``[N]`` int64 (2049)."""
    with open(path, "rb") as f:
        data = f.read()
    (magic,) = struct.unpack(">i", data[:4])
    if magic == 2051:
        n, rows, cols = struct.unpack(">iii", data[4:16])
        return np.frombuffer(data, np.uint8, count=n * rows * cols, offset=16).reshape(
            n, rows, cols)
    if magic == 2049:
        (n,) = struct.unpack(">i", data[4:8])
        return np.frombuffer(data, np.uint8, count=n, offset=8).astype(np.int64)
    raise ValueError(f"not an IDX file: {path} (magic {magic})")


def _resize_batch(img: np.ndarray, res: int = _RES) -> np.ndarray:
    """uint8 ``[N, H, W(, C)]`` as ``[N, res, res, C]``: resized by
    ``data.resize`` unless it is at ``res`` already."""
    if img.ndim == 3:
        img = img[..., None]
    if img.shape[1] == res and img.shape[2] == res:
        return np.ascontiguousarray(img)
    return resize_bilinear_u8(img, res)


def _read_resized(paths: list[str], mode: str, res: int = _RES) -> np.ndarray:
    """Decode each image file as ``mode`` and resize all of one size
    together: uint8 ``[len(paths), res, res, C]`` in the order of ``paths``."""
    images = [read_image(p, mode) for p in paths]
    out = np.empty((len(images), res, res, 3 if mode == "RGB" else 1), np.uint8)
    by_shape: dict = {}
    for i, im in enumerate(images):
        by_shape.setdefault(im.shape, []).append(i)
    for idx in by_shape.values():
        out[idx] = _resize_batch(np.stack([images[i] for i in idx]), res)
    return out


# ---------------------------------------------------------------- packers
# (url, md5) of each dataset's raw files: the JAX package's tables
_MNIST_FILES = [
    ("https://ossci-datasets.s3.amazonaws.com/mnist/train-images-idx3-ubyte.gz",
     "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
    ("https://ossci-datasets.s3.amazonaws.com/mnist/t10k-images-idx3-ubyte.gz",
     "9fb629c4189551a2d022fa330f9573f3"),
    ("https://ossci-datasets.s3.amazonaws.com/mnist/train-labels-idx1-ubyte.gz",
     "d53e105ee54ea40749a09fcbcd1e9432"),
    ("https://ossci-datasets.s3.amazonaws.com/mnist/t10k-labels-idx1-ubyte.gz",
     "ec29112dd5afa0611ce80d1b7f02629c"),
]
_FASHION_FILES = [
    ("http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/"
     "train-images-idx3-ubyte.gz", "8d4fb7e6c68d591d4c3dfef9ec88bf0d"),
    ("http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/"
     "t10k-images-idx3-ubyte.gz", "bef4ecab320f06d8554ea6380940ec79"),
    ("http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/"
     "train-labels-idx1-ubyte.gz", "25c81989df183df01b3e8a0aad5dffbe"),
    ("http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/"
     "t10k-labels-idx1-ubyte.gz", "bb300cfdad3c16e7a12a480ee83cd310"),
]
_EMNIST_FILES = [("http://www.itl.nist.gov/iaui/vip/cs_links/EMNIST/gzip.zip",
                  "58c8d27c78d21e728a6bc7b3cc06412e")]
_CIFAR10_FILES = [("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
                   "c58f30108f718f92721af3b95e74349a")]
_CIFAR100_FILES = [("https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
                    "eb9058c3a382ffc7106e4002c42a8d85")]
_SVHN_FILES = [("http://ufldl.stanford.edu/housenumbers/train_32x32.mat",
                "e26dedcc434d2e4c54c9b2d4a06d8373"),
               ("http://ufldl.stanford.edu/housenumbers/test_32x32.mat",
                "eb5a983be6a315427106f1b164d9cef3")]
_COIL100_FILES = [("http://www.cs.columbia.edu/CAVE/databases/"
                   "SLAM_coil-20_coil-100/coil-100/coil-100.zip", None)]
_OMNIGLOT_FILES = [
    ("https://github.com/brendenlake/omniglot/raw/master/python/images_background.zip",
     "68d2efa1b9178cc56df9314c21c6e718"),
    ("https://github.com/brendenlake/omniglot/raw/master/python/images_evaluation.zip",
     "6b91aef0f799c5bb55b94e3f2daec811"),
]

_FASHION_CLASSES = ["T-shirt_top", "Trouser", "Pullover", "Dress", "Coat", "Sandal", "Shirt",
                    "Sneaker", "Bag", "Ankle boot"]
EMNIST_SUBSETS = ["byclass", "bymerge", "balanced", "letters", "digits", "mnist"]
_UPPER = [chr(c) for c in range(ord("A"), ord("Z") + 1)]
_LOWER = [chr(c) for c in range(ord("a"), ord("z") + 1)]
_MERGED = ["c", "i", "j", "k", "l", "m", "o", "p", "s", "u", "v", "w", "x", "y", "z"]
_UNMERGED = [c for c in _LOWER if c not in _MERGED]
# class names per taxonomy; 'letters' is the 26 case-merged letters, its
# labels shifted from 1..26 to 0..25
EMNIST_CLASSES = {
    "byclass": _DIGITS + _UPPER + _LOWER,
    "bymerge": _DIGITS + _UPPER + _UNMERGED,
    "balanced": _DIGITS + _UPPER + _UNMERGED,
    "letters": _UPPER,
    "digits": _DIGITS,
    "mnist": _DIGITS,
}


def _pack_mnist_like(root: str, files, classes) -> None:
    raw = os.path.join(root, "raw")
    ensure_raw(files, raw)
    for split, stem in (("train", "train"), ("test", "t10k")):
        img = read_idx(os.path.join(raw, f"{stem}-images-idx3-ubyte"))
        labels = read_idx(os.path.join(raw, f"{stem}-labels-idx1-ubyte"))
        _save_processed(root, split, "label", _resize_batch(img), labels, classes)


def _pack_emnist(root: str) -> None:
    raw = os.path.join(root, "raw")
    ensure_raw(_EMNIST_FILES, raw)
    gzip_folder = os.path.join(raw, "gzip")
    for f in os.listdir(gzip_folder):
        if f.endswith(".gz"):
            extract_file(os.path.join(gzip_folder, f))
    for subset in EMNIST_SUBSETS:
        for split in ("train", "test"):
            stem = os.path.join(gzip_folder, f"emnist-{subset}-{split}")
            # EMNIST ships its images transposed
            img = np.transpose(read_idx(f"{stem}-images-idx3-ubyte"), (0, 2, 1))
            labels = read_idx(f"{stem}-labels-idx1-ubyte")
            if subset == "letters":
                labels = labels - 1
            _save_processed(root, split, subset, _resize_batch(img), labels,
                            EMNIST_CLASSES[subset])


def _pack_cifar(root: str, name: str) -> None:
    """The python batches under ``root/raw`` (the archive, or the folder it
    unpacks to) as ``processed/{train,test}.npz``; CIFAR100 also as
    ``{train,test}_superclass.npz``."""
    raw = os.path.join(root, "raw")
    if name == "CIFAR10":
        folder = os.path.join(raw, "cifar-10-batches-py")
        files, meta_file, meta_key = _CIFAR10_FILES, "batches.meta", "label_names"
        split_files = {"train": [f"data_batch_{i}" for i in range(1, 6)],
                       "test": ["test_batch"]}
    else:
        folder = os.path.join(raw, "cifar-100-python")
        files, meta_file, meta_key = _CIFAR100_FILES, "meta", "fine_label_names"
        split_files = {"train": ["train"], "test": ["test"]}
    if not os.path.isdir(folder):
        ensure_raw(files, raw, unpacked=folder)
    with open(os.path.join(folder, meta_file), "rb") as f:
        meta = pickle.load(f, encoding="latin1")
    classes = meta[meta_key]
    for split, names in split_files.items():
        img, labels, coarse = [], [], []
        for fn in names:
            with open(os.path.join(folder, fn), "rb") as f:
                entry = pickle.load(f, encoding="latin1")
            img.append(entry["data"])
            labels.extend(entry.get("labels", entry.get("fine_labels")))
            coarse.extend(entry.get("coarse_labels", []))
        img = np.ascontiguousarray(np.vstack(img).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        _save_processed(root, split, "label", img, labels, classes)
        if name == "CIFAR100":
            _save_cifar100_superclass(root, split, img, labels, coarse, classes,
                                      meta["coarse_label_names"])


def _save_cifar100_superclass(root, split, img, fine_labels, coarse, classes,
                              coarse_names) -> None:
    """The 20-superclass subset: a superclass's index is its first
    appearance over the (alphabetical) fine classes, as the reference's
    class tree inserts them; the meta's ``tree`` holds ``[superclass,
    fine]`` per fine class."""
    fine_labels, coarse = np.asarray(fine_labels), np.asarray(coarse)
    fine_to_coarse = np.full(len(classes), -1, np.int64)
    fine_to_coarse[fine_labels] = coarse  # constant per fine class
    if (fine_to_coarse < 0).any():
        raise ValueError(f"CIFAR100 {split}: not every fine class appears")
    order, remap = [], {}
    for f in range(len(classes)):
        c = int(fine_to_coarse[f])
        if c not in remap:
            remap[c] = len(order)
            order.append(c)
    lut = np.zeros(len(coarse_names), np.int64)
    lut[list(remap)] = list(remap.values())
    tree = [[coarse_names[int(fine_to_coarse[f])], classes[f]] for f in range(len(classes))]
    _save_processed(root, split, "superclass", img, lut[fine_to_coarse[fine_labels]],
                    [coarse_names[c] for c in order], extra_meta={"tree": tree})


def _pack_svhn(root: str) -> None:
    from scipy.io import loadmat

    raw = os.path.join(root, "raw")
    ensure_raw(_SVHN_FILES, raw)
    for split in ("train", "test"):
        mat = loadmat(os.path.join(raw, f"{split}_32x32.mat"))
        img = np.ascontiguousarray(np.transpose(mat["X"], (3, 0, 1, 2)))  # HWCN -> NHWC
        _save_processed(root, split, "label", img, mat["y"].ravel().astype(np.int64) % 10,
                        _DIGITS)


def _pack_coil100(root: str) -> None:
    raw = os.path.join(root, "raw")
    ensure_raw(_COIL100_FILES, raw)
    folder = os.path.join(raw, "coil-100")
    files = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith((".png", ".ppm", ".jpg", ".jpeg")))
    classes = sorted({f.split("_")[0] for f in files})  # obj1, obj10, obj100, obj11, ...
    cls_idx = {c: i for i, c in enumerate(classes)}
    img = _read_resized([os.path.join(folder, f) for f in files], "RGB")
    labels = np.array([cls_idx[f.split("_")[0]] for f in files], np.int64)
    for split in ("train", "test"):  # the same split twice, as the reference
        _save_processed(root, split, "label", img, labels, classes)


def _pack_omniglot(root: str) -> None:
    raw = os.path.join(root, "raw")
    ensure_raw(_OMNIGLOT_FILES, raw)
    paths = []
    for dirpath, _, files in sorted(os.walk(raw)):
        paths.extend(os.path.join(dirpath, f) for f in sorted(files) if f.lower().endswith(".png"))

    def key(p):  # alphabet/character
        return "/".join(os.path.normpath(p).split(os.path.sep)[-3:-1])

    classes = sorted({key(p) for p in paths})
    cls_idx = {c: i for i, c in enumerate(classes)}
    img = _read_resized(paths, "L")
    labels = np.array([cls_idx[key(p)] for p in paths], np.int64)
    for split in ("train", "test"):  # all alphabets in both, as the reference
        _save_processed(root, split, "label", img, labels, classes)


_PACKERS = {
    "MNIST": lambda root: _pack_mnist_like(root, _MNIST_FILES, _DIGITS),
    "FashionMNIST": lambda root: _pack_mnist_like(root, _FASHION_FILES, _FASHION_CLASSES),
    "EMNIST": _pack_emnist,
    "CIFAR10": lambda root: _pack_cifar(root, "CIFAR10"),
    "CIFAR100": lambda root: _pack_cifar(root, "CIFAR100"),
    "SVHN": _pack_svhn,
    "COIL100": _pack_coil100,
    "Omniglot": _pack_omniglot,
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
    made in memory, anything else read from ``{data_dir}/{data_name}/processed``,
    packed there first from the raw files if it is not (``subset``: the
    EMNIST taxonomy, or CIFAR100's ``superclass``)."""
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
