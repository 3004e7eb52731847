"""CPU parity of the PyTorch port's dataset packers against the JAX package.

Tiny raw files are made here from ``np.random.default_rng`` (gzipped IDX
for MNIST / FashionMNIST with 28x28 images, EMNIST's ``gzip.zip`` with its
six taxonomies, SVHN ``.mat`` files, COIL100 128x128 RGB PNGs and a PPM,
Omniglot 105x105 1-bit PNGs written by PIL, the CIFAR100 python batches).
Each JAX packer runs on them with ``mcgm_tpu.data.datasets.ensure_raw``
replaced by an extract-only stand-in (the files are not the published
ones, and nothing may download), and the port's packer on a copy of the
same files with its tables' md5s set to None (so its own ``ensure_raw``
checks that each file is in place and unpacks it).

What must agree, and why:

- MNIST, FashionMNIST, EMNIST, SVHN, CIFAR100 (label and superclass):
  ``img``, ``labels`` and ``meta`` bit-equal: the JAX package resizes with
  its native resampler (``native/fastimage.cpp``) and ``data.resize``
  computes its sums operation for operation;
- COIL100, Omniglot: the JAX package resizes each image with PIL, whose
  fixed-point filter rounds between its passes: classes and labels equal,
  pixels within 1 (on these files 10.1 % of COIL100's bytes and 3.7 % of
  Omniglot's differ by 1);
- ``data.resize`` against the JAX package's ``_resize_batch`` (native):
  bit-equal, up- and downscales;
- ``io.images.read_png`` against PIL's ``convert("L")`` / ``convert("RGB")``:
  bit-equal over bit depths 1-8, the five colour types and all five row
  filters; ``read_ppm`` likewise.
"""

import gzip
import io
import os
import shutil
import struct
import tarfile
import zipfile
import zlib

import numpy as np
import pytest
import scipy.io
from PIL import Image

from mcgm_tpu.data import datasets as jdatasets
from mcgm_tpu.data.download import extract_file as jextract
from mcgm_tpu_torch.data import datasets as pdatasets
from mcgm_tpu_torch.data import raw as praw
from mcgm_tpu_torch.data.resize import resize_bilinear_u8
from mcgm_tpu_torch.io import images as pimages


def _idx_images(img: np.ndarray) -> bytes:
    return struct.pack(">iiii", 2051, *img.shape) + img.astype(np.uint8).tobytes()


def _idx_labels(labels: np.ndarray) -> bytes:
    return struct.pack(">ii", 2049, len(labels)) + labels.astype(np.uint8).tobytes()


def _gz(path, data: bytes) -> None:
    with gzip.open(path, "wb") as f:
        f.write(data)


def _write_mnist_like(raw, rng, n=(12, 7)) -> None:
    os.makedirs(raw, exist_ok=True)
    for stem, count in (("train", n[0]), ("t10k", n[1])):
        _gz(os.path.join(raw, f"{stem}-images-idx3-ubyte.gz"),
            _idx_images(rng.integers(0, 256, (count, 28, 28))))
        _gz(os.path.join(raw, f"{stem}-labels-idx1-ubyte.gz"),
            _idx_labels(rng.integers(0, 10, count)))


def _write_emnist(raw, rng) -> None:
    os.makedirs(raw, exist_ok=True)
    classes = {"byclass": 62, "bymerge": 47, "balanced": 47, "letters": 26, "digits": 10,
               "mnist": 10}
    with zipfile.ZipFile(os.path.join(raw, "gzip.zip"), "w") as z:
        for subset, k in classes.items():
            for split, count in (("train", 6), ("test", 4)):
                stem = f"gzip/emnist-{subset}-{split}"
                labels = rng.integers(1 if subset == "letters" else 0,
                                      k + 1 if subset == "letters" else k, count)
                for kind, data in (("images-idx3", _idx_images(
                        rng.integers(0, 256, (count, 28, 28)))),
                                   ("labels-idx1", _idx_labels(labels))):
                    z.writestr(f"{stem}-{kind}-ubyte.gz", gzip.compress(data))


def _write_svhn(raw, rng) -> None:
    os.makedirs(raw, exist_ok=True)
    for split, count in (("train", 9), ("test", 5)):
        scipy.io.savemat(os.path.join(raw, f"{split}_32x32.mat"), {
            "X": rng.integers(0, 256, (32, 32, 3, count)).astype(np.uint8),
            "y": rng.integers(1, 11, (count, 1)).astype(np.uint8)})


def _png_bytes(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _smooth(rng, h, w, c):
    """Images with the structure of photographs, so PIL's adaptive filters
    pick every row filter: a random low-frequency field plus noise."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = sum(rng.uniform(20, 60) * np.sin(2 * np.pi * (rng.uniform(0.3, 2) * xx
                                                       + rng.uniform(0.3, 2) * yy)
                                           + rng.uniform(0, 6))
              for _ in range(3))
    out = out[..., None] + 128 + rng.normal(0, 12, (h, w, c))
    return np.clip(out, 0, 255).astype(np.uint8)


def _write_coil100(raw, rng) -> None:
    os.makedirs(raw, exist_ok=True)
    with zipfile.ZipFile(os.path.join(raw, "coil-100.zip"), "w") as z:
        for obj in (1, 2, 10, 100):
            for view in (0, 5):
                z.writestr(f"coil-100/obj{obj}__{view}.png",
                           _png_bytes(_smooth(rng, 128, 128, 3)))
        buf = io.BytesIO()
        Image.fromarray(_smooth(rng, 128, 128, 3)).save(buf, format="PPM")
        z.writestr("coil-100/obj3__0.ppm", buf.getvalue())
        z.writestr("coil-100/readme.txt", "not an image")


def _write_omniglot(raw, rng) -> None:
    os.makedirs(raw, exist_ok=True)
    for part, alphabets in (("images_background", ("Greek", "Latin")),
                            ("images_evaluation", ("Tengwar",))):
        with zipfile.ZipFile(os.path.join(raw, f"{part}.zip"), "w") as z:
            for a in alphabets:
                for ch in ("character01", "character02"):
                    for k in range(2):
                        strokes = _smooth(rng, 105, 105, 1)[..., 0] > 150
                        z.writestr(f"{part}/{a}/{ch}/{a}_{ch}_{k}.png",
                                   _png_bytes(strokes))


def _write_cifar100(folder, rng) -> None:
    """The layout ``tests/test_data.py`` builds: 100 fine classes in 20
    superclasses, ``coarse(f) = 7 f mod 20``."""
    import pickle

    os.makedirs(folder, exist_ok=True)
    fine_to_coarse = [(f * 7) % 20 for f in range(100)]
    for fn, n in (("train", 200), ("test", 100)):
        fine = (np.arange(n) % 100).tolist()
        entry = {"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                 "fine_labels": fine, "coarse_labels": [fine_to_coarse[f] for f in fine]}
        with open(os.path.join(folder, fn), "wb") as f:
            pickle.dump(entry, f)
    with open(os.path.join(folder, "meta"), "wb") as f:
        pickle.dump({"fine_label_names": [f"c{i:02d}" for i in range(100)],
                     "coarse_label_names": [f"s{i:02d}" for i in range(20)]}, f)


WRITERS = {
    "MNIST": lambda raw, rng: _write_mnist_like(raw, rng),
    "FashionMNIST": lambda raw, rng: _write_mnist_like(raw, rng, (10, 6)),
    "EMNIST": _write_emnist,
    "SVHN": _write_svhn,
    "COIL100": _write_coil100,
    "Omniglot": _write_omniglot,
    "CIFAR100": lambda raw, rng: _write_cifar100(os.path.join(raw, "cifar-100-python"), rng),
}


def _extract_only(files, raw_folder, verbose=True):
    """What ``ensure_raw`` does with files already in place, less the md5
    (CIFAR100's batches are given unpacked, as ``tests/test_data.py`` does)."""
    for url, _ in files:
        path = os.path.join(raw_folder, os.path.basename(url))
        if os.path.exists(path):
            jextract(path)


def _unpublished(monkeypatch) -> None:
    """The port's raw-file tables with no md5s: the test's files stand in
    for the published ones."""
    for attr in dir(pdatasets):
        if attr.startswith("_") and attr.endswith("_FILES"):
            table = getattr(pdatasets, attr)
            monkeypatch.setattr(pdatasets, attr, [(url, None) for url, _ in table])


def _pack_both(tmp_path, monkeypatch, name, seed):
    """Write the raw files once, pack them with each package in a folder of
    its own; return both packages' processed folders."""
    src = tmp_path / "src" / name / "raw"
    WRITERS[name](str(src), np.random.default_rng(seed))
    roots = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg / name
        shutil.copytree(src, root / "raw")
        roots[pkg] = root
    monkeypatch.setattr(jdatasets, "ensure_raw", _extract_only)
    _unpublished(monkeypatch)
    jdatasets._PACKERS[name](str(roots["jax"]), False)
    pdatasets._PACKERS[name](str(roots["port"]))
    return roots["jax"] / "processed", roots["port"] / "processed"


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name,seed", [("MNIST", 0), ("FashionMNIST", 1), ("EMNIST", 2),
                                       ("SVHN", 3), ("CIFAR100", 4)])
def test_packer_bit_equal_to_jax(tmp_path, monkeypatch, name, seed):
    """Every processed file (each EMNIST taxonomy, CIFAR100's label and
    superclass subsets) the same arrays and meta bytes as the JAX package's."""
    jdir, pdir = _pack_both(tmp_path, monkeypatch, name, seed)
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(pdir)) and files
    want_files = {"EMNIST": 12, "CIFAR100": 4}.get(name, 2)
    assert len(files) == want_files
    for fn in files:
        want, got = _npz(jdir / fn), _npz(pdir / fn)
        assert set(got) == set(want) == {"img", "labels", "meta"}
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (fn, k)
    img = _npz(pdir / "train.npz")["img"] if name != "EMNIST" else _npz(
        pdir / "train_letters.npz")["img"]
    assert img.shape[1:3] == (32, 32)
    if name == "EMNIST":
        assert _npz(pdir / "train_letters.npz")["labels"].min() >= 0


@pytest.mark.parametrize("name,seed,channels", [("COIL100", 5, 3), ("Omniglot", 6, 1)])
def test_pil_resized_packer_within_one(tmp_path, monkeypatch, name, seed, channels):
    """Classes and labels equal, pixels within 1 of PIL's resize; the share
    of bytes that differ is small."""
    jdir, pdir = _pack_both(tmp_path, monkeypatch, name, seed)
    for split in ("train", "test"):
        want, got = _npz(jdir / f"{split}.npz"), _npz(pdir / f"{split}.npz")
        assert np.array_equal(got["labels"], want["labels"])
        assert bytes(got["meta"]) == bytes(want["meta"])
        assert got["img"].shape == want["img"].shape
        assert got["img"].shape[1:] == (32, 32, channels)
        diff = np.abs(got["img"].astype(int) - want["img"].astype(int))
        print(f"{name} {split}: {(diff > 0).mean():.1%} of the bytes differ from PIL's, "
              f"by at most {diff.max()}")
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.25, (diff > 0).mean()
    ds = pdatasets.fetch_dataset(name, data_dir=str(pdir.parent.parent), verbose=False)
    assert np.array_equal(ds["train"].img, ds["test"].img)
    if name == "COIL100":  # lexicographic object names, the PPM among them
        assert ds["train"].classes == ["obj1", "obj10", "obj100", "obj2", "obj3"]
    else:
        assert ds["train"].classes[0] == "Greek/character01" and ds["train"].num_classes == 6


@pytest.mark.parametrize("shape,out", [((28, 28, 1), 32), ((20, 20, 3), 32),
                                       ((128, 128, 3), 32), ((105, 105, 1), 32),
                                       ((64, 48, 3), 32), ((32, 32, 3), 17)])
def test_resize_bit_equal_to_jax(shape, out):
    """``data.resize`` against the JAX package's pack-time resize (its
    native resampler) on random bytes: up, down, exact halves, non-square."""
    img = np.random.default_rng(sum(shape) + out).integers(0, 256, (24, *shape), dtype=np.uint8)
    want = jdatasets._resize_batch(img, out)
    got = resize_bilinear_u8(img, out)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(samples, depth, color, palette=None) -> bytes:
    """A PNG of ``samples [H, W * samples_per_pixel]`` at ``depth`` bits,
    row ``y`` filtered with filter ``y % 5``."""
    h = samples.shape[0]
    w = samples.shape[1] // {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    per = 8 // depth if depth < 8 else 1
    if depth < 8:
        padded = np.zeros((h, -(-samples.shape[1] // per) * per), np.int64)
        padded[:, :samples.shape[1]] = samples
        grouped = padded.reshape(h, -1, per)
        rows = sum(grouped[:, :, k] << (8 - depth * (k + 1)) for k in range(per))
    else:
        rows = samples
    rows = rows.astype(np.uint8)
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8)
    out, prev = bytearray(), [0] * rows.shape[1]
    for y in range(h):
        f, cur = y % 5, rows[y].tolist()
        out.append(f)
        for x in range(len(cur)):
            a = cur[x - bpp] if x >= bpp else 0
            b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
            out.append((cur[x] - [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]) & 0xFF)
        prev = cur
    data = pimages._SIGNATURE + pimages._chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        data += pimages._chunk(b"PLTE", palette.tobytes())
    return (data + pimages._chunk(b"IDAT", zlib.compress(bytes(out)))
            + pimages._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth,color", [(1, 0), (2, 0), (4, 0), (8, 0), (8, 2), (8, 4),
                                         (8, 6), (1, 3), (2, 3), (4, 3), (8, 3)])
def test_read_png_matches_pil(tmp_path, depth, color):
    """Every bit depth and colour type, rows through all five filters, an
    odd width (sub-byte rows padded): equal to PIL's decode converted to L
    and to RGB, and the default channels (1 for gray, 3 otherwise)."""
    rng = np.random.default_rng(depth * 10 + color)
    h, w = 11, 13
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    palette = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8) if color == 3 else None
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_encode_png(rng.integers(0, 1 << depth, (h, w * spp)), depth, color, palette))
    im = Image.open(path)
    for mode in ("L", "RGB"):
        want = np.asarray(im.convert(mode))
        want = want[..., None] if want.ndim == 2 else want
        got = pimages.read_png(path, mode)
        assert got.shape == want.shape and np.array_equal(got, want), mode
    assert pimages.read_png(path).shape == (h, w, 1 if color in (0, 4) else 3)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "P"])
def test_read_png_pil_written(tmp_path, mode):
    """Files PIL writes (its own filter choice per row), and a binary PPM."""
    rng = np.random.default_rng(len(mode))
    rgb = _smooth(rng, 40, 37, 3)
    im = Image.fromarray(rgb).convert(mode)
    path = str(tmp_path / "x.png")
    im.save(path)
    for m in ("L", "RGB"):
        want = np.asarray(Image.open(path).convert(m))
        got = pimages.read_png(path, m)
        assert np.array_equal(got.reshape(want.shape), want), m
    Image.fromarray(rgb).save(str(tmp_path / "x.ppm"))
    assert np.array_equal(pimages.read_image(str(tmp_path / "x.ppm")), rgb)
    assert np.array_equal(pimages.read_ppm(str(tmp_path / "x.ppm"), "L")[..., 0],
                          np.asarray(Image.open(str(tmp_path / "x.ppm")).convert("L")))


def test_read_image_refuses_what_it_cannot_decode(tmp_path):
    """Interlaced PNGs and JPEGs raise and name the file."""
    with open(tmp_path / "i.png", "wb") as f:  # an Adam7 header: refused before its data
        f.write(pimages._SIGNATURE + pimages._chunk(
            b"IHDR", struct.pack(">IIBBBBB", 16, 16, 8, 2, 0, 0, 1))
            + pimages._chunk(b"IDAT", b"") + pimages._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="i.png.*interlaced"):
        pimages.read_image(str(tmp_path / "i.png"))
    img = _smooth(np.random.default_rng(7), 16, 16, 3)
    Image.fromarray(img).save(str(tmp_path / "j.jpg"))
    with pytest.raises(ValueError, match="j.jpg"):
        pimages.read_image(str(tmp_path / "j.jpg"))


def test_archive_traversal_refused(tmp_path):
    """A zip member with ``../`` is skipped (the rest unpacked), as the JAX
    package does; a tar member with ``../`` raises (tarfile's data filter)."""
    dest = tmp_path / "raw"
    dest.mkdir()
    with zipfile.ZipFile(dest / "a.zip", "w") as z:
        z.writestr("../evil.txt", "x")
        z.writestr("ok/good.txt", "y")
    praw.extract_file(str(dest / "a.zip"))
    assert (dest / "ok" / "good.txt").exists() and not (tmp_path / "evil.txt").exists()
    with tarfile.open(dest / "b.tar.gz", "w:gz") as t:
        info = tarfile.TarInfo("../evil2.txt")
        info.size = 1
        t.addfile(info, io.BytesIO(b"x"))
    with pytest.raises(tarfile.FilterError):
        praw.extract_file(str(dest / "b.tar.gz"))
    assert not (tmp_path / "evil2.txt").exists()


def test_missing_or_altered_raw_file(tmp_path, monkeypatch):
    """A missing raw file raises naming its path, URL and md5; a file that
    is not the published one raises on its md5, and is packed where the
    table publishes none."""
    url, md5 = pdatasets._MNIST_FILES[0]
    with pytest.raises(FileNotFoundError, match=url) as e:
        pdatasets.fetch_dataset("MNIST", data_dir=str(tmp_path), verbose=False)
    assert md5 in str(e.value) and os.path.join("MNIST", "raw") in str(e.value)
    _write_mnist_like(str(tmp_path / "MNIST" / "raw"), np.random.default_rng(8))
    with pytest.raises(ValueError, match="md5"):
        pdatasets.fetch_dataset("MNIST", data_dir=str(tmp_path), verbose=False)
    _unpublished(monkeypatch)
    ds = pdatasets.fetch_dataset("MNIST", data_dir=str(tmp_path), verbose=False)
    assert ds["train"].img.shape == (12, 32, 32, 1) and ds["test"].num_classes == 10


def test_cifar100_from_archive(tmp_path, monkeypatch):
    """CIFAR100 packed from its archive (the folder not yet unpacked) equals
    the packing of the unpacked folder; the superclass subset has 20
    classes in first-appearance order."""
    rng = np.random.default_rng(9)
    _write_cifar100(str(tmp_path / "src" / "cifar-100-python"), rng)
    raw = tmp_path / "a" / "CIFAR100" / "raw"
    raw.mkdir(parents=True)
    with tarfile.open(raw / "cifar-100-python.tar.gz", "w:gz") as t:
        t.add(tmp_path / "src" / "cifar-100-python", arcname="cifar-100-python")
    shutil.copytree(tmp_path / "src", tmp_path / "b" / "CIFAR100" / "raw")
    _unpublished(monkeypatch)
    got = pdatasets.fetch_dataset("CIFAR100", "superclass", str(tmp_path / "a"), False)
    want = pdatasets.fetch_dataset("CIFAR100", "superclass", str(tmp_path / "b"), False)
    assert np.array_equal(got["train"].img, want["train"].img)
    assert np.array_equal(got["train"].labels, want["train"].labels)
    assert got["train"].classes[:3] == ["s00", "s07", "s14"] and got["train"].num_classes == 20
