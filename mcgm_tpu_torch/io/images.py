"""Image grids as PNG files. Port of ``mcgm_tpu/io/images.py``
(``to_uint8``, ``make_grid``, ``save_image_grid``).

The JAX package writes with PIL; the port writes the PNG itself with
``zlib`` and ``struct``: 8-bit grayscale for one channel, 8-bit RGB for
three, every row with filter 0. :func:`read_png` decodes such files (and
any 8-bit grayscale or RGB PNG without interlacing), so a caller can check
what was written without PIL.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..utils import makedir_exist_ok

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type (gray, RGB)


def to_uint8(img: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    """NHWC float in ``value_range`` -> uint8 [0, 255]."""
    lo, hi = value_range
    img = (np.asarray(img, np.float32) - lo) / (hi - lo)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def make_grid(img: np.ndarray, nrow: int = 10, padding: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """Tile ``[N, H, W, C]`` uint8 images, ``nrow`` per grid row, with
    ``padding`` pixels of ``pad_value`` around each (torchvision's layout)."""
    n, h, w, c = img.shape
    rows = (n + nrow - 1) // nrow
    grid = np.full((rows * (h + padding) + padding, nrow * (w + padding) + padding, c),
                   pad_value, np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = r * (h + padding) + padding, col * (w + padding) + padding
        grid[y:y + h, x:x + w] = img[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """``img``: uint8 ``[H, W]`` or ``[H, W, C]`` with C 1 or 3."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1 or 3 channels, got {c}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    data = (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def read_png(path: str) -> np.ndarray:
    """The uint8 ``[H, W, C]`` pixels of an 8-bit, non-interlaced grayscale
    or RGB PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray or RGB is read")
    bpp, stride = channels, w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].copy()
        if kind == 2:
            line += prev
        elif kind in (1, 3, 4):  # these read the bytes decoded just before
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                up_left = up[x - bpp] if x >= bpp else 0
                pred = (left if kind == 1 else (left + up[x]) // 2 if kind == 3
                        else _paeth(left, up[x], up_left))
                cur[x] = (cur[x] + pred) & 0xFF
            line = np.array(cur, np.uint8)
        elif kind != 0:
            raise ValueError(f"{path}: unknown filter {kind} in row {y}")
        out[y] = prev = line
    return out.reshape(h, w, channels)


def save_image_grid(img, path: str, nrow: int = 10, padding: int = 2,
                    pad_value: int = 0, value_range=(-1.0, 1.0)) -> None:
    """NHWC images in ``value_range`` as one PNG grid, ``nrow`` per row."""
    makedir_exist_ok(os.path.dirname(path) or ".")
    grid = make_grid(to_uint8(np.asarray(img), value_range), nrow, padding, pad_value)
    write_png(path, grid)
