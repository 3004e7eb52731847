"""Image grids as PNG files. Port of ``mcgm_tpu/io/images.py``
(``to_uint8``, ``make_grid``, ``save_image_grid``).

The JAX package writes with PIL; the port writes the PNG itself with
``zlib`` and ``struct``: 8-bit grayscale for one channel, 8-bit RGB for
three, every row with filter 0. It reads without PIL too: :func:`read_png`
decodes any non-interlaced PNG of 8 bits or fewer a sample (what was
written here, and the datasets' files: Omniglot's 1-bit strokes, COIL100's
RGB), :func:`read_ppm` binary PPMs.
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


# PIL's ITU-R 601-2 luma in 16-bit fixed point (its "L24"), for convert("L")
_LUMA = np.array([19595, 38470, 7471], np.uint32)
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}  # a gray sample of this depth to 8 bits


def _unfilter(raw: np.ndarray, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters of ``raw [H, 1 + stride]``; ``bpp`` is the
    filters' left distance in bytes (it divides ``stride``)."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = out[0]  # the row above the first is zeros
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 1:  # Sub: a running sum mod 256 along each byte lane
            line = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            line = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte reads the one decoded before
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
                    continue
                up_left = up[x - bpp] if x >= bpp else 0
                p = left + up[x] - up_left
                pa, pb, pc = abs(p - left), abs(p - up[x]), abs(p - up_left)
                pred = left if pa <= pb and pa <= pc else (up[x] if pb <= pc else up_left)
                cur[x] = (cur[x] + pred) & 0xFF
            line = cur
        elif kind != 0:
            raise ValueError(f"{path}: unknown filter {kind} in row {y}")
        out[y] = line
        prev = out[y]
    return out


def _to_mode(img: np.ndarray, mode: str | None) -> np.ndarray:
    """``[H, W, 1|3]`` uint8 as PIL's ``convert(mode)`` gives it:
    ``"L"`` one channel (RGB by PIL's fixed-point luma), ``"RGB"`` three
    (gray replicated), ``None`` as it is."""
    if mode is None or (mode == "L") == (img.shape[-1] == 1):
        return img
    if mode == "RGB":
        return np.repeat(img, 3, axis=-1)
    if mode == "L":
        return ((img.astype(np.uint32) @ _LUMA + 0x8000) >> 16).astype(np.uint8)[..., None]
    raise ValueError(f"mode must be 'L', 'RGB' or None, got {mode!r}")


def read_png(path: str, mode: str | None = None) -> np.ndarray:
    """The uint8 ``[H, W, C]`` pixels of a non-interlaced PNG: gray of 1, 2,
    4 or 8 bits (scaled to 0..255, so 1-bit 0 / 1 reads 0 / 255), gray with
    alpha, RGB, RGBA, or palette (1-8 bits). Alpha is dropped, a palette
    looked up: gray reads as one channel, the rest as three, unless ``mode``
    (``"L"`` or ``"RGB"``) asks for what PIL's ``convert(mode)`` gives.
    16-bit samples and Adam7 interlacing raise, naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if samples is None:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not read")
    if depth == 16 or (depth != 8 and color not in (0, 3)):
        raise ValueError(f"{path}: {depth}-bit samples of colour type {color} are not read")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    bits = w * samples * depth
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (1 + -(-bits // 8))].reshape(h, -1)
    rows = _unfilter(raw, max(1, samples * depth // 8), path)
    if depth < 8:  # unpack the samples, most significant first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    px = rows.reshape(h, w, samples)
    if color == 3:
        px = palette[np.minimum(px[..., 0], len(palette) - 1)]
    elif color == 0:
        px = px * np.uint8(_GRAY_SCALE[depth])
    else:
        px = px[..., :1] if color == 4 else px[..., :3]  # alpha dropped
    return _to_mode(np.ascontiguousarray(px), mode)


def read_ppm(path: str, mode: str | None = None) -> np.ndarray:
    """The uint8 ``[H, W, 3]`` pixels of a binary PPM (``P6``, maxval 255;
    ``#`` comments in the header), converted as :func:`read_png` does."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    if fields[0] != b"P6" or int(fields[3]) != 255:
        raise ValueError(f"{path}: only binary PPM (P6) with maxval 255 is read")
    w, h = int(fields[1]), int(fields[2])
    px = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos + 1)
    return _to_mode(px.reshape(h, w, 3).copy(), mode)


def read_image(path: str, mode: str | None = None) -> np.ndarray:
    """A PNG or binary PPM by its extension (:func:`read_png`,
    :func:`read_ppm`); any other format, JPEG included, raises naming the
    file: this package decodes no JPEG."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path, mode)
    if ext == ".ppm":
        return read_ppm(path, mode)
    raise ValueError(f"{path}: only PNG and binary PPM files are decoded here, not {ext!r}")


def save_image_grid(img, path: str, nrow: int = 10, padding: int = 2,
                    pad_value: int = 0, value_range=(-1.0, 1.0)) -> None:
    """NHWC images in ``value_range`` as one PNG grid, ``nrow`` per row."""
    makedir_exist_ok(os.path.dirname(path) or ".")
    grid = make_grid(to_uint8(np.asarray(img), value_range), nrow, padding, pad_value)
    write_png(path, grid)
