"""Batch bilinear resize of uint8 images, for packing datasets.

A numpy copy of the JAX package's native resampler
(``native/fastimage.cpp``: ``compute_weights`` and ``resize_bilinear_u8``),
which follows PIL's separable triangle filter with the support widened on
downscale: per output pixel, double-precision taps normalised to sum 1, a
horizontal pass into a double buffer, a vertical pass, and ``clip8``
(clamp to [0, 255], add 0.5, truncate). It runs once per dataset, at pack
time, vectorised over the batch.

The sums are the ones the native build computes, operation for operation,
so the bytes agree with it: that build (``-O3 -march=native``) contracts
the horizontal pass's ``acc += w * s`` into one fused multiply-add per tap,
and its vertical pass adds the taps in pairs (two rounded products added
one after the other) with a fused multiply-add for an odd last tap. numpy
has no fused multiply-add, so :func:`_fma` computes one exactly from
error-free products and sums with a sum rounded to odd (Boldo and
Melquiond, "Emulation of FMA and correctly rounded sums", IEEE TC 2008).
"""

from __future__ import annotations

import math

import numpy as np

_SPLIT = 134217729.0  # 2**27 + 1: Dekker's splitter for doubles


def compute_weights(in_size: int, out_size: int):
    """The triangle filter's taps for one axis: ``(w [out, taps] float64,
    idx [out, taps] int64, n [out])``, with ``n`` the taps each output pixel
    uses (the rest are 0, their index clamped into the input)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's int conversion truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    n = xmax - xmin
    i = np.arange(taps)
    x = (xmin[:, None] + i[None, :] + 0.5 - center[:, None]) / filterscale
    w = np.where(i[None, :] < n[:, None], np.maximum(0.0, 1.0 - np.abs(x)), 0.0)
    total = np.zeros(out_size)
    for k in range(taps):  # in tap order, as the C loop sums
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    return w, np.minimum(xmin[:, None] + i[None, :], in_size - 1), n


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma(a, b, c, b_is_small_int: bool = False):
    """``a * b + c`` rounded once, elementwise, for finite doubles without
    underflow. ``b_is_small_int``: ``b`` holds integers below 2**26, so it
    needs no split."""
    p = a * b
    ah, al = _split(a)
    if b_is_small_int:
        err = (ah * b - p) + al * b
    else:
        bh, bl = _split(b)
        err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    hi, lo = _two_sum(c, p)
    # lo + err rounded to odd: where the sum was inexact and its last
    # mantissa bit is even, step one ulp toward the exact value
    s, e = _two_sum(lo, err)
    even = (np.ascontiguousarray(s).view(np.int64) & 1) == 0
    s = np.where((e != 0) & even, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return hi + s


def _resize_chunk(src: np.ndarray, wx, ix, wy, iy, ny) -> np.ndarray:
    """``src [N, H, W, C]`` float64 -> uint8 ``[N, out_h, out_w, C]``."""
    tmp = np.zeros((src.shape[0], src.shape[1], wx.shape[0], src.shape[3]))
    for k in range(wx.shape[1]):  # every tap a fused multiply-add (0-weight taps add 0)
        tmp = _fma(wx[None, None, :, k, None], src[:, :, ix[:, k], :], tmp,
                   b_is_small_int=True)
    acc = np.zeros((src.shape[0], wy.shape[0], wx.shape[0], src.shape[3]))
    paired = (ny - ny % 2)[None, :, None, None]
    last = (ny - 1)[None, :, None, None]
    odd = (ny % 2 == 1)[None, :, None, None]
    for k in range(wy.shape[1]):
        w, t = wy[None, :, k, None, None], tmp[:, iy[:, k], :, :]
        ends = odd & (k == last)  # the rows whose odd last tap is k
        acc = np.where(k < paired, acc + w * t,
                       np.where(ends, _fma(w, t, acc), acc) if ends.any() else acc)
    acc = np.where(acc < 0.0, 0.0, np.where(acc > 255.0, 255.0, acc + 0.5))
    return acc.astype(np.uint8)  # truncation, as clip8's cast


def resize_bilinear_u8(img: np.ndarray, out_h: int, out_w: int | None = None,
                       chunk: int = 256) -> np.ndarray:
    """``[N, H, W, C]`` uint8 -> ``[N, out_h, out_w, C]`` uint8 (``out_w``
    defaults to ``out_h``), in chunks of ``chunk`` images."""
    img = np.asarray(img)
    if img.ndim != 4 or img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8 [N, H, W, C], got {img.dtype} {img.shape}")
    out_w = out_h if out_w is None else out_w
    n, h, w, c = img.shape
    wx, ix, _ = compute_weights(w, out_w)
    wy, iy, ny = compute_weights(h, out_h)
    out = np.empty((n, out_h, out_w, c), np.uint8)
    for i in range(0, n, chunk):
        out[i:i + chunk] = _resize_chunk(img[i:i + chunk].astype(np.float64), wx, ix, wy, iy,
                                         ny)
    return out
