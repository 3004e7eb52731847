"""The int8 serving path's two kernels: the activation quantizer and the
implicit-GEMM s8 x s8 -> s32 convolution. Wrappers, plain versions and
launch counts.

``int8_quantize(x, amax=None)`` -> ``(q, scale)``: for ``x [B, ...]`` (f32
or bf16, each example contiguous), ``scale = max(amax, 1e-8) / 127`` with
``amax`` each example's ``max |x|`` (dynamic) or the given f32 scalar
(static, a calibrated ``act_amax``), ``q = clip(round(x / scale), -127,
127)`` int8 in ``x``'s shape and ``scale [B]`` f32.

``int8_conv(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype)``:
for ``x [B, H, W, C]`` int8 (NHWC) and ``w [N, taps * C]`` int8 (see
:func:`pack_direct` / :func:`pack_up2`), the exact integer sums of the
convolution, dequantized ``float(acc) * (wscale[n] * xscale[b])``, rounded
to ``out_dtype`` (f32 or bf16), then ``+ bias`` in that dtype; NHWC ``[B,
Ho, Wo, N]``. ``layout`` ``DIRECT``: ``kh x kw`` taps, stride 1, zero
padding ``pad``; ``UP2``: the 4x4 kernel of a conv over ``x`` dilated by 2
with padding 2 (the JAX package's ``lhs_dilation=2`` form), ``Ho = 2H``.

On a CUDA tensor each launches its kernel (``csrc/int8_conv.cu``) or raises,
and its ``launches`` gains one per kernel launched (``int8_quantize``: two
in dynamic mode, the abs-max and the rounding, one in static mode); on a CPU
tensor it computes the plain version (:func:`int8_quantize_reference`,
:func:`int8_conv_reference`: the integer sums exact in int64). Serving needs
no gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

KERNEL = "int8_conv"
DIRECT, UP2 = 0, 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the exact sums of the plain version on the card run in f64: every |sum| of
# K products of two int8 levels stays below 2^53
_F64_EXACT_K = 2 ** 53 // 127 ** 2


def quantize_sym(t: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``t`` with one scale per index of the
    axes not in ``dims``: ``(q, scale)``, ``t ~ q * scale``, ``scale`` f32
    keeping ``t``'s rank (the JAX package's ``_quantize_sym``)."""
    scale = _scale(t.float().abs().amax(dim=dims, keepdim=True))
    return _round(t, scale), scale


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # a true division: torch divides by a Python number through its
    # reciprocal on the card, so 127 is a tensor on amax's device
    return amax.clamp_min(1e-8) / amax.new_tensor(127.0)


def _round(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # in f32 whatever t's dtype (a 0-d f32 scale would not promote bf16)
    return torch.clamp(torch.round(t.float() / scale), -127, 127).to(torch.int8)


def pack_direct(w: torch.Tensor) -> torch.Tensor:
    """An OIHW kernel ``[N, C, kh, kw]`` as ``[N, kh * kw * C]`` (tap-major,
    channel fastest), the order the DIRECT layout reads."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def pack_up2(w4: torch.Tensor) -> torch.Tensor:
    """A 4x4 HWIO kernel ``[4, 4, C, N]`` (of the dilated form) as ``[N, 16
    C]``, phase-major: row ``n`` is ``[a][b][du][dv][c]`` with tap ``(a + 2
    du, b + 2 dv)``, so output parity ``(a, b)`` reads its own 4 C-long
    slice."""
    N = w4.shape[-1]
    w = w4.reshape(2, 2, 2, 2, *w4.shape[2:])  # [du, a, dv, b, C, N]
    return w.permute(5, 1, 3, 0, 2, 4).reshape(N, -1)


def int8_quantize_reference(x: torch.Tensor, amax: torch.Tensor | None = None):
    """Plain version of :func:`int8_quantize`."""
    if amax is None:
        q, scale = quantize_sym(x, tuple(range(1, x.dim())))
        return q, scale.reshape(-1)
    scale = _scale(amax.float())
    return _round(x, scale), scale.expand(x.shape[0]).contiguous()


def _out_hw(layout: int, H: int, W: int, kh: int, kw: int, pad: int) -> tuple[int, int]:
    if layout == UP2:
        return 2 * H, 2 * W
    return H + 2 * pad - kh + 1, W + 2 * pad - kw + 1


def _exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of int8 matrices, exact: int64 on the CPU, f64 on the card
    (no int64 product there)."""
    if a.device.type == "cpu":
        return a.long() @ b.long().t()
    if a.shape[1] > _F64_EXACT_K:
        raise ValueError(f"int8_conv_reference: K = {a.shape[1]} too long for exact f64 sums")
    return (a.double() @ b.double().t()).long()


def int8_conv_reference(x, w, wscale, xscale, bias, layout: int, kh: int, kw: int, pad: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`int8_conv`: im2col of each phase, the exact
    integer product, the dequantization and the bias as the kernel rounds
    them."""
    B, H, W, C = x.shape
    N = w.shape[0]
    Ho, Wo = _out_hw(layout, H, W, kh, kw, pad)
    scale = wscale.float()[None, :] * xscale.float()[:, None]  # [B, N], the product first

    def dequant(acc, h, w_):  # acc [B h w_, N] int64
        y = (acc.float().reshape(B, h * w_, N) * scale[:, None, :]).to(out_dtype)
        if bias is not None:
            y = y + bias.to(out_dtype)
        return y.reshape(B, h, w_, N)

    if layout == DIRECT:
        xp = F.pad(x, (0, 0, pad, pad, pad, pad))
        cols = torch.stack([xp[:, dy:dy + Ho, dx:dx + Wo] for dy in range(kh)
                            for dx in range(kw)], 3)
        return dequant(_exact_mm(cols.reshape(B * Ho * Wo, -1), w), Ho, Wo)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # x[i + du + a - 1] is xp[i + du + a]
    out = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=x.device)
    for phase in range(4):
        a, b = divmod(phase, 2)
        cols = torch.stack([xp[:, du + a:du + a + H, dv + b:dv + b + W] for du in (0, 1)
                            for dv in (0, 1)], 3)
        wp = w[:, phase * 4 * C:(phase + 1) * 4 * C]
        out[:, a::2, b::2] = dequant(_exact_mm(cols.reshape(B * H * W, -1), wp), H, W)
    return out


def _check_conv(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype):
    if x.dim() != 4 or x.dtype != torch.int8 or w.dim() != 2 or w.dtype != torch.int8:
        raise ValueError(f"int8_conv: x {x.dtype} {tuple(x.shape)}, w {w.dtype} "
                         f"{tuple(w.shape)}: want int8 [B, H, W, C] and [N, taps * C]")
    taps = 16 if layout == UP2 else kh * kw
    if layout not in (DIRECT, UP2) or w.shape[1] != taps * x.shape[3]:
        raise ValueError(f"int8_conv: layout {layout}, w {tuple(w.shape)} for C = {x.shape[3]}")
    if out_dtype not in _DTYPES:
        raise ValueError(f"int8_conv: out_dtype {out_dtype}: want f32 or bf16")
    want = {"wscale": (w.shape[0],), "xscale": (x.shape[0],)}
    for name, t in (("x", x), ("w", w), ("wscale", wscale), ("xscale", xscale),
                    ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int8_conv: {name} must be contiguous on {x.device}")
        if name in want and (t.dtype != torch.float32 or tuple(t.shape) != want[name]):
            raise ValueError(f"int8_conv: {name}: want f32 {want[name]}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"int8_conv: bias {tuple(bias.shape)}: want [{w.shape[0]}]")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def int8_conv(x, w, wscale, xscale, bias, layout: int, kh: int, kw: int, pad: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    """See the module doc: the kernel on a CUDA ``x``, the plain version on a
    CPU one."""
    _check_conv(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype)
    if x.device.type == "cpu":
        return int8_conv_reference(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: no kernel for device {x.device}")
    B, H, W, C = x.shape
    N = w.shape[0]
    Ho, Wo = _out_hw(layout, H, W, kh, kw, pad)
    out = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=x.device)
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    lib = build.load(KERNEL)
    fn = lib.mcgm_int8_conv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), wscale.data_ptr(), xscale.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(), _DTYPES[out_dtype],
                 B, H, W, C, N, layout, kh, kw, pad, _stream(x))
    build.check(lib, err, KERNEL)
    int8_conv.launches += 1
    return out


def int8_quantize(x: torch.Tensor, amax: torch.Tensor | None = None):
    """See the module doc: the kernel on a CUDA ``x``, the plain version on a
    CPU one."""
    if x.dtype not in _DTYPES or not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"int8_quantize: x {x.dtype} {tuple(x.shape)}: want contiguous f32 "
                         "or bf16 [B, ...]")
    if amax is not None and (amax.numel() != 1 or amax.dtype != torch.float32
                             or amax.device != x.device):
        raise ValueError(f"int8_quantize: amax must be one f32 value on {x.device}")
    if x.device.type == "cpu":
        return int8_quantize_reference(x, amax)
    if x.device.type != "cuda":
        raise ValueError(f"int8_quantize: no kernel for device {x.device}")
    B = x.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(B, dtype=torch.float32, device=x.device)
    if B == 0 or x.numel() == 0:
        return q, scale.fill_(1e-8 / 127.0)
    amax_bits = None if amax is not None else torch.empty(B, dtype=torch.int32,
                                                          device=x.device)
    lib = build.load(KERNEL)
    fn = lib.mcgm_int8_quantize
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPES[x.dtype], B, x.numel() // B,
                 None if amax is None else amax.contiguous().data_ptr(), q.data_ptr(),
                 scale.data_ptr(), None if amax_bits is None else amax_bits.data_ptr(),
                 ctypes.byref(launched), _stream(x))
    int8_quantize.launches += launched.value
    build.check(lib, err, "int8_quantize")
    return q, scale


int8_conv.launches = 0
int8_quantize.launches = 0
