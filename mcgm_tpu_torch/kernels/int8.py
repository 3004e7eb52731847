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

On a CUDA tensor each launches one kernel (``csrc/int8_conv.cu``) or
raises, and its ``launches`` gains one; on a CPU tensor it computes the
plain version (:func:`int8_quantize_reference`, :func:`int8_conv_reference`:
the integer sums exact in int64). Serving needs no gradient.

Which kernel a call takes, and its tiles and TMA boxes, is a pure function
of the shapes: :func:`conv_plan` and :func:`quantize_plan`. The ``.cu``
checks the plan it is given and refuses one it cannot run.
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

CONV_VARIANTS = ("bytes", "wide", "narrow")  # the .cu's numbering
QUANTIZE_VARIANTS = ("static", "rows", "cluster", "stream")
WIDE_ROWS, NARROW_ROWS = 128, 256  # output pixels per tile (the .cu's kWideRows, kNarrowRows)
NARROW_N = 8          # channels a phase of the narrow kernel's tile
NARROW_W_BYTES = 64 * 1024  # the narrow kernel keeps all of w: 8 rows per phase and shift
TMA_BOX_MAX = 256     # elements per dimension of a TMA box
STORE_BOX_BYTES = 128  # channel bytes of a wide tile's TMA store box (the .cu's kStoreCols)
Q_ROWS_MAX_E = 1024   # the rows kernel: one warp per example, 32 values a lane
Q_CLUSTER = 8         # blocks per example (a portable cluster)
Q_SLICE_BYTES = 64 * 1024       # the slice of an example a cluster block aims to hold
Q_MAX_SLICE_BYTES = 192 * 1024  # the most a block holds in shared memory


def conv_plan(B: int, H: int, W: int, C: int, N: int, layout: int, kh: int, kw: int,
              pad: int, aligned: bool = True, out_itemsize: int = 2) -> dict:
    """The kernel and tiling of an ``int8_conv`` call.

    ``variant``: ``narrow`` (8 channels a phase, all phases at once, w
    resident) for ``N <= 8``; ``wide`` (m64nBNk32, its output stored by TMA
    in boxes ``store_box`` of 128 bytes of channels by the x box's pixels)
    where a row of the output (``out_itemsize`` bytes a value) is a multiple
    of 16 bytes and, up2, a box stays in its parity's ``N`` channels;
    ``bytes`` (an ``mma.sync`` kernel staging bytes) for the rest, and where
    TMA cannot take x's or w's rows (``C`` bytes, not a multiple of 16) or an
    operand is not 16-byte ``aligned``. The TMA variants also give ``kc``
    (channel bytes per k chunk: 128, 64 or 32, the swizzle's width; past
    ``C`` the box reads zeros), ``bn`` (channels per tile), ``box`` (the x
    box ``(kc, bw, bh, bb)``: channels, columns, rows, examples; ``bw bh
    bb`` pixels of one phase per tile), ``w_box`` (``(kc, 1, bn)`` over w
    viewed as ``[N, taps, C]``), the tensors' ``x_strides`` / ``w_strides``
    in bytes, and ``tiles``."""
    Hp, Wp = (H, W) if layout == UP2 else _out_hw(layout, H, W, kh, kw, pad)
    taps = 16 if layout == UP2 else kh * kw
    if C % 16 or not aligned:
        return {"variant": "bytes"}
    kc = 128 if C % 128 == 0 else 64 if C % 64 == 0 else 32
    chunks = -(-C // kc)
    shifts, phases = (9, 4) if layout == UP2 else (taps, 1)
    narrow = N <= NARROW_N and shifts * chunks * NARROW_N * phases * kc <= NARROW_W_BYTES
    sc = STORE_BOX_BYTES // out_itemsize
    if not narrow and (N * out_itemsize % 16 or (layout == UP2 and N % sc)):
        return {"variant": "bytes"}
    rows = NARROW_ROWS if narrow else WIDE_ROWS
    bn = NARROW_N if narrow else 256 if N > 128 else 128 if N > 64 else 64
    bw = min(Wp, rows, TMA_BOX_MAX)
    bh = min(Hp, rows // bw)
    bb = min(B, rows // (bw * bh))
    tiles = -(-Wp // bw) * -(-Hp // bh) * -(-B // bb) * -(-N // bn)
    return {"variant": "narrow" if narrow else "wide", "kc": kc, "chunks": chunks, "bn": bn,
            "rows": rows, "box": (kc, bw, bh, bb), "w_box": (kc, 1, bn), "tiles": tiles,
            "x_strides": (C, W * C, H * W * C), "w_strides": (C, taps * C),
            "store_box": None if narrow else (sc, bw, bh, bb)}


def quantize_plan(B: int, E: int, itemsize: int, static: bool, aligned: bool = True) -> dict:
    """The kernel of an ``int8_quantize`` call on ``x [B, E]`` of
    ``itemsize`` bytes: ``static`` (the rounding alone), ``rows`` (one warp
    per example, ``E <= 1024``), ``cluster`` (a cluster of ``cluster``
    blocks per example, each holding ``slice`` elements in shared memory:
    x read once) or ``stream`` (the cluster reading its slices twice: an
    example too large for the cluster's shared memory, or one whose rows are
    not 16-byte aligned)."""
    if static:
        return {"variant": "static", "cluster": 0, "slice": 0}
    if E <= Q_ROWS_MAX_E:
        return {"variant": "rows", "cluster": 0, "slice": 0}
    if E % 16 == 0 and aligned:
        cluster = min(Q_CLUSTER, max(1, -(-E * itemsize // Q_SLICE_BYTES)))
        slice_ = (-(-E // cluster) + 15) // 16 * 16
        if slice_ * itemsize <= Q_MAX_SLICE_BYTES:
            return {"variant": "cluster", "cluster": cluster, "slice": slice_}
    return {"variant": "stream", "cluster": Q_CLUSTER, "slice": -(-E // Q_CLUSTER)}


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


def conv_entry(lib: ctypes.CDLL):
    """``mcgm_int8_conv`` of a loaded build of the ``.cu``, typed."""
    fn = lib.mcgm_int8_conv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    return fn


def conv_launch_args(x, w, wscale, xscale, bias, layout, kh, kw, pad, out):
    """``(args, plan)``: the arguments of ``mcgm_int8_conv`` for checked
    CUDA operands (``bias`` already in ``out``'s dtype) and the plan they
    carry."""
    B, H, W, C = x.shape
    N = w.shape[0]
    plan = conv_plan(B, H, W, C, N, layout, kh, kw, pad,
                     aligned=(x.data_ptr() | w.data_ptr() | out.data_ptr()) % 16 == 0,
                     out_itemsize=out.element_size())
    _, bw, bh, bb = plan.get("box", (0, 0, 0, 0))
    args = (x.data_ptr(), w.data_ptr(), wscale.data_ptr(), xscale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), _DTYPES[out.dtype],
            B, H, W, C, N, layout, kh, kw, pad, CONV_VARIANTS.index(plan["variant"]),
            plan.get("kc", 0), plan.get("bn", 0), bw, bh, bb, _stream(x))
    return args, plan


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
    args, plan = conv_launch_args(x, w, wscale, xscale, bias, layout, kh, kw, pad, out)
    with torch.cuda.device(x.device):
        err = conv_entry(lib)(*args)
    build.check(lib, err, f"{KERNEL} ({plan['variant']})")
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
    E = x.numel() // B
    plan = quantize_plan(B, E, x.element_size(), amax is not None,
                         aligned=(x.data_ptr() | q.data_ptr()) % 16 == 0)
    lib = build.load(KERNEL)
    fn = lib.mcgm_int8_quantize
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                                  ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _DTYPES[x.dtype], B, E,
                 None if amax is None else amax.contiguous().data_ptr(), q.data_ptr(),
                 scale.data_ptr(), QUANTIZE_VARIANTS.index(plan["variant"]), plan["cluster"],
                 plan["slice"], ctypes.byref(launched), _stream(x))
    int8_quantize.launches += launched.value
    build.check(lib, err, f"int8_quantize ({plan['variant']})")
    return q, scale


int8_conv.launches = 0
int8_quantize.launches = 0
