"""The MC-gated 1x1 product of the Gated PixelCNN and of Glow's coupling
nets: wrapper, plain version, gradient (a backward kernel and its plain
version) and launch counts.

``mc_gated_matmul(x, w, alpha, beta, indicator, codebook, relu)`` computes,
for ``x [B, K, P]`` (the NCHW activations of B samples over P = H * W
positions, or ``[B, K]`` for one position) and ``w [N, K]`` (a 1x1 conv's
weight),

    acc[b, n, p] = sum_k w[n, k] x[b, k, p]                      (f32 sums)
    out[b, n, p] = act(acc[b, n, p] alpha[n] + beta[n]) code[b, n]
    code         = indicator @ codebook                          (f32)

in ``x``'s dtype (f32, or bf16 on the card), of ``x``'s shape with N
channels. ``alpha`` / ``beta`` ``[N]`` (f32, default 1 / 0) carry an eval
BatchNorm and the conv's bias (:func:`bn_epilogue`), or Glow's ActNorm,
``act`` is ReLU with ``relu=True``, else the identity; ``indicator [B,
modes]`` (one-hot, or a soft row mix) and ``codebook [modes, N]`` are the
MC gate, skipped when ``indicator`` is None. With ``alpha = beta = None``
and P = 1 this is the TPU kernel's function ``(x @ w.T) * (indicator @
codebook)``.

On a CUDA tensor it launches ``csrc/mc_gated_matmul.cu`` or raises; on a CPU
tensor it computes :func:`mc_gated_matmul_reference`. The ``.cu`` holds three
hand kernels, one launched per call, which its entry point picks by the
shape (``rows``: bf16, P = 1, 64 x 64 tiles on ``wgmma``; ``wide``: bf16, K
a multiple of 64 up to 512, P 16, 32 or a multiple of 64, TMA and ``wgmma``
with w's rows resident, the PixelCNN's eval forward and Glow's K = N = 512;
``generic``: f32 and every other shape); :func:`variant` names it.

The call is a ``torch.autograd.Function``. Its backward is the JAX
package's VJP of the TPU kernel, widened to the epilogue: with ``gz = g *
code`` (times the ReLU's mask) ``dbeta = sum_{b,p} gz`` and ``dalpha =
sum_{b,p} gz * acc``, then with ``gza = gz * alpha`` ``dx = w^T gza`` and
``dw = sum_b gza x^T``. ``alpha`` and ``beta`` get their gradients where
they require them (Glow's ActNorm after its coupling nets' 1x1, the
conv's bias through ``beta``); ``indicator`` and ``codebook`` get none.
:func:`backward_variant` picks, by shape, how: ``wide`` where the forward
took the ``wide`` kernel (a CUDA backward kernel recomputes ``acc`` with
the forward's tiling, so its mask ``[pre > 0]`` is the forward's, and
writes ``gza`` in bf16 as ``[N, B, P]`` with ``dalpha`` / ``dbeta`` in f32;
``dx`` and ``dw`` are then one bf16 cuBLAS product each, as the JAX VJP
leaves them to XLA, ``dw`` over the copy of ``x`` as ``[K, B, P]`` that the
kernel writes from the chunks it reads); ``plain`` for every
other shape, f32 included, and on the CPU:
:func:`mc_gated_matmul_backward_reference`, the math in f32 with the mask
``out > 0``. ``mc_gated_matmul.launches`` counts the forward kernels'
launches, ``mc_gated_matmul.backward_launches`` the backward kernel's.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.layers import BN_EPS
from . import build

KERNEL = "mc_gated_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("generic", "rows", "wide")  # the .cu's kernels, by its variant code


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel that a call on CUDA ``x`` and ``w`` launches, as the C entry
    point chooses it (``mcgm_mc_gated_matmul_variant``: by shape, dtype and
    16-byte alignment; the output is allocated aligned)."""
    x3 = _as3(x)
    B, K, P = x3.shape
    fn = build.load(KERNEL).mcgm_mc_gated_matmul_variant
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6
    aligned = (x3.data_ptr() | w.data_ptr()) % 16 == 0
    return VARIANTS[fn(B * P, w.shape[0], K, P, _DTYPES[x.dtype], int(aligned))]


def backward_variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """How the gradient of a call on ``x`` and ``w`` is taken: ``wide``
    (the backward kernel and two bf16 cuBLAS products) where the forward
    launches the ``wide`` kernel, else ``plain``
    (:func:`mc_gated_matmul_backward_reference`); ``plain`` on the CPU."""
    return "wide" if x.device.type == "cuda" and variant(x, w) == "wide" else "plain"


def bn_epilogue(bn, conv_bias) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha, beta)`` of an eval BatchNorm after a conv with bias ``b``:
    ``alpha = gamma rsqrt(var + eps)``, ``beta = (b - mean) alpha + beta_bn``,
    f32 (the JAX sampler's ``bn_affine`` with the bias folded in)."""
    alpha = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
    beta = (conv_bias - bn.running_mean) * alpha + bn.bias
    return alpha.float().contiguous(), beta.float().contiguous()


def _as3(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, None] if x.dim() == 2 else x


def mc_gated_matmul_reference(x, w, alpha=None, beta=None, indicator=None, codebook=None,
                              relu: bool = False) -> torch.Tensor:
    """Plain version: the product and the epilogue in f32, rounded to
    ``x``'s dtype once at the end, as the kernel does."""
    acc = torch.einsum("nk,bkp->bnp", w.float(), _as3(x).float())
    if alpha is not None:
        acc = acc * alpha.float()[:, None]
    if beta is not None:
        acc = acc + beta.float()[:, None]
    if relu:
        acc = acc.relu()
    if indicator is not None:
        acc = acc * (indicator.float() @ codebook.float())[:, :, None]
    return acc.to(x.dtype).reshape(x.shape[:1] + acc.shape[1:2] + x.shape[2:])


def mc_gated_matmul_backward_reference(x, w, alpha, beta, indicator, codebook, relu: bool, g,
                                       out):
    """Plain version of the backward, in f32: with ``gz = g * code`` (times
    ``out > 0`` under ReLU), ``dbeta = sum gz``, ``dalpha = sum gz * acc``
    (``acc = w @ x`` recomputed), then with ``gz`` times ``alpha`` ``dx =
    w^T gz`` and ``dw = sum gz x^T``. Returns ``(dx, dw, dalpha, dbeta)``:
    ``dx`` in ``x``'s dtype and shape, ``dw`` in ``w``'s dtype, ``dalpha`` /
    ``dbeta`` f32 ``[N]``. ``beta`` is not read: the mask comes from
    ``out``."""
    del beta
    gz = _as3(g).float()
    if indicator is not None:
        gz = gz * (indicator.float() @ codebook.float())[:, :, None]
    if relu:
        gz = gz * (_as3(out) > 0)
    x3 = _as3(x).float()
    dbeta = gz.sum((0, 2))
    dalpha = (gz * torch.einsum("nk,bkp->bnp", w.float(), x3)).sum((0, 2))
    if alpha is not None:
        gz = gz * alpha.float()[:, None]
    dx = torch.einsum("nk,bnp->bkp", w.float(), gz).reshape(x.shape).to(x.dtype)
    dw = torch.einsum("bnp,bkp->nk", gz, x3).to(w.dtype)
    return dx, dw, dalpha, dbeta


def _check(x, w, alpha, beta, indicator, codebook):
    if x.dim() not in (2, 3) or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"mc_gated_matmul: x {tuple(x.shape)}, w {tuple(w.shape)}: want "
                         "[B, K] or [B, K, P] and [N, K]")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"mc_gated_matmul: x {x.dtype}, w {w.dtype}: want both f32 or bf16")
    if (indicator is None) != (codebook is None):
        raise ValueError("mc_gated_matmul: indicator and codebook go together")
    B, N = x.shape[0], w.shape[0]
    want = {"alpha": (N,), "beta": (N,)}
    if indicator is not None:
        want.update(indicator=(B, indicator.shape[-1]), codebook=(indicator.shape[-1], N))
    for name, t in (("x", x), ("w", w), ("alpha", alpha), ("beta", beta),
                    ("indicator", indicator), ("codebook", codebook)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"mc_gated_matmul: {name} must be contiguous on {x.device}")
        if name in want and (t.dtype != torch.float32 or tuple(t.shape) != want[name]):
            raise ValueError(f"mc_gated_matmul: {name}: want f32 {want[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _launch(x, w, alpha, beta, indicator, codebook, relu: bool) -> torch.Tensor:
    """The kernel on ``x``'s card; the inputs are checked."""
    x3 = _as3(x)
    B, K, P = x3.shape
    N = w.shape[0]
    out = torch.empty((B, N, P), dtype=x.dtype, device=x.device)
    if B * P == 0 or N == 0:
        return out.reshape(x.shape[:1] + (N,) + x.shape[2:])
    if K == 0:
        raise ValueError("mc_gated_matmul: K = 0")
    lib = build.load(KERNEL)
    fn = lib.mcgm_mc_gated_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

    def ptr(t):
        return None if t is None else t.data_ptr()

    modes = 0 if indicator is None else indicator.shape[-1]
    with torch.cuda.device(x.device):
        err = fn(x3.data_ptr(), w.data_ptr(), ptr(alpha), ptr(beta), ptr(indicator),
                 ptr(codebook), out.data_ptr(), B * P, N, K, P, modes, int(relu),
                 _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, KERNEL)
    mc_gated_matmul.launches += 1
    return out.reshape(x.shape[:1] + (N,) + x.shape[2:])


def _forward(x, w, alpha, beta, indicator, codebook, relu: bool) -> torch.Tensor:
    """The kernel on a CUDA ``x``, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return mc_gated_matmul_reference(x, w, alpha, beta, indicator, codebook, relu)
    return _launch(x, w, alpha, beta, indicator, codebook, relu)


# per (device, stream): the backward kernel's counters, which every launch
# leaves at 0 (see the .cu)
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _backward_counters(device, stream, n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    t = _COUNTERS.get(key)
    if t is None or t.numel() < n:
        t = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def mc_gated_matmul_backward_kernel(x, w, alpha, beta, indicator, codebook, relu: bool, g,
                                    transposed_x: bool = True):
    """The backward kernel alone, on the card, for a call that
    :func:`backward_variant` names ``wide``: ``(gza, dalpha, dbeta, xt)``,
    with ``gza [N, B, P]`` bf16 ``= g * code * [pre > 0] * alpha``,
    ``dalpha`` / ``dbeta [N]`` f32 and, with ``transposed_x``, ``xt [K, B,
    P]``, x copied on by the kernel from the chunks it reads (else None).
    One launch, counted in ``mc_gated_matmul.backward_launches``; raises if
    the card refuses it."""
    B, K, P = x.shape
    N = w.shape[0]
    g = g.to(torch.bfloat16).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    lib = build.load(KERNEL)
    size, launch = lib.mcgm_mc_gated_matmul_backward_scratch, lib.mcgm_mc_gated_matmul_backward
    if size.argtypes is None:
        size.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    if launch.argtypes is None:
        launch.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def ptr(t):
        return None if t is None else t.data_ptr()

    floats, counters = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(x.device):
        build.check(lib, size(B * P, N, K, P, ctypes.byref(floats), ctypes.byref(counters)),
                    f"{KERNEL} backward")
        stream = torch.cuda.current_stream(x.device)
        count = _backward_counters(x.device, stream, counters.value)
        scratch = torch.empty(2 * N + floats.value, dtype=torch.float32, device=x.device)
        dalpha, dbeta = scratch[:N], scratch[N:2 * N]
        gza = torch.empty((N, B, P), dtype=torch.bfloat16, device=x.device)
        xt = torch.empty((K, B, P), dtype=torch.bfloat16, device=x.device) if transposed_x else None
        modes = 0 if indicator is None else indicator.shape[-1]
        err = launch(x.data_ptr(), w.data_ptr(), ptr(alpha), ptr(beta), ptr(indicator),
                     ptr(codebook), g.data_ptr(), gza.data_ptr(), ptr(xt), dalpha.data_ptr(),
                     dbeta.data_ptr(), scratch[2 * N:].data_ptr(), count.data_ptr(), B * P, N,
                     K, P, modes, int(relu), stream.cuda_stream)
    build.check(lib, err, f"{KERNEL} backward")
    mc_gated_matmul.backward_launches += 1
    return gza, dalpha, dbeta, xt


def _backward_wide(x, w, alpha, beta, indicator, codebook, relu: bool, g, need_x=True,
                   need_w=True):
    """``(dx, dw, dalpha, dbeta)`` through the backward kernel, then ``dx =
    w^T gza`` (a ``[B, K, P]`` view of a ``[K, B, P]`` product) and ``dw =
    gza xt^T`` over the kernel's copy ``xt [K, B, P]`` of ``x``: one bf16
    cuBLAS product each, f32 sums."""
    B, K, P = x.shape
    N = w.shape[0]
    gza, dalpha, dbeta, xt = mc_gated_matmul_backward_kernel(
        x, w, alpha, beta, indicator, codebook, relu, g, transposed_x=need_w)
    gza = gza.view(N, B * P)
    dx = torch.mm(w.t(), gza).view(K, B, P).transpose(0, 1) if need_x else None
    dw = torch.mm(gza, xt.view(K, B * P).t()) if need_w else None
    return dx, dw, dalpha, dbeta


def mc_gated_matmul_backward(x, w, alpha, beta, indicator, codebook, relu: bool, g, out=None):
    """``(dx, dw, dalpha, dbeta)`` of a call, as the autograd Function takes
    them (:func:`backward_variant`): the backward kernel and two bf16 cuBLAS
    products where it is ``wide``, else the plain version, which needs the
    forward's ``out`` under ReLU (computed here when not given)."""
    if backward_variant(x, w) == "wide":
        return _backward_wide(x, w, alpha, beta, indicator, codebook, relu, g)
    if out is None and relu:
        out = _forward(x, w, alpha, beta, indicator, codebook, relu)
    return mc_gated_matmul_backward_reference(x, w, alpha, beta, indicator, codebook, relu, g,
                                              out)


class _MCGatedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, alpha, beta, indicator, codebook, relu):
        out = _forward(x, w, alpha, beta, indicator, codebook, relu)
        # the backward kernel recomputes the mask: out is kept only for the
        # plain backward
        ctx.kernel = backward_variant(x, w) == "wide"
        ctx.save_for_backward(x, w, alpha, beta, indicator, codebook,
                              None if ctx.kernel else out)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, alpha, beta, indicator, codebook, out = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        if ctx.kernel:
            grads = _backward_wide(x, w, alpha, beta, indicator, codebook, ctx.relu, g,
                                   need[0], need[1])
        else:
            grads = mc_gated_matmul_backward_reference(x, w, alpha, beta, indicator, codebook,
                                                       ctx.relu, g, out)
        return tuple(d if n else None for d, n in zip(grads, need)) + (None, None, None)


def mc_gated_matmul(x, w, alpha=None, beta=None, indicator=None, codebook=None,
                    relu: bool = False) -> torch.Tensor:
    """See the module doc: the kernel for a CUDA ``x``, the plain version for
    a CPU one, differentiable in ``x``, ``w``, ``alpha`` and ``beta``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mc_gated_matmul: no kernel for device {x.device}")
    _check(x, w, alpha, beta, indicator, codebook)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, alpha, beta)):
        return _MCGatedMatmul.apply(x, w, alpha, beta, indicator, codebook, relu)
    return _forward(x, w, alpha, beta, indicator, codebook, relu)  # no graph to record


mc_gated_matmul.launches = 0
mc_gated_matmul.backward_launches = 0
