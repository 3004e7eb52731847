"""The MC-gated 1x1 product of the Gated PixelCNN: wrapper, plain version,
gradient and launch count.

``mc_gated_matmul(x, w, alpha, beta, indicator, codebook, relu)`` computes,
for ``x [B, K, P]`` (the NCHW activations of B samples over P = H * W
positions, or ``[B, K]`` for one position) and ``w [N, K]`` (a 1x1 conv's
weight),

    acc[b, n, p] = sum_k w[n, k] x[b, k, p]                      (f32 sums)
    out[b, n, p] = act(acc[b, n, p] alpha[n] + beta[n]) code[b, n]
    code         = indicator @ codebook                          (f32)

in ``x``'s dtype (f32, or bf16 on the card), of ``x``'s shape with N
channels. ``alpha`` / ``beta`` ``[N]`` (f32, default 1 / 0) carry an eval
BatchNorm and the conv's bias (:func:`bn_epilogue`), ``act`` is ReLU with
``relu=True``, else the identity; ``indicator [B, modes]`` (one-hot, or a
soft row mix) and ``codebook [modes, N]`` are the MC gate, skipped when
``indicator`` is None. With ``alpha = beta = None`` and P = 1 this is the
TPU kernel's function ``(x @ w.T) * (indicator @ codebook)``.

On a CUDA tensor it launches ``csrc/mc_gated_matmul.cu`` or raises; on a CPU
tensor it computes :func:`mc_gated_matmul_reference`. The ``.cu`` holds three
hand kernels, one launched per call, which its entry point picks by the
shape (``samples``: bf16, P = 64, one product per sample on ``wgmma``;
``rows``: bf16, P = 1, 64 x 64 tiles on ``wgmma``; ``generic``: f32 and
every other shape); :func:`variant` names it. The call is a
``torch.autograd.Function`` whose backward is the JAX package's VJP of the
TPU kernel, widened to the epilogue: the mask is a constant, so with
``gz = g * code`` (times ``out > 0`` under ReLU, times ``alpha``)
``dx = w^T gz`` and ``dw = sum gz x^T``, as plain products (the JAX VJP
leaves them to XLA outside the kernel). ``alpha``, ``beta``, ``indicator``
and ``codebook`` get no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.layers import BN_EPS
from . import build

KERNEL = "mc_gated_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("generic", "samples", "rows")  # the .cu's kernels, by its variant code


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


class _MCGatedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, alpha, beta, indicator, codebook, relu):
        out = _forward(x, w, alpha, beta, indicator, codebook, relu)
        ctx.save_for_backward(x, w, alpha, indicator, codebook, out)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, alpha, indicator, codebook, out = ctx.saved_tensors
        gz = _as3(g).float()
        if indicator is not None:
            gz = gz * (indicator.float() @ codebook.float())[:, :, None]
        if ctx.relu:
            gz = gz * (_as3(out) > 0)
        if alpha is not None:
            gz = gz * alpha.float()[:, None]
        x3 = _as3(x).float()
        dx = torch.einsum("nk,bnp->bkp", w.float(), gz).reshape(x.shape).to(x.dtype)
        dw = torch.einsum("bnp,bkp->nk", gz, x3).to(w.dtype)
        return dx, dw, None, None, None, None, None


def mc_gated_matmul(x, w, alpha=None, beta=None, indicator=None, codebook=None,
                    relu: bool = False) -> torch.Tensor:
    """See the module doc: the kernel for a CUDA ``x``, the plain version for
    a CPU one, differentiable in ``x`` and ``w``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mc_gated_matmul: no kernel for device {x.device}")
    _check(x, w, alpha, beta, indicator, codebook)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MCGatedMatmul.apply(x, w, alpha, beta, indicator, codebook, relu)
    return _forward(x, w, alpha, beta, indicator, codebook, relu)  # no graph to record


mc_gated_matmul.launches = 0
