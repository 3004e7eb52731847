"""NN building blocks of the GAN and VAE paths, ported from
``mcgm_tpu/ops/layers.py``.

Activations inside the port are NCHW tensors (``torch.channels_last`` in
memory where the input is). Parameters are f32 and are cast to the
activation's dtype at each op, so a model run on bf16 activations computes
with bf16 operands and f32 master weights, as the JAX package's
``set_compute_dtype(bfloat16)`` does. These ops compute the JAX layers'
math, not their TPU rewrites: ``UpsampledConv`` is conv3x3 of the nearest
2x upsample, ``ConvS2D`` a plain conv3x3.

Initializers follow the JAX package: xavier-uniform kernels for the GAN
family and torch-uniform kernels ``U(+-1/sqrt(fan_in))`` for the VAE family
(``kernel_init``), torch-uniform biases, BatchNorm scale ~ N(1, 0.02) and
bias 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.9  # flax convention: running = m * running + (1 - m) * batch
BN_EPS = 1e-5


def resolve_compute_dtype(name: str | None, device) -> torch.dtype:
    """'auto' means bf16 operands on the card and f32 on the CPU."""
    if name in (None, "auto"):
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    if name in ("float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r}")


# ------------------------------------------------------------- initializers
def xavier_uniform(shape, fan_in: int, fan_out: int, generator=None) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def torch_uniform(shape, fan_in: int, fan_out: int, generator=None) -> torch.Tensor:
    """torch's default kernel init, ``U(+-1/sqrt(fan_in))`` (the JAX
    package's ``torch_kernel_init``)."""
    return torch_bias(shape, fan_in, generator)


def torch_bias(n, fan_in: int, generator=None) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return torch.empty(n).uniform_(-bound, bound, generator=generator)


def bn_scale(n: int, generator=None) -> torch.Tensor:
    return 1.0 + 0.02 * torch.randn(n, generator=generator)


# ------------------------------------------------------------------- layers
class BatchNorm(nn.Module):
    """Batch norm over NCHW channel axis 1, eps 1e-5.

    Training normalises by the batch's biased statistics and moves the
    running ones by ``(1 - BN_MOMENTUM)`` (torch momentum 0.1), as flax does;
    eval uses the running ones. Statistics and math are f32.
    """

    def __init__(self, features: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(bn_scale(features, generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = [d for d in range(xf.ndim) if d != 1]
            mean = xf.mean(dims)
            var = xf.var(dims, unbiased=False)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (xf.ndim - 2)
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        y = (xf - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


def _bias(b, x):
    return None if b is None else b.to(x.dtype)


class Conv(nn.Module):
    """2D conv with integer padding, xavier kernel, torch-uniform bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, bias: bool = True, generator=None,
                 kernel_init=xavier_uniform):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(kernel_init(
            (out_ch, in_ch, k, k), in_ch * k * k, out_ch * k * k, generator))
        self.bias = (nn.Parameter(torch_bias(out_ch, in_ch * k * k, generator))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), _bias(self.bias, x),
                        self.stride, self.padding)


class UpsampledConv(Conv):
    """``conv3x3(pad 1)(nearest_up2(x))``; the parameters of a 3x3 ``Conv``."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True, generator=None):
        super().__init__(in_ch, out_ch, 3, 1, 1, bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(upsample_nearest(x, 2))


class ConvS2D(Conv):
    """The generators' image head: conv3x3 (pad 1) with bias. The JAX
    package lowers it space-to-depth for TPU lane fill; the math is this."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__(in_ch, out_ch, 3, 1, 1, True, generator)


class ConvTranspose(nn.Module):
    """torch ``ConvTranspose2d(k=4, s=2, p=1)``: output side ``(H-1)s - 2p + k``.

    The weight is torch's ``[in, out, k, k]``; the JAX package stores the
    kernel HWIO ``[k, k, in, out]`` and flips it for ``lax.conv_transpose``,
    so the port's weight is that kernel transposed (2, 3, 0, 1), unflipped.
    Kernel and bias take torch's uniform init over ``in * k * k``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1, generator=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch_uniform((in_ch, out_ch, k, k), in_ch * k * k,
                                                 out_ch * k * k, generator))
        self.bias = nn.Parameter(torch_bias(out_ch, in_ch * k * k, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _bias(self.bias, x),
                                  self.stride, self.padding)


class Dense(nn.Module):
    def __init__(self, in_f: int, out_f: int, bias: bool = True, generator=None,
                 kernel_init=xavier_uniform):
        super().__init__()
        self.weight = nn.Parameter(kernel_init((out_f, in_f), in_f, out_f, generator))
        self.bias = nn.Parameter(torch_bias(out_f, in_f, generator)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _bias(self.bias, x))


# --------------------------------------------------------- spectral norm
def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor,
                       update_stats: bool) -> torch.Tensor:
    """``weight / sigma`` with sigma from ONE power iteration from ``u``.

    The weight is viewed as ``[out, fan_in]``. The iteration runs in eval
    too (unlike ``torch.nn.utils.spectral_norm``); only ``update_stats``
    stores the new ``u``. Gradient flows through ``weight`` only.
    """
    mat = weight.reshape(weight.shape[0], -1)
    with torch.no_grad():
        v = _l2_normalize(mat.t() @ u)
        u_new = _l2_normalize(mat @ v)
        if update_stats:
            u.copy_(u_new)
    sigma = torch.dot(u_new, mat @ v)
    return weight / sigma


class _SpectralNorm(nn.Module):
    """Owns ``weight``, ``bias`` and the power-iteration vector ``u``."""

    def _init_sn(self, weight: torch.Tensor, bias, generator):
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None
        self.register_buffer(
            "u", _l2_normalize(torch.randn(weight.shape[0], generator=generator)))

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        return spectral_normalize(self.weight, self.u, update_stats)


class SNConv(_SpectralNorm):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, bias: bool = True, generator=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self._init_sn(xavier_uniform((out_ch, in_ch, k, k), in_ch * k * k, out_ch * k * k,
                                     generator),
                      torch_bias(out_ch, in_ch * k * k, generator) if bias else None,
                      generator)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w = self.normalized_weight(update_stats)
        return F.conv2d(x, w.to(x.dtype), _bias(self.bias, x), self.stride, self.padding)


def fold_pool(w: torch.Tensor) -> torch.Tensor:
    """3x3 OIHW kernel -> the 4x4 kernel of ``avgpool2(conv3x3(pad 1))`` as
    one stride-2 pad-1 conv: ``1/2 [W0, W0+W1, W1+W2, W2]`` along each axis."""
    for axis in (2, 3):
        w0, w1, w2 = torch.split(w, 1, dim=axis)
        w = 0.5 * torch.cat([w0, w0 + w1, w1 + w2, w2], dim=axis)
    return w


class SNConvPool(SNConv):
    """Spectral-normalised conv3x3 followed by avgpool2, as one stride-2 conv
    with the folded kernel. SN is taken on the 3x3 kernel; the parameters
    are those of a 3x3 ``SNConv``."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True, generator=None):
        super().__init__(in_ch, out_ch, 3, 1, 1, bias, generator)

    def folded_weight(self, update_stats: bool = False) -> torch.Tensor:
        return fold_pool(self.normalized_weight(update_stats))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w = self.folded_weight(update_stats)
        return F.conv2d(x, w.to(x.dtype), _bias(self.bias, x), 2, 1)


class SNDense(_SpectralNorm):
    def __init__(self, in_f: int, out_f: int, bias: bool = True, generator=None):
        super().__init__()
        self._init_sn(xavier_uniform((out_f, in_f), in_f, out_f, generator),
                      torch_bias(out_f, in_f, generator) if bias else None, generator)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        w = self.normalized_weight(update_stats)
        return F.linear(x, w.to(x.dtype), _bias(self.bias, x))


# ------------------------------------------------------------ pure functions
def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def add_upsampled_nearest(h: torch.Tensor, sc: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """``h + upsample_nearest(sc, scale)``: the generator blocks' residual add
    (the 1x1 shortcut runs at the low resolution)."""
    return h + upsample_nearest(sc.to(h.dtype), scale)


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.avg_pool2d(x, window, window)


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
    """Sum over the spatial axes of NCHW ``x``."""
    return x.sum(dim=(2, 3))
