"""NN building blocks of the GAN, VAE and PixelCNN paths, ported from
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

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import int8 as kint8
from . import quant

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

    ``slices`` (set through :func:`batch_stat_slices`): the batch is that
    many equal slices, each normalised by its own statistics, and the
    running ones move once per slice in order, as that many calls in a row
    would move them (the JAX package's vmapped G pass and its
    ``_chain_batch_stats``).
    """

    moves_buffers = True  # the running statistics, in training

    def __init__(self, features: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(bn_scale(features, generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.slices = 1

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train and self.slices > 1:
            return self._sliced(xf).to(x.dtype)
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

    def _sliced(self, xf: torch.Tensor) -> torch.Tensor:
        k = self.slices
        xs = xf.reshape(k, xf.shape[0] // k, *xf.shape[1:])
        dims = [d for d in range(xs.ndim) if d not in (0, 2)]
        mean = xs.mean(dims)
        var = xs.var(dims, unbiased=False)
        with torch.no_grad():
            for i in range(k):
                self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean[i])
                self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var[i])
        shape = (k, 1, -1) + (1,) * (xf.ndim - 2)
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        y = ((xs - mean.reshape(shape)) * scale.reshape(shape)
             + self.bias.reshape((1, 1, -1) + (1,) * (xf.ndim - 2)))
        return y.reshape(xf.shape)


@contextlib.contextmanager
def batch_stat_slices(module: nn.Module, k: int):
    """While open, every ``BatchNorm`` in ``module`` takes its batch as
    ``k`` slices with their own statistics (see ``BatchNorm``)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.slices = k
    try:
        yield
    finally:
        for m in bns:
            m.slices = 1


def _bias(b, x):
    return None if b is None else b.to(x.dtype)


class Conv(quant.Int8Site):
    """2D conv, xavier kernel, torch-uniform bias.

    ``kernel_size`` is an int or ``(kh, kw)``; ``padding`` an int or
    ``((top, bottom), (left, right))``. ``kernel_mask`` (the PixelCNN's
    causal mask, ``[kh, kw]`` or the JAX package's ``[kh, kw, 1, 1]``) is a
    constant buffer the weight is multiplied by at apply: the weight itself
    is stored unmasked, as in the JAX package, so masked taps get no
    gradient and the import in either direction is the identity. The mask
    is not part of the ``state_dict``. Under ``quant.int8_serving`` a conv
    of stride 1 runs int8 (``quant.int8_apply``).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride: int = 1,
                 padding=0, bias: bool = True, generator=None,
                 kernel_init=xavier_uniform, kernel_mask=None):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(kernel_init(
            (out_ch, in_ch, kh, kw), in_ch * kh * kw, out_ch * kh * kw, generator))
        self.bias = (nn.Parameter(torch_bias(out_ch, in_ch * kh * kw, generator))
                     if bias else None)
        if kernel_mask is not None:
            kernel_mask = torch.as_tensor(kernel_mask, dtype=torch.float32).reshape(1, 1, kh, kw)
        self.register_buffer("kernel_mask", kernel_mask, persistent=False)

    def masked_weight(self) -> torch.Tensor:
        return self.weight if self.kernel_mask is None else self.weight * self.kernel_mask

    def int8_spec(self):
        if self.stride != 1 or not isinstance(self.padding, int):
            raise NotImplementedError("int8 serving: a Conv of stride 1 and one padding only")
        kh, kw = self.weight.shape[2:]
        return kint8.DIRECT, kint8.pack_direct(self.masked_weight()), kh, kw, self.padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quantized and quant.int8_mode():
            y = quant.int8_apply(self, x, self.bias)
            if y is not None:
                return y
        pad = self.padding
        if not isinstance(pad, int):
            (top, bottom), (left, right) = pad
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        return F.conv2d(x, self.masked_weight().to(x.dtype), _bias(self.bias, x),
                        self.stride, pad)


class Embed(nn.Module):
    """A lookup table ``[num, features]`` with flax ``nn.Embed``'s init,
    ``N(0, 1 / features)``."""

    def __init__(self, num: int, features: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((num, features), generator=generator)
                                   / math.sqrt(features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx.long()]


class UpsampledConv(Conv):
    """``conv3x3(pad 1)(nearest_up2(x))``; the parameters of a 3x3 ``Conv``.
    Int8 serving quantizes the composite 4x4 kernel of the JAX package's
    ``lhs_dilation`` form (``quant.up4_kernel``) and runs it on ``x`` itself."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True, generator=None):
        super().__init__(in_ch, out_ch, 3, 1, 1, bias, generator)

    def int8_spec(self):
        w4 = quant.up4_kernel(self.weight).permute(2, 3, 1, 0)  # HWIO
        return kint8.UP2, kint8.pack_up2(w4), 4, 4, 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.int8_mode():
            y = quant.int8_apply(self, x, self.bias)
            if y is not None:
                return y
        return F.conv2d(upsample_nearest(x, 2), self.weight.to(x.dtype), _bias(self.bias, x),
                        1, 1)


class ConvS2D(Conv):
    """The generators' image head: conv3x3 (pad 1) with bias. The JAX
    package lowers it space-to-depth for TPU lane fill; the math is this.
    It has no int8 branch: the image head stays full precision."""

    quantized = False

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__(in_ch, out_ch, 3, 1, 1, True, generator)


class ConvTranspose(quant.Int8Site):
    """torch ``ConvTranspose2d(k=4, s=2, p=1)``: output side ``(H-1)s - 2p + k``.

    The weight is torch's ``[in, out, k, k]``; the JAX package stores the
    kernel HWIO ``[k, k, in, out]`` and flips it for ``lax.conv_transpose``,
    so the port's weight is that kernel transposed (2, 3, 0, 1), unflipped.
    Kernel and bias take torch's uniform init over ``in * k * k``. Int8
    serving (k 4, s 2, p 1) quantizes the flipped kernel of that lhs-dilated
    conv, per output channel (torch's axis 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1, generator=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch_uniform((in_ch, out_ch, k, k), in_ch * k * k,
                                                 out_ch * k * k, generator))
        self.bias = nn.Parameter(torch_bias(out_ch, in_ch * k * k, generator))

    def int8_spec(self):
        if (self.weight.shape[2], self.stride, self.padding) != (4, 2, 1):
            raise NotImplementedError("int8 serving: a ConvTranspose of k 4, s 2, p 1 only")
        w4 = self.weight.flip(2, 3).permute(2, 3, 0, 1)  # the flipped HWIO kernel
        return kint8.UP2, kint8.pack_up2(w4), 4, 4, 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.int8_mode():
            y = quant.int8_apply(self, x, self.bias)
            if y is not None:
                return y
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _bias(self.bias, x),
                                  self.stride, self.padding)


class Dense(quant.Int8Site):
    def __init__(self, in_f: int, out_f: int, bias: bool = True, generator=None,
                 kernel_init=xavier_uniform):
        super().__init__()
        self.weight = nn.Parameter(kernel_init((out_f, in_f), in_f, out_f, generator))
        self.bias = nn.Parameter(torch_bias(out_f, in_f, generator)) if bias else None

    def int8_spec(self):
        return kint8.DIRECT, self.weight, 1, 1, 0  # a 1x1 conv on a 1x1 image

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.int8_mode():
            y = quant.int8_apply(self, x, self.bias)
            if y is not None:
                return y
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

    moves_buffers = True  # ``u``, in training

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
