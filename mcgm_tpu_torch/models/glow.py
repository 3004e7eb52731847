"""Multi-scale Glow: MCGlow (MC-gated coupling nets) and CGlow (a class
embedding on the last prior). Port of ``mcgm_tpu/models/glow.py``.

- per flow: ActNorm (data-dependent init through ``ddi=True``), the
  LU-parameterised invertible 1x1 conv (fixed ``w_p`` and ``s_sign`` in
  buffers, trainable ``w_l``, ``w_s``, ``w_u``; the weight recomposed in
  f32, ``inv(weight)`` in f32 for the reverse pass), the affine coupling
  ``s = sigmoid(log_s + 2)`` with ``log_s`` the first half of the net's
  channels and a per-sample logdet;
- per block: the 2x squeeze (channel ``j = c*4 + a*2 + b``, the JAX
  package's order, so imported weights meet their channels), K flows, and a
  split prior (``ZeroConv2d`` of the kept half) but for the last block,
  whose prior is ``ZeroConv2d`` of zeros, to which CGlow adds a zero-init
  1x1 ``ZeroConv2d`` of the one-hot;
- loss: bits/dim of ``x*0.5 + U/256`` (``U`` from the caller's
  ``torch.Generator``, or handed in as ``noise``); non-finite rows are
  zeroed in training and dropped in eval, with the ``w`` padding mask;
- ``reverse`` / ``generate``: the per-level z cascade, clamped to
  [-0.5, 0.5] * 2.

The coupling net is conv3x3 -> ActNorm -> ReLU -> [MC], then the gated 1x1:
conv1x1 -> ActNorm -> ReLU -> [MC] is ``act(x @ w * alpha + beta) * code``
with ``alpha = scale`` and ``beta = scale * (bias + loc)``, one call of
``kernels.mc_gate.mc_gated_matmul`` (CGlow: without the gate), then
``ZeroConv2d``: 16 flows x 3 levels = 48 launches per forward at the
CIFAR10 width, in training, eval and every reverse pass (with
``remat_flows`` a train step runs each flow's forward twice). In a ``ddi``
forward the 1x1 is a plain product, since ActNorm needs its output's
statistics. ``use_plain_kernels()`` routes the 1x1 to the plain version,
on the card too.

Activations are NCHW; the public functions take and return the JAX layout
(images and z ``[B, H, W, C]``). Convs take the model's compute dtype
(bf16 on the card, f32 on the CPU), as the JAX ``Conv`` casts its operands;
the flows' carry, ActNorm, the invconv, the logdets and the likelihood are
f32. ``remat_flows`` checkpoints each flow (``torch.utils.checkpoint``): the
same math, the forward recomputed in the backward pass. ``reversible_flows``
(the JAX package's rule: ``scan_flows`` with ``scan_chunk=1``, no pipeline
axis) runs each block's flows in training through ``ops.reversible``, whose
backward rebuilds every flow's input from its output and runs each coupling
net once more (48 more launches a step, as with ``remat_flows``, which it
takes the place of). ``scan_flows`` and ``scan_chunk`` only say how the
flows' variables are packed in the JAX layout (``io.jax_import``);
``scan_unroll`` is an XLA loop setting with no counterpart here. A pipeline
axis is refused.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.mc_gate import mc_gated_matmul, mc_gated_matmul_reference
from ..ops.controller import Seeds, one_hot
from ..ops.layers import Conv
from ..ops.reversible import reversible_flows


def gaussian_log_p(x, mean, log_sd):
    return -0.5 * math.log(2 * math.pi) - log_sd - 0.5 * (x - mean) ** 2 / torch.exp(2 * log_sd)


def gaussian_sample(eps, mean, log_sd):
    return mean + torch.exp(log_sd) * eps


def squeeze2(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth by 2, NCHW: channel ``c*4 + a*2 + b`` holds channel
    ``c`` at spatial phase ``(a, b)``."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def unsqueeze2(x: torch.Tensor) -> torch.Tensor:
    b, c4, h, w = x.shape
    x = x.reshape(b, c4 // 4, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, c4 // 4, 2 * h, 2 * w)


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def _normal05(shape, fan_in, fan_out, generator=None):
    return 0.05 * torch.randn(shape, generator=generator)


def _zeros(shape, fan_in, fan_out, generator=None):
    return torch.zeros(shape)


class ActNorm(nn.Module):
    """Per-channel ``scale * (x + loc)``; with ``ddi=True`` ``loc = -mean``
    and ``scale = 1 / (std(ddof=1) + 1e-6)`` over every axis but the
    channels are set from ``x`` first. The flow's ActNorm also returns its
    logdet ``H * W * sum(log|scale|)`` (a scalar)."""

    jax_names = {"loc": ("params", "loc"), "scale": ("params", "scale")}

    def __init__(self, features: int, logdet: bool = True):
        super().__init__()
        self.logdet = logdet
        self.loc = nn.Parameter(torch.zeros(features))
        self.scale = nn.Parameter(torch.ones(features))

    def init_from(self, x: torch.Tensor) -> None:
        with torch.no_grad():
            xf = x.float()
            self.loc.copy_(-xf.mean((0, 2, 3)))
            self.scale.copy_(1.0 / (xf.std((0, 2, 3), correction=1) + 1e-6))

    def forward(self, x, ddi: bool = False):
        if ddi:
            self.init_from(x)
        out = _channels(self.scale) * (x + _channels(self.loc))
        if not self.logdet:
            return out
        return out, x.shape[2] * x.shape[3] * torch.log(self.scale.abs()).sum()

    def reverse(self, y):
        return y / _channels(self.scale) - _channels(self.loc)


def _channel_product(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[b, o] = sum_i w[o, i] x[b, i]`` over NCHW ``x``, f32 (cuBLAS,
    not a cuDNN conv, which may run TF32)."""
    b, c, h, wd = x.shape
    return torch.matmul(w, x.reshape(b, c, h * wd)).reshape(b, -1, h, wd)


def _decompose_init(features: int, generator, lu: bool):
    """The invconvs' initial factors: QR (then LU) of a seeded random matrix,
    taken on one CPU thread (the thread count is restored after): LAPACK's
    blocked QR and LU of a 48-wide or wider matrix round otherwise on
    another thread count, so a seed would not give one set of weights."""
    a = torch.randn((features, features), generator=generator)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        q, _ = torch.linalg.qr(a)
        return torch.linalg.lu(q) if lu else q
    finally:
        torch.set_num_threads(threads)


class InvConv2dLU(nn.Module):
    """``weight = w_p @ (L + I) @ (U + diag(s_sign * exp(w_s)))`` from one
    QR + LU of a random matrix; logdet ``H * W * sum(w_s)``."""

    jax_names = {"w_l": ("params", "w_l"), "w_s": ("params", "w_s"),
                 "w_u": ("params", "w_u"), "w_p": ("glow_const", "const", "w_p"),
                 "s_sign": ("glow_const", "const", "s_sign")}

    def __init__(self, features: int, generator=None):
        super().__init__()
        p, lower, upper = _decompose_init(features, generator, lu=True)
        s = torch.diagonal(upper)
        self.register_buffer("w_p", p.contiguous())
        self.register_buffer("s_sign", torch.sign(s))
        self.w_l = nn.Parameter(lower.contiguous())
        self.w_s = nn.Parameter(torch.log(s.abs()))
        self.w_u = nn.Parameter(torch.triu(upper, 1))
        self.register_buffer("l_mask", torch.tril(torch.ones(features, features), -1),
                             persistent=False)

    def weight(self) -> torch.Tensor:
        eye = torch.eye(self.w_s.shape[0], device=self.w_s.device)
        return self.w_p @ (self.w_l * self.l_mask + eye) @ (
            self.w_u * self.l_mask.T + torch.diag(self.s_sign * torch.exp(self.w_s)))

    def forward(self, x):
        return (_channel_product(self.weight(), x),
                x.shape[2] * x.shape[3] * self.w_s.sum())

    def reverse(self, y):
        return _channel_product(torch.linalg.inv(self.weight()), y)


class InvConv2d(nn.Module):
    """The plain invertible 1x1 conv (``conv_lu=False``): a QR-initialised
    weight, f32 ``slogdet``."""

    jax_names = {"weight": ("params", "weight")}

    def __init__(self, features: int, generator=None):
        super().__init__()
        q = _decompose_init(features, generator, lu=False)
        self.weight = nn.Parameter(q.contiguous())

    def forward(self, x):
        return (_channel_product(self.weight, x),
                x.shape[2] * x.shape[3] * torch.linalg.slogdet(self.weight)[1])

    def reverse(self, y):
        return _channel_product(torch.linalg.inv(self.weight), y)


class ZeroConv2d(nn.Module):
    """Zero-init conv whose output is scaled by ``exp(3 * scale)`` (f32)."""

    jax_names = {"scale": ("params", "scale")}

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3, padding: int = 1,
                 generator=None):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel_size, 1, padding, generator=generator,
                         kernel_init=_zeros)
        with torch.no_grad():
            self.conv.bias.zero_()
        self.scale = nn.Parameter(torch.zeros(features))

    def forward(self, x, dtype):
        return self.conv(x.to(dtype)) * _channels(torch.exp(self.scale * 3.0))


class CouplingNet(nn.Module):
    """conv3x3 -> ActNorm -> ReLU -> [MC] -> the gated 1x1 -> ZeroConv2d."""

    def __init__(self, in_ch: int, out_size: int, hidden: int, num_mode, rate, g,
                 seeds: Seeds):
        super().__init__()
        self.mc = num_mode is not None
        self.Conv_0 = Conv(in_ch, hidden, 3, 1, 1, generator=g, kernel_init=_normal05)
        self.ActNorm_0 = ActNorm(hidden, logdet=False)
        self.Conv_1 = Conv(hidden, hidden, 1, 1, 0, generator=g, kernel_init=_normal05)
        self.ActNorm_1 = ActNorm(hidden, logdet=False)
        with torch.no_grad():
            self.Conv_0.bias.zero_()
            self.Conv_1.bias.zero_()
        if self.mc:
            self.MultimodalController_0 = seeds.mc(hidden, num_mode, rate)
            self.MultimodalController_1 = seeds.mc(hidden, num_mode, rate)
        self.ZeroConv2d_0 = ZeroConv2d(hidden, out_size, generator=g)

    def _gated_1x1(self, h, indicator, dtype, plain: bool) -> torch.Tensor:
        """conv1x1 -> ActNorm -> ReLU -> [MC] as one ``mc_gated_matmul``."""
        B, C, H, W = h.shape
        an, conv = self.ActNorm_1, self.Conv_1
        alpha = an.scale
        beta = an.scale * (conv.bias + an.loc)
        w = conv.weight.reshape(conv.weight.shape[0], C).to(dtype)
        ind, cb = ((indicator, self.MultimodalController_1.codebook) if self.mc
                   else (None, None))
        fn = mc_gated_matmul_reference if plain else mc_gated_matmul
        out = fn(h.to(dtype).contiguous().reshape(B, C, H * W), w, alpha, beta, ind, cb, True)
        return out.reshape(B, -1, H, W)

    def forward(self, x, indicator, dtype, ddi: bool = False, plain: bool = False):
        h = self.ActNorm_0(self.Conv_0(x.to(dtype)), ddi).relu()
        if self.mc:
            h = self.MultimodalController_0(h, indicator)
        if ddi:
            h = self.ActNorm_1(self.Conv_1(h.to(dtype)), True).relu()
            if self.mc:
                h = self.MultimodalController_1(h, indicator)
        else:
            h = self._gated_1x1(h, indicator, dtype, plain)
        return self.ZeroConv2d_0(h, dtype)


class AffineCoupling(nn.Module):
    def __init__(self, channels: int, hidden: int, affine: bool, num_mode, rate, g,
                 seeds: Seeds):
        super().__init__()
        self.affine = affine
        self.net = CouplingNet(channels // 2, channels if affine else channels // 2, hidden,
                               num_mode, rate, g, seeds)

    def forward(self, x, indicator, dtype, ddi: bool = False, plain: bool = False):
        in_a, in_b = x.chunk(2, 1)
        h = self.net(in_a, indicator, dtype, ddi, plain)
        if not self.affine:
            return torch.cat([in_a, in_b + h], 1), None
        log_s, t = h.chunk(2, 1)
        s = torch.sigmoid(log_s + 2.0)
        out_b = (in_b + t) * s
        return torch.cat([in_a, out_b], 1), torch.log(s).reshape(x.shape[0], -1).sum(1)

    def reverse(self, y, indicator, dtype, plain: bool = False):
        out_a, out_b = y.chunk(2, 1)
        h = self.net(out_a, indicator, dtype, plain=plain)
        if not self.affine:
            return torch.cat([out_a, out_b - h], 1)
        log_s, t = h.chunk(2, 1)
        return torch.cat([out_a, out_b / torch.sigmoid(log_s + 2.0) - t], 1)


class Flow(nn.Module):
    def __init__(self, channels: int, hidden: int, affine: bool, conv_lu: bool, num_mode,
                 rate, g, seeds: Seeds):
        super().__init__()
        self.actnorm = ActNorm(channels)
        self.invconv = (InvConv2dLU if conv_lu else InvConv2d)(channels, g)
        self.coupling = AffineCoupling(channels, hidden, affine, num_mode, rate, g, seeds)

    def forward(self, x, indicator, dtype, ddi: bool = False, plain: bool = False):
        out, logdet = self.actnorm(x, ddi)
        out, det1 = self.invconv(out)
        out, det2 = self.coupling(out, indicator, dtype, ddi, plain)
        logdet = logdet + det1
        return out, (logdet if det2 is None else logdet + det2)

    def reverse(self, y, indicator, dtype, plain: bool = False):
        x = self.coupling.reverse(y, indicator, dtype, plain)
        return self.actnorm.reverse(self.invconv.reverse(x))


class Block(nn.Module):
    """Squeeze, K flows ``flow_0 ..``, and the prior."""

    def __init__(self, in_ch: int, hidden: int, K: int, split: bool, affine: bool,
                 conv_lu: bool, num_mode, rate, cond_prior: bool, cond_modes: int, g,
                 seeds: Seeds):
        super().__init__()
        sq = in_ch * 4
        self.K, self.split, self.cond_prior = K, split, cond_prior
        for i in range(K):
            setattr(self, f"flow_{i}", Flow(sq, hidden, affine, conv_lu, num_mode, rate, g,
                                            seeds))
        self.prior = (ZeroConv2d(in_ch * 2, in_ch * 4, generator=g) if split
                      else ZeroConv2d(in_ch * 4, in_ch * 8, generator=g))
        if cond_prior:
            self.embedding = ZeroConv2d(cond_modes, in_ch * 8, 1, 0, generator=g)

    def flows(self) -> list:
        return [getattr(self, f"flow_{i}") for i in range(self.K)]

    def _prior_h(self, like, indicator, dtype):
        h = self.prior(torch.zeros_like(like), dtype)
        if self.cond_prior:
            h = h + self.embedding(indicator[:, :, None, None], dtype)
        return h

    def forward(self, x, indicator, dtype, ddi: bool = False, plain: bool = False,
                remat: bool = False, reversible: bool = False):
        b = x.shape[0]
        out = squeeze2(x)
        logdet = torch.zeros((b,), device=x.device)
        grad = not ddi and torch.is_grad_enabled()
        if reversible and grad:
            out, logdet = reversible_flows(self.flows(), out, indicator, dtype, plain)
        else:
            for flow in self.flows():
                if remat and grad:
                    out, det = checkpoint(flow, out, indicator, dtype, False, plain,
                                          use_reentrant=False)
                else:
                    out, det = flow(out, indicator, dtype, ddi, plain)
                logdet = logdet + det
        if self.split:
            out, z_new = out.chunk(2, 1)
            mean, log_sd = self.prior(out, dtype).chunk(2, 1)
            log_p = gaussian_log_p(z_new, mean, log_sd)
        else:
            mean, log_sd = self._prior_h(out, indicator, dtype).chunk(2, 1)
            log_p = gaussian_log_p(out, mean, log_sd)
            z_new = out
        return out, logdet, log_p.reshape(b, -1).sum(1), z_new

    def reverse(self, y, indicator, eps, reconstruct: bool, dtype, plain: bool = False):
        if reconstruct:
            x = torch.cat([y, eps], 1) if self.split else eps
        elif self.split:
            mean, log_sd = self.prior(y, dtype).chunk(2, 1)
            x = torch.cat([y, gaussian_sample(eps, mean, log_sd)], 1)
        else:
            mean, log_sd = self._prior_h(y, indicator, dtype).chunk(2, 1)
            x = gaussian_sample(eps, mean, log_sd)
        for flow in self.flows()[::-1]:
            x = flow.reverse(x, indicator, dtype, plain)
        return unsqueeze2(x)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class _GlowBase(nn.Module):
    def _build(self, data_shape, hidden_size, K, L, affine, conv_lu, num_mode, rate,
               compute_dtype, seed, scan_flows, scan_chunk, remat_flows, scan_unroll,
               reversible_flows, pipe_axis):
        if reversible_flows:
            if not scan_flows or scan_chunk != 1:
                raise ValueError("reversible_flows requires scan_flows=True with "
                                 "scan_chunk=1 (it operates on the flat [K, ...] flow "
                                 "packing)")
            if pipe_axis is not None:
                raise ValueError("reversible_flows and pipe_axis are mutually exclusive "
                                 "(the pipeline is its own scan executor)")
        if pipe_axis is not None:
            raise NotImplementedError("a pipeline axis over the flows is not ported "
                                      "(ROADMAP Queue A item 12)")
        if scan_flows and scan_chunk > 1 and K % scan_chunk:
            raise ValueError(f"scan_chunk={scan_chunk} must divide K={K}")
        del scan_unroll  # an XLA loop setting: eager PyTorch has no counterpart
        g = torch.Generator().manual_seed(seed)
        seeds = Seeds(g)
        self.data_shape, self.hidden_size, self.K, self.L = tuple(data_shape), hidden_size, K, L
        self.num_mode, self.compute_dtype = num_mode, compute_dtype
        self.scan_flows, self.scan_chunk = bool(scan_flows), int(scan_chunk)
        self.remat_flows, self.plain = bool(remat_flows), False
        self.reversible_flows = bool(reversible_flows)
        c = data_shape[-1]
        mc = (num_mode, rate) if rate is not None else (None, None)
        for i in range(L):
            last = i == L - 1
            setattr(self, f"block_{i}", Block(c, hidden_size, K, not last, affine, conv_lu,
                                              *mc, last and rate is None, num_mode, g, seeds))
            c *= 2

    def blocks(self) -> list:
        return [getattr(self, f"block_{i}") for i in range(self.L)]

    def use_plain_kernels(self, plain: bool = True):
        """Route the coupling nets' gated 1x1 to its plain version, on the
        card too: the reference a run through the kernel is held to."""
        self.plain = plain
        return self

    def loss_fn(self, log_p, logdet, train: bool, w=None):
        """bits/dim per sample, then the batch mean: non-finite rows zeroed
        in training (without a mask), else dropped with the padded rows; all
        of them dropped gives NaN."""
        n_pixel = float(np.prod(self.data_shape))
        loss = -math.log(256.0) * n_pixel + logdet + log_p
        loss = -loss / (math.log(2.0) * n_pixel)
        bad = ~torch.isfinite(loss)
        if w is not None:
            bad = bad | (w <= 0)
        kept = torch.where(bad, torch.zeros_like(loss), loss)
        if train and w is None:
            return kept.mean()
        ok = (~bad).sum()
        mean = kept.sum() / ok.clamp(min=1)
        return torch.where(ok > 0, mean, torch.full_like(mean, float("nan")))

    def forward(self, batch: dict, train: bool = False, ddi: bool = False,
                rng: torch.Generator | None = None, noise: torch.Tensor | None = None) -> dict:
        """``batch = {"img": [B, H, W, C] in [-1, 1], "label": [B][, "w"]}`` ->
        ``{"loss": bits/dim, "z": per level [B, h, w, c]}``. The
        dequantisation noise ``U [B, H, W, C]`` is ``noise`` or drawn from
        ``rng``."""
        img = batch["img"].float()
        if noise is None:
            if rng is None:
                raise ValueError("a Glow forward needs noise or an rng generator")
            noise = torch.rand(img.shape, generator=rng, device=rng.device)
        indicator = one_hot(batch["label"], self.num_mode)
        x = _nchw(img * 0.5 + noise.to(img.device, torch.float32) / 256.0)
        z_list = []
        log_p_sum = torch.zeros((x.shape[0],), device=x.device)
        logdet = torch.zeros((), device=x.device)
        remat, reversible = self.remat_flows and train, self.reversible_flows and train
        for block in self.blocks():
            x, det, log_p, z_new = block(x, indicator, self.compute_dtype, ddi, self.plain,
                                         remat, reversible)
            z_list.append(_nhwc(z_new))
            logdet = logdet + det
            log_p_sum = log_p_sum + log_p
        return {"loss": self.loss_fn(log_p_sum, logdet, train, batch.get("w")), "z": z_list}

    def reverse(self, z_list, C, reconstruct: bool = False) -> torch.Tensor:
        """Images ``[B, H, W, C]`` from the per-level z (JAX layout),
        clamped to [-1, 1]."""
        dev = self.block_0.prior.scale.device
        indicator = one_hot(torch.as_tensor(C, device=dev), self.num_mode)
        z = [_nchw(t.to(dev, torch.float32)) for t in z_list]
        x = None
        for i, block in enumerate(self.blocks()[::-1]):
            eps = z[self.L - 1 - i]
            x = block.reverse(eps if i == 0 else x, indicator, eps, reconstruct,
                              self.compute_dtype, self.plain)
        return _nhwc(torch.clamp(x, -0.5, 0.5) * 2.0)

    def make_z_shapes(self) -> list:
        """Per-level latent shapes, ``(h, w, c)``."""
        h, w, c = self.data_shape
        shapes = []
        for _ in range(self.L - 1):
            h, w, c = h // 2, w // 2, c * 2
            shapes.append((h, w, c))
        shapes.append((h // 2, w // 2, c * 4))
        return shapes

    def sample_z(self, n: int, generator: torch.Generator, temperature: float = 1.0) -> list:
        """One normal ``[n, h, w, c]`` per level, in level order."""
        return [torch.randn((n, *s), generator=generator, device=generator.device) * temperature
                for s in self.make_z_shapes()]

    @torch.no_grad()
    def generate(self, C, z=None, temperature: float = 1.0,
                 rng: torch.Generator | None = None) -> torch.Tensor:
        if z is None:
            z = self.sample_z(len(C), rng, temperature)
        return self.reverse(z, C, reconstruct=False)


class MCGlow(_GlowBase):
    def __init__(self, data_shape=(32, 32, 3), hidden_size: int = 512, K: int = 16, L: int = 3,
                 affine: bool = True, conv_lu: bool = True, num_mode: int = 10,
                 controller_rate: float = 0.5, compute_dtype: torch.dtype = torch.float32,
                 seed: int = 0, scan_flows: bool = True, scan_chunk: int = 1,
                 remat_flows: bool = True, scan_unroll: int = 1,
                 reversible_flows: bool = False, pipe_axis=None):
        super().__init__()
        self._build(data_shape, hidden_size, K, L, affine, conv_lu, num_mode,
                    controller_rate, compute_dtype, seed, scan_flows, scan_chunk, remat_flows,
                    scan_unroll, reversible_flows, pipe_axis)


class CGlow(_GlowBase):
    """Unconditional flows; the one-hot enters only through a zero-init 1x1
    ``ZeroConv2d`` added to the last block's prior."""

    def __init__(self, data_shape=(32, 32, 3), hidden_size: int = 512, K: int = 16, L: int = 3,
                 affine: bool = True, conv_lu: bool = True, num_mode: int = 10,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0,
                 scan_flows: bool = True, scan_chunk: int = 1, remat_flows: bool = True,
                 scan_unroll: int = 1, reversible_flows: bool = False, pipe_axis=None):
        super().__init__()
        self._build(data_shape, hidden_size, K, L, affine, conv_lu, num_mode, None,
                    compute_dtype, seed, scan_flows, scan_chunk, remat_flows, scan_unroll,
                    reversible_flows, pipe_axis)
