"""Conditional convolutional VAEs: MCVAE (MultimodalController gating) and
CVAE (class embeddings). Port of ``mcgm_tpu/models/vae.py``.

Images arrive NHWC in [-1, 1] and are mapped to [0, 1] inside ``forward``;
the loss is ``(BCE_sum + KLD) / numel`` in f32; eval uses ``z = mu``;
``generate`` maps the decoder's sigmoid back to [-1, 1]. The encoder is
stride-2 4x4 convolutions (3 at 32px) and residual blocks, then linear
``mu`` / ``logvar`` heads on the features flattened in NHWC order; the
decoder reshapes its Dense output NHWC and mirrors the encoder with
transposed convolutions. Inside, activations are NCHW views of
channels-last memory, as in ``models/gan.py``; submodules carry the flax
names (``Conv_0``, ``MCResBlock_1``, ``MultimodalController_2``, ``mu`` ...)
so ``io.jax_import`` maps variables by name.

In train mode the reparameterisation noise comes from the ``rng``
generator the train step passes (the JAX package's ``reparam`` stream), or
is given as ``eps``. Every conv bias that feeds a BatchNorm is dead (the
batch statistics remove it), as in the JAX package, which keeps them; so
does the port.
"""

from __future__ import annotations

import torch
from torch import nn

from ..evals.metrics import binary_cross_entropy
from ..ops.controller import Seeds, one_hot
from ..ops.layers import BatchNorm, Conv, ConvTranspose, Dense, torch_uniform


def vae_loss(x01, recon, mu, logvar, w=None) -> torch.Tensor:
    """``(BCE_sum + KLD) / numel`` in f32; with a 0/1 mask ``w [B]`` the
    masked rows leave both sums and the count."""
    b = x01.shape[0]
    bce = binary_cross_entropy(recon.float(), x01.float()).reshape(b, -1).sum(1)
    mu, logvar = mu.float(), logvar.float()
    kld = 0.5 * (mu ** 2 + torch.exp(logvar) - 1.0 - logvar).reshape(b, -1).sum(1)
    per = bce + kld
    if w is None:
        return per.sum() / x01.numel()
    w = w.float()
    return (per * w).sum() / (torch.clamp(w.sum(), min=1.0) * (x01.numel() // b))


def _conv(cin, cout, k, s, p, g):
    return Conv(cin, cout, k, s, p, generator=g, kernel_init=torch_uniform)


def _dense(fin, fout, g, bias=True):
    return Dense(fin, fout, bias, generator=g, kernel_init=torch_uniform)


def _nhwc_flat(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _nchw(x, shape):
    """The decoder's Dense output as NHWC ``shape``, viewed NCHW."""
    return x.reshape(x.shape[0], *shape).permute(0, 3, 1, 2)


class MCResBlock(nn.Module):
    """conv-BN-ReLU-MC-conv-BN-MC, plus the input, then ReLU."""

    def __init__(self, hidden: int, num_mode: int, rate: float, seeds: Seeds):
        super().__init__()
        g = seeds.generator
        self.Conv_0 = _conv(hidden, hidden, 3, 1, 1, g)
        self.BatchNorm_0 = BatchNorm(hidden, g)
        self.MultimodalController_0 = seeds.mc(hidden, num_mode, rate)
        self.Conv_1 = _conv(hidden, hidden, 3, 1, 1, g)
        self.BatchNorm_1 = BatchNorm(hidden, g)
        self.MultimodalController_1 = seeds.mc(hidden, num_mode, rate)

    def forward(self, x, indicator, train: bool):
        h = self.BatchNorm_0(self.Conv_0(x), train).relu()
        h = self.MultimodalController_0(h, indicator)
        h = self.BatchNorm_1(self.Conv_1(h), train)
        return (self.MultimodalController_1(h, indicator) + x).relu()


class ResBlock(nn.Module):
    """conv-BN-ReLU-conv-BN, plus the input, then ReLU (CVAE, VQ-VAE)."""

    def __init__(self, hidden: int, generator: torch.Generator):
        super().__init__()
        g = generator
        self.Conv_0 = _conv(hidden, hidden, 3, 1, 1, g)
        self.BatchNorm_0 = BatchNorm(hidden, g)
        self.Conv_1 = _conv(hidden, hidden, 3, 1, 1, g)
        self.BatchNorm_1 = BatchNorm(hidden, g)

    def forward(self, x, train: bool):
        h = self.BatchNorm_0(self.Conv_0(x), train).relu()
        return (self.BatchNorm_1(self.Conv_1(h), train) + x).relu()


class _MCEncoder(nn.Module):
    def __init__(self, data_shape, hs, latent_size, num_res_block, num_mode, rate, seeds):
        super().__init__()
        g = seeds.generator
        self.n_stage, self.n_res = len(hs), num_res_block
        chans = (data_shape[-1],) + hs
        for i, h in enumerate(hs):
            setattr(self, f"Conv_{i}", _conv(chans[i], h, 4, 2, 1, g))
            setattr(self, f"BatchNorm_{i}", BatchNorm(h, g))
            setattr(self, f"MultimodalController_{i}", seeds.mc(h, num_mode, rate))
        for j in range(num_res_block):
            setattr(self, f"MCResBlock_{j}", MCResBlock(hs[-1], num_mode, rate, seeds))
        side = data_shape[0] >> len(hs)
        self.mu = _dense(hs[-1] * side * side, latent_size, g)
        self.logvar = _dense(hs[-1] * side * side, latent_size, g)

    def forward(self, x, indicator, train: bool):
        for i in range(self.n_stage):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), train).relu()
            x = getattr(self, f"MultimodalController_{i}")(x, indicator)
        for j in range(self.n_res):
            x = getattr(self, f"MCResBlock_{j}")(x, indicator, train)
        x = _nhwc_flat(x)
        return self.mu(x), self.logvar(x)


class _MCDecoder(nn.Module):
    """Gates z, then Dense -> BN -> ReLU, reshaped NHWC and gated; the
    residual blocks; transposed-conv stages, each BN -> ReLU -> gate; the
    last transposed conv and a sigmoid."""

    def __init__(self, data_shape, hs, latent_size, num_res_block, num_mode, rate, seeds):
        super().__init__()
        g = seeds.generator
        side = data_shape[0] >> len(hs)
        self.encoded = (side, side, hs[-1])
        self.n_res, self.n_up = num_res_block, len(hs) - 1
        self.MultimodalController_0 = seeds.mc(latent_size, num_mode, rate)
        self.Dense_0 = _dense(latent_size, side * side * hs[-1], g)
        self.BatchNorm_0 = BatchNorm(side * side * hs[-1], g)
        self.MultimodalController_1 = seeds.mc(hs[-1], num_mode, rate)
        for j in range(num_res_block):
            setattr(self, f"MCResBlock_{j}", MCResBlock(hs[-1], num_mode, rate, seeds))
        for n, i in enumerate(range(len(hs) - 1, 0, -1)):
            setattr(self, f"ConvTranspose_{n}", ConvTranspose(hs[i], hs[i - 1], generator=g))
            setattr(self, f"BatchNorm_{n + 1}", BatchNorm(hs[i - 1], g))
            setattr(self, f"MultimodalController_{n + 2}", seeds.mc(hs[i - 1], num_mode, rate))
        setattr(self, f"ConvTranspose_{self.n_up}",
                ConvTranspose(hs[0], data_shape[-1], generator=g))

    def forward(self, z, indicator, train: bool):
        x = self.BatchNorm_0(self.Dense_0(self.MultimodalController_0(z, indicator)),
                             train).relu()
        x = self.MultimodalController_1(_nchw(x, self.encoded), indicator)
        for j in range(self.n_res):
            x = getattr(self, f"MCResBlock_{j}")(x, indicator, train)
        for n in range(self.n_up):
            x = getattr(self, f"BatchNorm_{n + 1}")(getattr(self, f"ConvTranspose_{n}")(x),
                                                     train).relu()
            x = getattr(self, f"MultimodalController_{n + 2}")(x, indicator)
        return torch.sigmoid(getattr(self, f"ConvTranspose_{self.n_up}")(x))


class _CEncoder(nn.Module):
    """The class embedding (a bias-free Dense of the indicator) tiled over
    H x W after the image channels; conv stages and residual blocks."""

    def __init__(self, data_shape, hs, latent_size, num_res_block, num_mode,
                 embedding_size, g):
        super().__init__()
        self.n_stage, self.n_res = len(hs), num_res_block
        self.embedding = _dense(num_mode, embedding_size, g, bias=False)
        chans = (data_shape[-1] + embedding_size,) + hs
        for i, h in enumerate(hs):
            setattr(self, f"Conv_{i}", _conv(chans[i], h, 4, 2, 1, g))
            setattr(self, f"BatchNorm_{i}", BatchNorm(h, g))
        for j in range(num_res_block):
            setattr(self, f"ResBlock_{j}", ResBlock(hs[-1], g))
        side = data_shape[0] >> len(hs)
        self.mu = _dense(hs[-1] * side * side, latent_size, g)
        self.logvar = _dense(hs[-1] * side * side, latent_size, g)

    def forward(self, x, indicator, train: bool):
        emb = self.embedding(indicator.to(x.dtype))
        B, _, H, W = x.shape
        x = torch.cat([x, emb[:, :, None, None].expand(B, -1, H, W)], 1)
        x = x.contiguous(memory_format=torch.channels_last)
        for i in range(self.n_stage):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), train).relu()
        for j in range(self.n_res):
            x = getattr(self, f"ResBlock_{j}")(x, train)
        x = _nhwc_flat(x)
        return self.mu(x), self.logvar(x)


class _CDecoder(nn.Module):
    def __init__(self, data_shape, hs, latent_size, num_res_block, num_mode,
                 embedding_size, g):
        super().__init__()
        side = data_shape[0] >> len(hs)
        self.encoded = (side, side, hs[-1])
        self.n_res, self.n_up = num_res_block, len(hs) - 1
        self.embedding = _dense(num_mode, embedding_size, g, bias=False)
        self.Dense_0 = _dense(latent_size + embedding_size, side * side * hs[-1], g)
        self.BatchNorm_0 = BatchNorm(side * side * hs[-1], g)
        for j in range(num_res_block):
            setattr(self, f"ResBlock_{j}", ResBlock(hs[-1], g))
        for n, i in enumerate(range(len(hs) - 1, 0, -1)):
            setattr(self, f"ConvTranspose_{n}", ConvTranspose(hs[i], hs[i - 1], generator=g))
            setattr(self, f"BatchNorm_{n + 1}", BatchNorm(hs[i - 1], g))
        setattr(self, f"ConvTranspose_{self.n_up}",
                ConvTranspose(hs[0], data_shape[-1], generator=g))

    def forward(self, z, indicator, train: bool):
        x = torch.cat([z, self.embedding(indicator.to(z.dtype))], -1)
        x = _nchw(self.BatchNorm_0(self.Dense_0(x), train).relu(), self.encoded)
        for j in range(self.n_res):
            x = getattr(self, f"ResBlock_{j}")(x, train)
        for n in range(self.n_up):
            x = getattr(self, f"BatchNorm_{n + 1}")(getattr(self, f"ConvTranspose_{n}")(x),
                                                     train).relu()
        return torch.sigmoid(getattr(self, f"ConvTranspose_{self.n_up}")(x))


class _VAEBase(nn.Module):
    """What MCVAE and CVAE share, and what the train step, the sampler and
    the workflows use: ``encoder`` / ``decoder``, ``latent_size``,
    ``num_mode``, ``compute_dtype`` and, for a created sampler,
    ``sampling_module`` (the decoder)."""

    sampling_module = "decoder"

    def _indicator(self, C):
        return one_hot(C, self.num_mode).to(self.decoder.Dense_0.weight.device)

    def forward(self, batch: dict, train: bool = False, rng: torch.Generator | None = None,
                eps: torch.Tensor | None = None) -> dict:
        """``batch = {"img": [B,H,W,C] in [-1, 1], "label": [B][, "w"]}`` ->
        ``{"loss", "img" (the reconstruction in [-1, 1], NHWC f32), "mu",
        "logvar"}``. In train mode ``z = mu + eps * exp(logvar / 2)`` with
        ``eps`` as given or drawn from ``rng``."""
        x01 = (batch["img"].float() + 1.0) / 2.0
        indicator = self._indicator(batch["label"])
        mu, logvar = self.encoder(x01.permute(0, 3, 1, 2).to(self.compute_dtype), indicator,
                                  train)
        if train:
            if eps is None:
                if rng is None:
                    raise ValueError("a VAE in train mode needs eps or an rng generator")
                eps = torch.randn(mu.shape, generator=rng, device=rng.device)
            z = mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * logvar)
        else:
            z = mu
        recon = self.decoder(z, indicator, train).permute(0, 2, 3, 1).float()
        loss = vae_loss(x01, recon, mu, logvar, batch.get("w"))
        return {"loss": loss, "img": recon * 2.0 - 1.0, "mu": mu.float(),
                "logvar": logvar.float()}

    def generate(self, C: torch.Tensor, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Images ``[B,H,W,C]`` in [-1, 1] decoded from latents ``z`` for modes ``C``."""
        x = self.decoder(z.to(self.compute_dtype), self._indicator(C), train)
        return x.permute(0, 2, 3, 1).float() * 2.0 - 1.0


class MCVAE(_VAEBase):
    def __init__(self, data_shape=(32, 32, 3), hidden_size=(64, 128, 256), latent_size: int = 128,
                 num_res_block: int = 2, num_mode: int = 10, controller_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        hs = tuple(hidden_size)
        self.latent_size, self.num_mode, self.compute_dtype = latent_size, num_mode, compute_dtype
        seeds = Seeds(torch.Generator().manual_seed(seed))
        self.encoder = _MCEncoder(tuple(data_shape), hs, latent_size, num_res_block, num_mode,
                                  controller_rate, seeds)
        self.decoder = _MCDecoder(tuple(data_shape), hs, latent_size, num_res_block, num_mode,
                                  controller_rate, seeds)


class CVAE(_VAEBase):
    """The embedding-conditioned baseline: the class embedding is tiled as
    extra input channels of the encoder and concatenated to z for the
    decoder (each side has its own)."""

    def __init__(self, data_shape=(32, 32, 3), hidden_size=(64, 128, 256), latent_size: int = 128,
                 num_res_block: int = 2, num_mode: int = 10, embedding_size: int = 32,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        hs = tuple(hidden_size)
        self.latent_size, self.num_mode, self.compute_dtype = latent_size, num_mode, compute_dtype
        g = torch.Generator().manual_seed(seed)
        self.encoder = _CEncoder(tuple(data_shape), hs, latent_size, num_res_block, num_mode,
                                 embedding_size, g)
        self.decoder = _CDecoder(tuple(data_shape), hs, latent_size, num_res_block, num_mode,
                                 embedding_size, g)
