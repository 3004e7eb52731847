"""VQ-VAE: an unconditional autoencoder over a discrete code grid (8x8 at
32px). Port of ``mcgm_tpu/models/vqvae.py``.

Two stride-2 4x4 conv stages (hidden [128, 128] at 32px), two residual
blocks and a 3x3 conv to the 64-d embedding space; the EMA vector quantizer
with 512 codes (``ops/vq.py``, whose search and update are the hand-written
kernels of ``kernels/vq.py`` on the card); the mirrored decoder ending in
tanh. Loss ``MSE(recon, img) + 0.25 * commitment``. ``decode_code`` decodes
a grid of codes (the PixelCNN's sampling backend).
"""

from __future__ import annotations

import torch
from torch import nn

from ..evals.metrics import weighted_mean
from ..ops.layers import BatchNorm, ConvTranspose
from ..ops.vq import VectorQuantizerEMA
from .vae import ResBlock, _conv


class _Encoder(nn.Module):
    def __init__(self, data_shape, hs, num_res_block, embedding_size, g):
        super().__init__()
        self.n_stage, self.n_res = len(hs), num_res_block
        chans = (data_shape[-1],) + hs
        for i, h in enumerate(hs):
            setattr(self, f"Conv_{i}", _conv(chans[i], h, 4, 2, 1, g))
            setattr(self, f"BatchNorm_{i}", BatchNorm(h, g))
        for j in range(num_res_block):
            setattr(self, f"ResBlock_{j}", ResBlock(hs[-1], g))
        setattr(self, f"Conv_{len(hs)}", _conv(hs[-1], embedding_size, 3, 1, 1, g))

    def forward(self, x, train: bool):
        for i in range(self.n_stage):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), train).relu()
        for j in range(self.n_res):
            x = getattr(self, f"ResBlock_{j}")(x, train)
        return getattr(self, f"Conv_{self.n_stage}")(x)


class _Decoder(nn.Module):
    def __init__(self, data_shape, hs, num_res_block, embedding_size, g):
        super().__init__()
        self.n_res, self.n_up = num_res_block, len(hs) - 1
        self.Conv_0 = _conv(embedding_size, hs[-1], 3, 1, 1, g)
        self.BatchNorm_0 = BatchNorm(hs[-1], g)
        for j in range(num_res_block):
            setattr(self, f"ResBlock_{j}", ResBlock(hs[-1], g))
        for n, i in enumerate(range(len(hs) - 1, 0, -1)):
            setattr(self, f"ConvTranspose_{n}", ConvTranspose(hs[i], hs[i - 1], generator=g))
            setattr(self, f"BatchNorm_{n + 1}", BatchNorm(hs[i - 1], g))
        setattr(self, f"ConvTranspose_{self.n_up}",
                ConvTranspose(hs[0], data_shape[-1], generator=g))

    def forward(self, x, train: bool):
        x = self.BatchNorm_0(self.Conv_0(x), train).relu()
        for j in range(self.n_res):
            x = getattr(self, f"ResBlock_{j}")(x, train)
        for n in range(self.n_up):
            x = getattr(self, f"BatchNorm_{n + 1}")(getattr(self, f"ConvTranspose_{n}")(x),
                                                     train).relu()
        return torch.tanh(getattr(self, f"ConvTranspose_{self.n_up}")(x))


class VQVAE(nn.Module):
    def __init__(self, data_shape=(32, 32, 3), hidden_size=(128, 128), num_res_block: int = 2,
                 embedding_size: int = 64, num_embedding: int = 512, vq_commit: float = 0.25,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        hs = tuple(hidden_size)
        self.vq_commit, self.compute_dtype = vq_commit, compute_dtype
        g = torch.Generator().manual_seed(seed)
        self.encoder = _Encoder(tuple(data_shape), hs, num_res_block, embedding_size, g)
        self.quantizer = VectorQuantizerEMA(embedding_size, num_embedding, generator=g)
        self.decoder = _Decoder(tuple(data_shape), hs, num_res_block, embedding_size, g)

    def use_plain_kernels(self, plain: bool = True) -> "VQVAE":
        """Route the quantizer's kernels to their plain PyTorch versions,
        on the card too: the reference a run through the kernels is held to."""
        self.quantizer.plain = plain
        return self

    def decode_code(self, code: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Images ``[B,H,W,C]`` in [-1, 1] (f32) decoded from code grids ``[B,h,w]``."""
        q = self.quantizer.embedding_code(code).to(self.compute_dtype)
        return self.decoder(q.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1).float()

    def forward(self, batch: dict, train: bool = False) -> dict:
        """``batch = {"img": [B,H,W,C] in [-1, 1][, "w"]}`` -> ``{"loss",
        "img" (the reconstruction, NHWC f32), "code" (int32 [B,h,w])}``; in
        train mode the quantizer's EMA moves its buffers."""
        x, w = batch["img"], batch.get("w")
        h = self.encoder(x.permute(0, 3, 1, 2).to(self.compute_dtype), train)
        q, diff, code = self.quantizer(h.permute(0, 2, 3, 1), train=train, w=w)
        recon = self.decoder(q.permute(0, 3, 1, 2), train).permute(0, 2, 3, 1).float()
        mse = weighted_mean((recon - x.float()) ** 2, w)
        return {"loss": mse + self.vq_commit * diff, "img": recon, "code": code}
