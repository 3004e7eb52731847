"""SNGAN-style conditional GANs: MCGAN (MultimodalController gating) and
CGAN (class embeddings). Port of ``mcgm_tpu/models/gan.py``.

Submodules carry the flax module names of the JAX package (``Conv_0``,
``BatchNorm_1``, ``mc_1``, ``SNConv_2`` ...), so a reader finds the
counterpart and ``io.jax_import`` maps variables by name. Public methods take
and return NHWC images; inside, activations are NCHW views of channels-last
memory, so the first discriminator block hands its kernel an NHWC tensor
without a copy.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.first_dblock import first_dblock, first_dblock_reference
from ..ops.controller import MultimodalController, mode_code, one_hot
from ..ops.layers import (
    BatchNorm, Conv, ConvS2D, Dense, SNConv, SNConvPool, SNDense, UpsampledConv,
    add_upsampled_nearest, avg_pool, global_sum_pool,
)


class _Seeds:
    """Draws one codebook seed per controller from the model's generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def mc(self, features: int, num_mode: int, rate: float) -> MultimodalController:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator))
        return MultimodalController(features, num_mode, rate, seed)


class _MCGenResBlock(nn.Module):
    """Stride-2 generator block. The MC gate commutes with nearest upsample,
    so it gates at low resolution; the 1x1 shortcut runs at low resolution
    and is upsampled into the residual add. Conv_0's bias is dead (its output
    feeds BatchNorm_1), and so are Conv_1's and Conv_2's in the last block
    (they feed the head BatchNorm): the JAX package drops them, and so does
    the port."""

    def __init__(self, input_size: int, output_size: int, num_mode: int,
                 controller_rate: float, seeds: _Seeds, tail_bias_free: bool = False):
        super().__init__()
        g = seeds.generator
        self.mc_1 = seeds.mc(input_size, num_mode, controller_rate)
        self.mc_2 = seeds.mc(output_size, num_mode, controller_rate)
        self.BatchNorm_0 = BatchNorm(input_size, g)
        self.Conv_0 = UpsampledConv(input_size, output_size, bias=False, generator=g)
        self.BatchNorm_1 = BatchNorm(output_size, g)
        self.Conv_1 = Conv(output_size, output_size, 3, 1, 1, bias=not tail_bias_free,
                           generator=g)
        self.Conv_2 = Conv(input_size, output_size, 1, 1, 0, bias=not tail_bias_free,
                           generator=g)

    def forward(self, x, indicator, train: bool):
        h = self.BatchNorm_0(x, train).relu()
        h = self.Conv_0(self.mc_1(h, indicator))
        h = self.BatchNorm_1(h, train).relu()
        h = self.Conv_1(self.mc_2(h, indicator))
        sc = self.Conv_2(self.mc_1(x, indicator))
        return add_upsampled_nearest(h, sc, 2)


class MCGenerator(nn.Module):
    def __init__(self, data_shape, latent_size: int, hidden_size, num_mode: int,
                 controller_rate: float, seeds: _Seeds):
        super().__init__()
        hs = tuple(hidden_size)
        g = seeds.generator
        self.hidden_size = hs
        # start resolution from data_shape: res / 2^(number of blocks)
        self.start = data_shape[0] >> (len(hs) - 1)
        self.Dense_0 = Dense(latent_size, hs[0] * self.start * self.start, generator=g)
        self.blocks = nn.ModuleDict({
            f"_MCGenResBlock_{i}": _MCGenResBlock(
                hs[i], hs[i + 1], num_mode, controller_rate, seeds,
                tail_bias_free=(i == len(hs) - 2))
            for i in range(len(hs) - 1)})
        self.BatchNorm_0 = BatchNorm(hs[-1], g)
        self.MultimodalController_0 = seeds.mc(hs[-1], num_mode, controller_rate)
        self.Conv_0 = ConvS2D(hs[-1], data_shape[-1], generator=g)

    def forward(self, z, indicator, train: bool = False):
        x = self.Dense_0(z)
        # the JAX package reshapes the Dense output NHWC
        x = x.reshape(x.shape[0], self.start, self.start, self.hidden_size[0])
        x = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        for block in self.blocks.values():
            x = block(x, indicator, train)
        x = self.BatchNorm_0(x, train).relu()
        x = self.MultimodalController_0(x, indicator)
        return torch.tanh(self.Conv_0(x))


class _CGenResBlock(nn.Module):
    """Stride-2 generator block of the CGAN: the MCGAN block without gates.
    The same biases are dead (``Conv_0``; ``Conv_1`` / ``Conv_2`` of the last
    block) and are dropped as the JAX package drops them. Without gates the
    inner blocks' ``Conv_1`` / ``Conv_2`` biases are dead too (a per-channel
    constant reaches the head BatchNorm through linear shortcuts only); the
    JAX package keeps them, and so does the port, so the trees agree."""

    def __init__(self, input_size: int, output_size: int, generator: torch.Generator,
                 tail_bias_free: bool = False):
        super().__init__()
        g = generator
        self.BatchNorm_0 = BatchNorm(input_size, g)
        self.Conv_0 = UpsampledConv(input_size, output_size, bias=False, generator=g)
        self.BatchNorm_1 = BatchNorm(output_size, g)
        self.Conv_1 = Conv(output_size, output_size, 3, 1, 1, bias=not tail_bias_free,
                           generator=g)
        self.Conv_2 = Conv(input_size, output_size, 1, 1, 0, bias=not tail_bias_free,
                           generator=g)

    def forward(self, x, train: bool):
        h = self.Conv_0(self.BatchNorm_0(x, train).relu())
        h = self.Conv_1(self.BatchNorm_1(h, train).relu())
        return add_upsampled_nearest(h, self.Conv_2(x), 2)


class CGenerator(nn.Module):
    """A bias-free class embedding of the indicator, concatenated to z."""

    def __init__(self, data_shape, latent_size: int, hidden_size, num_mode: int,
                 embedding_size: int, generator: torch.Generator):
        super().__init__()
        hs = tuple(hidden_size)
        g = generator
        self.hidden_size = hs
        self.start = data_shape[0] >> (len(hs) - 1)  # as MCGenerator
        self.embedding = Dense(num_mode, embedding_size, bias=False, generator=g)
        self.Dense_0 = Dense(latent_size + embedding_size, hs[0] * self.start * self.start,
                             generator=g)
        self.blocks = nn.ModuleDict({
            f"_CGenResBlock_{i}": _CGenResBlock(hs[i], hs[i + 1], g,
                                                tail_bias_free=(i == len(hs) - 2))
            for i in range(len(hs) - 1)})
        self.BatchNorm_0 = BatchNorm(hs[-1], g)
        self.Conv_0 = ConvS2D(hs[-1], data_shape[-1], generator=g)

    def forward(self, z, indicator, train: bool = False):
        x = self.Dense_0(torch.cat([z, self.embedding(indicator.to(z.dtype))], -1))
        x = x.reshape(x.shape[0], self.start, self.start, self.hidden_size[0])
        x = x.permute(0, 3, 1, 2)
        for block in self.blocks.values():
            x = block(x, train)
        return torch.tanh(self.Conv_0(self.BatchNorm_0(x, train).relu()))


class _MCFirstDisResBlock(nn.Module):
    """conv3x3 -> ReLU -> MC gate -> conv3x3 + avgpool, plus the pooled 1x1
    shortcut: one call of the fused kernel. The prologue here (SN of the
    three weights, the pool fold, the mode code) is tiny and stays in torch.
    With ``plain`` set, the block calls the kernel's plain version instead
    (see :meth:`MCGAN.use_plain_kernels`).
    """

    def __init__(self, input_size: int, output_size: int, num_mode: int,
                 controller_rate: float, seeds: _Seeds):
        super().__init__()
        g = seeds.generator
        self.mc_1 = seeds.mc(output_size, num_mode, controller_rate)
        self.SNConv_0 = SNConv(input_size, output_size, 3, 1, 1, generator=g)
        self.SNConv_1 = SNConvPool(output_size, output_size, generator=g)
        self.SNConv_2 = SNConv(input_size, output_size, 1, 1, 0, generator=g)
        self.plain = False

    def forward(self, x, indicator, train: bool):
        def hwio(w):
            return w.permute(2, 3, 1, 0)

        w1 = hwio(self.SNConv_0.normalized_weight(train))
        w2f = hwio(self.SNConv_1.folded_weight(train))
        w3 = hwio(self.SNConv_2.normalized_weight(train))
        code = mode_code(indicator, self.mc_1.codebook)
        block = first_dblock_reference if self.plain else first_dblock
        y = block(x.permute(0, 2, 3, 1).contiguous(), code,
                  w1, self.SNConv_0.bias, w2f, self.SNConv_1.bias,
                  w3, self.SNConv_2.bias)
        return y.permute(0, 3, 1, 2)


class _MCDisResBlock(nn.Module):
    """Discriminator block; at stride 2 the avgpool is folded into the conv
    and the shortcut pools first (its MC gate and 1x1 conv commute)."""

    def __init__(self, input_size: int, output_size: int, num_mode: int,
                 controller_rate: float, stride: int, seeds: _Seeds):
        super().__init__()
        g = seeds.generator
        self.stride = stride
        self.mc_1 = seeds.mc(input_size, num_mode, controller_rate)
        self.mc_2 = seeds.mc(output_size, num_mode, controller_rate)
        self.SNConv_0 = SNConv(input_size, output_size, 3, 1, 1, generator=g)
        if stride > 1:
            self.SNConv_1 = SNConvPool(output_size, output_size, generator=g)
        else:
            self.SNConv_1 = SNConv(output_size, output_size, 3, 1, 1, generator=g)
        if stride > 1 or input_size != output_size:
            self.SNConv_2 = SNConv(input_size, output_size, 1, 1, 0, generator=g)

    def forward(self, x, indicator, train: bool):
        h = self.mc_1(x.relu(), indicator)
        h = self.SNConv_0(h, train).relu()
        h = self.SNConv_1(self.mc_2(h, indicator), train)
        if self.stride > 1:
            sc = self.SNConv_2(self.mc_1(avg_pool(x, 2), indicator), train)
        elif hasattr(self, "SNConv_2"):
            sc = self.SNConv_2(self.mc_1(x, indicator), train)
        else:
            sc = x
        return h + sc


class MCDiscriminator(nn.Module):
    def __init__(self, data_shape, hidden_size, num_mode: int, controller_rate: float,
                 cifar_style: bool, seeds: _Seeds):
        super().__init__()
        hs = tuple(hidden_size)
        n_tail = 2 if cifar_style else 1  # stride-1 tail blocks
        blocks = {"_MCFirstDisResBlock_0": _MCFirstDisResBlock(
            data_shape[-1], hs[0], num_mode, controller_rate, seeds)}
        for i in range(len(hs) - 1):
            stride = 2 if i < len(hs) - 1 - n_tail else 1
            blocks[f"_MCDisResBlock_{i}"] = _MCDisResBlock(
                hs[i], hs[i + 1], num_mode, controller_rate, stride, seeds)
        self.blocks = nn.ModuleDict(blocks)
        self.MultimodalController_0 = seeds.mc(hs[-1], num_mode, controller_rate)
        self.SNDense_0 = SNDense(hs[-1], 1, generator=seeds.generator)

    def forward(self, x, indicator, train: bool = False):
        for block in self.blocks.values():
            x = block(x, indicator, train)
        x = self.MultimodalController_0(x.relu(), indicator)
        return self.SNDense_0(global_sum_pool(x), train)


class _CFirstDisResBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 + avgpool, plus the pooled 1x1 shortcut,
    on the image and its tiled embedding (``C_in`` = image channels +
    ``embedding_size``). It runs as plain convolutions: the hand-written
    first D-block kernel takes 1 or 3 input channels and has the MC gate."""

    def __init__(self, input_size: int, output_size: int, generator: torch.Generator):
        super().__init__()
        g = generator
        self.SNConv_0 = SNConv(input_size, output_size, 3, 1, 1, generator=g)
        self.SNConv_1 = SNConvPool(output_size, output_size, generator=g)
        self.SNConv_2 = SNConv(input_size, output_size, 1, 1, 0, generator=g)

    def forward(self, x, train: bool):
        h = self.SNConv_1(self.SNConv_0(x, train).relu(), train)
        return h + self.SNConv_2(avg_pool(x, 2), train)


class _CDisResBlock(nn.Module):
    """The MCGAN discriminator block without gates."""

    def __init__(self, input_size: int, output_size: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.stride = stride
        self.SNConv_0 = SNConv(input_size, output_size, 3, 1, 1, generator=g)
        if stride > 1:
            self.SNConv_1 = SNConvPool(output_size, output_size, generator=g)
        else:
            self.SNConv_1 = SNConv(output_size, output_size, 3, 1, 1, generator=g)
        if stride > 1 or input_size != output_size:
            self.SNConv_2 = SNConv(input_size, output_size, 1, 1, 0, generator=g)

    def forward(self, x, train: bool):
        h = self.SNConv_1(self.SNConv_0(x.relu(), train).relu(), train)
        if self.stride > 1:
            sc = self.SNConv_2(avg_pool(x, 2), train)
        elif hasattr(self, "SNConv_2"):
            sc = self.SNConv_2(x, train)
        else:
            sc = x
        return h + sc


class CDiscriminator(nn.Module):
    """The class embedding (a bias-free ``SNDense`` of the indicator, whose
    ``u`` moves only in train mode) is tiled over H x W and concatenated
    after the image channels; no controller follows the last ReLU."""

    def __init__(self, data_shape, hidden_size, num_mode: int, embedding_size: int,
                 cifar_style: bool, generator: torch.Generator):
        super().__init__()
        hs = tuple(hidden_size)
        g = generator
        n_tail = 2 if cifar_style else 1
        self.embedding = SNDense(num_mode, embedding_size, bias=False, generator=g)
        blocks = {"_CFirstDisResBlock_0": _CFirstDisResBlock(
            data_shape[-1] + embedding_size, hs[0], g)}
        for i in range(len(hs) - 1):
            stride = 2 if i < len(hs) - 1 - n_tail else 1
            blocks[f"_CDisResBlock_{i}"] = _CDisResBlock(hs[i], hs[i + 1], stride, g)
        self.blocks = nn.ModuleDict(blocks)
        self.SNDense_0 = SNDense(hs[-1], 1, generator=g)

    def forward(self, x, indicator, train: bool = False):
        emb = self.embedding(indicator.to(x.dtype), train)
        B, _, H, W = x.shape
        x = torch.cat([x, emb[:, :, None, None].expand(B, -1, H, W)], 1)
        x = x.contiguous(memory_format=torch.channels_last)
        for block in self.blocks.values():
            x = block(x, train)
        return self.SNDense_0(global_sum_pool(x.relu()), train)


class _GANBase(nn.Module):
    """The contract MCGAN and CGAN share, which the train step, the sampler
    and the workflows rely on: ``generator`` and ``discriminator``
    submodules, ``latent_size``, ``num_mode``, ``compute_dtype`` (the
    activation dtype: bf16 operands with f32 parameters on the card by
    default), and ``generate`` / ``discriminate`` on NHWC images with f32
    outputs."""

    def use_plain_kernels(self, plain: bool = True) -> "_GANBase":
        """Route every hand-written kernel's call to its plain PyTorch
        version, which also runs f32 on the card: the reference that a run
        through the kernels is checked against. (CGAN calls none.)"""
        for m in self.modules():
            if isinstance(m, _MCFirstDisResBlock):
                m.plain = plain
        return self

    def _indicator(self, C):
        # f32 like the JAX package's one_hot; each consumer casts it
        return one_hot(C, self.num_mode).to(self.generator.Dense_0.weight.device)

    def generate(self, C: torch.Tensor, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Images ``[B,H,W,C]`` in [-1, 1] for modes ``C`` and latents ``z``."""
        x = self.generator(z.to(self.compute_dtype), self._indicator(C), train)
        return x.permute(0, 2, 3, 1).float()

    def discriminate(self, x: torch.Tensor, C: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Logits ``[B, 1]`` for NHWC images ``x``."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        return self.discriminator(x, self._indicator(C), train).float()

    def forward(self, C: torch.Tensor, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The G -> D chain."""
        return self.discriminate(self.generate(C, z, train), C, train)


class MCGAN(_GANBase):
    """Generator and discriminator of one MCGAN."""

    def __init__(self, data_shape=(32, 32, 3), latent_size: int = 128,
                 generator_hidden_size=(256, 256, 256, 256),
                 discriminator_hidden_size=(128, 128, 128, 128), num_mode: int = 10,
                 controller_rate: float = 0.5, cifar_style: bool = False,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.data_shape = tuple(data_shape)
        self.latent_size = latent_size
        self.num_mode = num_mode
        self.compute_dtype = compute_dtype
        seeds = _Seeds(torch.Generator().manual_seed(seed))
        self.generator = MCGenerator(self.data_shape, latent_size, generator_hidden_size,
                                     num_mode, controller_rate, seeds)
        self.discriminator = MCDiscriminator(self.data_shape, discriminator_hidden_size,
                                             num_mode, controller_rate, cifar_style, seeds)


class CGAN(_GANBase):
    """Generator and discriminator of one CGAN (class embeddings of
    ``embedding_size``)."""

    def __init__(self, data_shape=(32, 32, 3), latent_size: int = 128,
                 generator_hidden_size=(256, 256, 256, 256),
                 discriminator_hidden_size=(128, 128, 128, 128), num_mode: int = 10,
                 embedding_size: int = 32, cifar_style: bool = False,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.data_shape = tuple(data_shape)
        self.latent_size = latent_size
        self.num_mode = num_mode
        self.compute_dtype = compute_dtype
        g = torch.Generator().manual_seed(seed)
        self.generator = CGenerator(self.data_shape, latent_size, generator_hidden_size,
                                    num_mode, embedding_size, g)
        self.discriminator = CDiscriminator(self.data_shape, discriminator_hidden_size,
                                            num_mode, embedding_size, cifar_style, g)
