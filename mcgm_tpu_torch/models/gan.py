"""MCGAN: SNGAN-style generator and discriminator gated by
MultimodalControllers. Port of ``mcgm_tpu/models/gan.py`` (CGAN is a later
slice).

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


class MCGAN(nn.Module):
    """Generator and discriminator of one MCGAN.

    ``compute_dtype`` is the activation dtype (bf16 operands with f32
    parameters on the card by default); outputs are returned as f32.
    """

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

    def use_plain_kernels(self, plain: bool = True) -> "MCGAN":
        """Route every hand-written kernel's call to its plain PyTorch
        version, which also runs f32 on the card: the reference that a run
        through the kernels is checked against."""
        for m in self.modules():
            if isinstance(m, _MCFirstDisResBlock):
                m.plain = plain
        return self

    def _indicator(self, C):
        # f32 like the JAX package's one_hot; mc_gate casts the code to x's dtype
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
