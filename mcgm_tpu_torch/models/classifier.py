"""Small CNN classifier: the IS / FID feature model for COIL100 and
Omniglot. Port of ``mcgm_tpu/models/classifier.py``.

Four conv3x3 -> BatchNorm -> ReLU stages (hidden ``[8, 16, 32, 64]`` by
default), a 2x2 max-pool after each but the last, then a linear head. The
flattened penultimate activations (``feature_only``) are the feature space;
they are flattened in NHWC order, as the JAX package's are, so the head's
weights carry over. Submodules carry the flax names (``Conv_i``,
``BatchNorm_i``, ``classifier``) for ``io.jax_import.from_jax_classifier``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import BatchNorm, Conv, Dense


class Classifier(nn.Module):
    def __init__(self, data_shape=(32, 32, 3), hidden_size=(8, 16, 32, 64),
                 classes_size: int = 10, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        hs = tuple(hidden_size)
        chans = (data_shape[-1],) + hs
        for i, h in enumerate(hs):
            self.add_module(f"Conv_{i}", Conv(chans[i], h, 3, 1, 1, generator=g))
            self.add_module(f"BatchNorm_{i}", BatchNorm(h, g))
        side = data_shape[0] >> (len(hs) - 1)
        self.n_stage = len(hs)
        self.classifier = Dense(hs[-1] * side * side, classes_size, generator=g)

    def forward(self, img: torch.Tensor, train: bool = False, feature_only: bool = False):
        """``img``: NHWC in [-1, 1]. Returns the logits ``[B, classes]``, or
        with ``feature_only`` the flattened features."""
        x = img.permute(0, 3, 1, 2)
        for i in range(self.n_stage):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), train).relu()
            if i < self.n_stage - 1:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return x if feature_only else self.classifier(x)
