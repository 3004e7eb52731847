"""Small CNN classifier: the IS / FID feature model for COIL100 and
Omniglot, and of any dataset whose classifier was trained by the port
(``train.loop.Experiment``). Port of ``mcgm_tpu/models/classifier.py``.

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

from ..evals.metrics import weighted_mean
from ..ops.layers import BatchNorm, Conv, Dense


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, w=None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` in f32; a 0/1 mask ``w``
    leaves rows out."""
    logp = torch.log_softmax(logits.float(), -1)
    return weighted_mean(-logp.gather(1, labels.long()[:, None]), w)


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

    def forward(self, img, train: bool = False, feature_only: bool = False):
        """``img``: NHWC in [-1, 1]. Returns the logits ``[B, classes]``, or
        with ``feature_only`` the flattened features. Given a batch dict
        (``img``, and ``label`` / ``w`` if present), returns the train
        step's output dict, ``{"label": logits, "loss": cross-entropy}``,
        as the JAX model does."""
        batch = img if isinstance(img, dict) else None
        x = (batch["img"] if batch is not None else img).permute(0, 3, 1, 2)
        for i in range(self.n_stage):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x), train).relu()
            if i < self.n_stage - 1:
                x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if feature_only:
            return x
        logits = self.classifier(x)
        if batch is None:
            return logits
        out = {"label": logits}
        if "label" in batch:
            out["loss"] = cross_entropy(logits, batch["label"], batch.get("w"))
        return out
