"""EMA-codebook vector quantization. Port of ``mcgm_tpu/ops/vq.py``.

Decay 0.99, eps 1e-5, Laplace-smoothed cluster sizes and the
straight-through estimator. The buffers are ``embedding [D, K]`` (codes are
columns), ``cluster_size [K]`` and ``embedding_mean [D, K]``, which starts
as a copy of ``embedding``; the JAX package keeps them in its ``vq_stats``
collection. Inputs are channels-last ``[..., D]``.

The nearest-code search and the EMA update are the hand-written kernels of
``kernels/vq.py`` on the card (their plain versions on the CPU, or on the
card with ``plain`` set). ``quantize`` and the commitment ``diff`` come from
the codebook as it was before the update, which is applied after them, as
in the JAX package. Under the train steps' ``remat`` the recompute of the
forward skips the update (``ops.remat``), so the EMA moves once a step.
"""

from __future__ import annotations

import torch
from torch import nn

from ..evals.metrics import weighted_mean
from ..kernels.vq import vq_assign, vq_assign_reference, vq_ema, vq_ema_reference
from .remat import recomputing


class VectorQuantizerEMA(nn.Module):
    moves_buffers = True  # the EMA, in training

    def __init__(self, embedding_size: int, num_embedding: int, decay: float = 0.99,
                 eps: float = 1e-5, generator=None):
        super().__init__()
        self.decay, self.eps = decay, eps
        emb = torch.randn((embedding_size, num_embedding), generator=generator)
        self.register_buffer("embedding", emb)
        self.register_buffer("cluster_size", torch.zeros(num_embedding))
        self.register_buffer("embedding_mean", emb.clone())
        self.plain = False  # the plain versions on the card too (see use_plain_kernels)

    def forward(self, x: torch.Tensor, train: bool = False, w=None):
        """``x [..., D]`` -> ``(quantized [..., D] in x's dtype, commitment
        diff, code int32 [...])``. In train mode the EMA moves the buffers,
        with row weights from the per-sample mask ``w [B]`` if given; ``w``
        also weights ``diff``."""
        D = self.embedding.shape[0]
        flat = x.detach().reshape(-1, D).float().contiguous()
        with torch.no_grad():
            code, quantize = (vq_assign_reference if self.plain else vq_assign)(
                flat, self.embedding)
            if train and not recomputing():  # a remat recompute moves nothing
                wf = None
                if w is not None:  # one weight per position
                    wf = (w.float().reshape((-1,) + (1,) * (x.dim() - 2))
                          .expand(x.shape[:-1]).reshape(-1).contiguous())
                (vq_ema_reference if self.plain else vq_ema)(
                    flat, code, wf, self.cluster_size, self.embedding_mean, self.embedding,
                    self.decay, self.eps)
        quantize = quantize.reshape(x.shape)
        x32 = x.float()
        diff = weighted_mean((quantize - x32) ** 2, w)
        quantize = x32 + (quantize - x32).detach()
        return quantize.to(x.dtype), diff, code.reshape(x.shape[:-1])

    def embedding_code(self, code: torch.Tensor) -> torch.Tensor:
        """Codebook vectors ``[..., D]`` of integer codes ``[...]``."""
        return self.embedding.t()[code.long()]
