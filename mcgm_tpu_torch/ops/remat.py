"""The train steps' ``remat`` option: recompute a forward in the backward
pass (the JAX package's ``jax.checkpoint`` around the loss).

One checkpoint spans the whole loss, as in the JAX step, and PyTorch
recomputes all of it when the backward starts: the step pays the recompute
and its peak memory does not drop (``PERF.md`` §6); what the option gives is
the JAX step's results with its flag set.

:func:`remat` runs ``fn`` under ``torch.utils.checkpoint`` (non-reentrant).
PyTorch's recompute runs the forward's side effects a second time, which
``jax.checkpoint``'s pure function does not; so around the recompute every
buffer the forward moved (BatchNorm's running statistics, spectral norm's
``u``, the VQ codebook's EMA buffers) is put back as it was before the
forward, and so is each ``torch.Generator`` the forward drew noise from
(a VAE's reparameterisation, a Glow's dequantisation); after the
recompute the values the forward left are restored. The recompute thus
sees the forward's inputs, and the step ends with the buffers moved once.
:func:`recomputing` says whether a recompute is running: the VQ quantizer
skips its EMA update then (no second ``vq_ema`` launch).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

_DEPTH = [0]


def recomputing() -> bool:
    """Whether a :func:`remat` recompute is running."""
    return _DEPTH[0] > 0


@contextlib.contextmanager
def _replay(kept: list, generators: list):
    """Around a recompute: the kept buffers and the generators as they were
    before the forward; after it, as the forward left them."""
    with torch.no_grad():
        after = [b.clone() for b, _ in kept]
        for b, before in kept:
            b.copy_(before)
    gen_after = [g.get_state() for g, _ in generators]
    for g, before in generators:
        g.set_state(before)
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1
        with torch.no_grad():
            for (b, _), a in zip(kept, after):
                b.copy_(a)
        for (g, _), a in zip(generators, gen_after):
            g.set_state(a)


def remat(fn, *args, modules: tuple = (), generators: tuple = (), **kwargs):
    """``fn(*args, **kwargs)``, its activations recomputed in the backward.
    ``modules``: the modules ``fn`` runs, whose submodules with
    ``moves_buffers`` set (BatchNorm, the spectral-norm layers, the VQ
    quantizer) may move their buffers; ``generators``: the
    ``torch.Generator``s it may draw from (``None`` entries are skipped)."""
    # every such buffer is kept: a hand kernel writes its buffers through
    # their pointers, which no version counter sees
    bufs = list({id(b): b for m in modules for sub in m.modules()
                 if getattr(sub, "moves_buffers", False)
                 for b in sub.buffers(recurse=False)}.values())
    with torch.no_grad():
        kept = [(b, b.clone()) for b in bufs]
    gens = [(g, g.get_state()) for g in generators if g is not None]
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _replay(kept, gens)),
                      **kwargs)
