"""Int8 post-training quantization of the serving path (never training):
port of ``mcgm_tpu/ops/layers.py:62-161``.

While an :class:`int8_serving` context is open, every quantizable layer
(``Conv``, ``UpsampledConv``, ``ConvTranspose``, ``Dense``; not the
generators' ``ConvS2D`` image head) runs :func:`int8_apply`:

- ``dynamic``: per-example activation scales, ``max |x|`` over each
  example's C, H and W, so a request never depends on what it was batched
  with;
- ``calibrate``: the full-precision math, recording each layer's largest
  ``|x|`` in its ``act_amax`` buffer (the JAX package's
  ``quant_stats/act_amax``);
- ``static``: one activation scale per layer, from ``act_amax``.

Weights are quantized per output channel over every other axis: the
``UpsampledConv``'s composite 4x4 kernel (one rounding step, as the JAX
package quantizes ``_up4_kernel``), the ``ConvTranspose``'s flipped kernel
(per-channel groups along torch's axis 1). A live apply quantizes them at
each call, as the JAX package's does; :func:`frozen_int8_weights` quantizes
them once and holds them as buffers, which an export bakes in. The scale is
``max(amax, 1e-8) / 127``, the value ``clip(round(t / scale), -127, 127)``
(half to even), the product ``s8 x s8 -> s32`` exact, then ``float(acc) *
(wscale * xscale)`` in the compute dtype plus the bias in that dtype: the
``mcgm::int8_quantize`` and ``mcgm::int8_conv`` ops (``kernels/ops.py``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..kernels.int8 import quantize_sym

MODES = ("dynamic", "static", "calibrate")
_MODE = [None]


class int8_serving:
    """Context manager: run the enclosed applies (or trace the enclosed
    export) in int8 mode ``dynamic`` (default), ``static`` or
    ``calibrate``."""

    def __init__(self, mode: str = "dynamic"):
        if mode not in MODES:
            raise ValueError(f"unknown int8 mode {mode!r}")
        self._mode = mode

    def __enter__(self):
        self._prev = _MODE[0]
        _MODE[0] = self._mode

    def __exit__(self, *exc):
        _MODE[0] = self._prev
        return False


def int8_mode() -> str | None:
    return _MODE[0]


class Int8Site(nn.Module):
    """A layer with an int8 serving branch. ``int8_spec()`` gives its kernel
    as the int8 conv reads it: ``(layout, w [N, taps * C] f32, kh, kw,
    pad)``. ``act_amax`` is None until calibrated; a ``state_dict`` that
    holds it (a calibrated model's, or the JAX package's ``quant_stats``
    through ``io.jax_import``) brings it into being at load."""

    quantized = True

    def __init__(self):
        super().__init__()
        self.register_buffer("act_amax", None)

    def int8_spec(self):
        raise NotImplementedError

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.act_amax is None and prefix + "act_amax" in state_dict:
            self.act_amax = torch.zeros((), device=self.weight.device)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def act_amax_state(module: nn.Module) -> dict:
    """The calibrated ``act_amax`` entries of ``module``'s ``state_dict``."""
    return {f"{name}.act_amax" if name else "act_amax": m.act_amax
            for name, m in module.named_modules()
            if isinstance(m, Int8Site) and m.act_amax is not None}


def _quantized_weight(mod: Int8Site):
    """``(layout, w int8, wscale [N], kh, kw, pad)``: the frozen buffers, or
    the weight quantized now."""
    frozen = getattr(mod, "int8_frozen", None)
    if frozen is not None:
        layout, kh, kw, pad = frozen
        return layout, mod.int8_weight, mod.int8_wscale, kh, kw, pad
    layout, wf, kh, kw, pad = mod.int8_spec()
    w, wscale = quantize_sym(wf, (1,))
    return layout, w, wscale.reshape(-1), kh, kw, pad


@contextlib.contextmanager
def frozen_int8_weights(module: nn.Module):
    """While open, every quantizable layer in ``module`` holds its int8
    weight and scales as (non-persistent) buffers ``int8_weight`` /
    ``int8_wscale``, quantized once here: an export bakes them in, and no
    quantization of weights is left in its graph."""
    sites = [m for m in module.modules() if isinstance(m, Int8Site) and m.quantized]
    for m in sites:
        with torch.no_grad():
            layout, wf, kh, kw, pad = m.int8_spec()
            w, wscale = quantize_sym(wf, (1,))
        m.register_buffer("int8_weight", w, persistent=False)
        m.register_buffer("int8_wscale", wscale.reshape(-1), persistent=False)
        m.int8_frozen = (layout, kh, kw, pad)
    try:
        yield
    finally:
        for m in sites:
            del m.int8_weight, m.int8_wscale, m.int8_frozen


def int8_apply(mod: Int8Site, x: torch.Tensor, bias: torch.Tensor | None):
    """The active int8 mode at one layer: its output (NCHW for a conv, ``[B,
    N]`` for a Dense, in ``x``'s dtype, bias added), or None in
    ``calibrate`` mode, where the layer records ``act_amax`` and runs its
    full-precision math."""
    mode = _MODE[0]
    if mode == "calibrate":
        amax = x.detach().float().abs().amax()
        mod.act_amax = amax if mod.act_amax is None else torch.maximum(mod.act_amax, amax)
        return None
    if mode == "static" and mod.act_amax is None:
        raise ValueError("int8 'static' needs calibrated activation scales: run "
                         f"io.export.calibrate_int8 first ({type(mod).__name__} has no "
                         "act_amax)")
    from ..kernels import ops  # noqa: F401  (registers torch.ops.mcgm)

    layout, w, wscale, kh, kw, pad = _quantized_weight(mod)
    conv = x.dim() == 4
    xin = (x.permute(0, 2, 3, 1) if conv else x[:, None, None, :]).contiguous()
    q, xscale = torch.ops.mcgm.int8_quantize(xin, mod.act_amax if mode == "static" else None)
    y = torch.ops.mcgm.int8_conv(q, w, wscale, xscale, bias, layout, kh, kw, pad, x.dtype)
    return y.permute(0, 3, 1, 2) if conv else y.reshape(y.shape[0], -1)


def up4_kernel(w: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3 -> the 4x4 composite ``W4[i, j] = sum_{di, dj in {0, 1}}
    W[i - di, j - dj]`` of nearest-up2 then conv3x3 (pad 1), as one conv
    over the input dilated by 2: the JAX package's ``_up4_kernel``, its
    four terms added in the same order."""
    p = torch.nn.functional.pad
    return p(w, (0, 1, 0, 1)) + p(w, (1, 0, 0, 1)) + p(w, (0, 1, 1, 0)) + p(w, (1, 0, 1, 0))
