"""``torch.library`` custom ops over the hand-written kernels that a serving
artifact runs: ``mcgm::int8_quantize``, ``mcgm::int8_conv`` and
``mcgm::mc_gated_matmul`` (its forward).

``torch.export`` traces through these ops (each has a fake implementation
that gives the output's shape and dtype) and records them by name, so an
exported generate path keeps its kernels: a ctypes launch cannot be traced.
Importing this module registers them; it is all that a serving host needs
besides torch to load an artifact (``io.export.load_artifact``).

Each op has two implementations, chosen by the device of its tensors: on
``cuda`` the kernel's wrapper (which launches the kernel, counts the launch
and raises if the card refuses it), on ``cpu`` the plain version. There is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import int8, mc_gate


def _c(*ts):
    """The tensors contiguous (a loaded program may hand over other strides
    than the traced ones), None kept."""
    return tuple(None if t is None else t.contiguous() for t in ts)


# -------------------------------------------------------------- int8_quantize
@torch.library.custom_op("mcgm::int8_quantize", mutates_args=(), device_types="cuda")
def int8_quantize(x: torch.Tensor, amax: torch.Tensor | None) -> tuple[torch.Tensor,
                                                                      torch.Tensor]:
    """``(q, scale)`` of ``kernels.int8.int8_quantize``."""
    return int8.int8_quantize(*_c(x, amax))


@int8_quantize.register_kernel("cpu")
def _(x, amax):
    return int8.int8_quantize_reference(*_c(x, amax))


@int8_quantize.register_fake
def _(x, amax):
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            x.new_empty((x.shape[0],), dtype=torch.float32))


# ------------------------------------------------------------------ int8_conv
@torch.library.custom_op("mcgm::int8_conv", mutates_args=(), device_types="cuda")
def int8_conv(x: torch.Tensor, w: torch.Tensor, wscale: torch.Tensor, xscale: torch.Tensor,
              bias: torch.Tensor | None, layout: int, kh: int, kw: int, pad: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    """NHWC ``[B, Ho, Wo, N]`` of ``kernels.int8.int8_conv``."""
    x, w, wscale, xscale, bias = _c(x, w, wscale, xscale, bias)
    return int8.int8_conv(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype)


@int8_conv.register_kernel("cpu")
def _(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype):
    x, w, wscale, xscale, bias = _c(x, w, wscale, xscale, bias)
    int8._check_conv(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype)
    return int8.int8_conv_reference(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype)


@int8_conv.register_fake
def _(x, w, wscale, xscale, bias, layout, kh, kw, pad, out_dtype):
    B, H, W, _ = x.shape
    Ho, Wo = int8._out_hw(layout, H, W, kh, kw, pad)
    return x.new_empty((B, Ho, Wo, w.shape[0]), dtype=out_dtype)


# ------------------------------------------------------------ mc_gated_matmul
@torch.library.custom_op("mcgm::mc_gated_matmul", mutates_args=(), device_types="cuda")
def mc_gated_matmul(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor | None,
                    beta: torch.Tensor | None, indicator: torch.Tensor | None,
                    codebook: torch.Tensor | None, relu: bool) -> torch.Tensor:
    """The forward of ``kernels.mc_gate.mc_gated_matmul`` (no gradient)."""
    x, w, alpha, beta, indicator, codebook = _c(x, w, alpha, beta, indicator, codebook)
    mc_gate._check(x, w, alpha, beta, indicator, codebook)
    return mc_gate._launch(x, w, alpha, beta, indicator, codebook, relu)


@mc_gated_matmul.register_kernel("cpu")
def _(x, w, alpha, beta, indicator, codebook, relu):
    x, w, alpha, beta, indicator, codebook = _c(x, w, alpha, beta, indicator, codebook)
    mc_gate._check(x, w, alpha, beta, indicator, codebook)
    return mc_gate.mc_gated_matmul_reference(x, w, alpha, beta, indicator, codebook, relu)


@mc_gated_matmul.register_fake
def _(x, w, alpha, beta, indicator, codebook, relu):
    return x.new_empty(x.shape[:1] + w.shape[:1] + x.shape[2:])
