"""Gated PixelCNN over VQ-VAE code grids: CPixelCNN (class-embedding bias)
and MCPixelCNN (MC gating). Port of ``mcgm_tpu/models/pixelcnn.py``.

15 layers (layer 0 mask A with kernel 7, the rest mask B with kernel 3) of
vertical / horizontal stacks with the gate ``ReLU(BN(x)) * sigmoid(y)``
(``x`` the first half of the channels, ``y`` the second), a residual on the
horizontal stack, and a 1x1 head to 512-way logits; the loss is the
cross-entropy over code indices. The causal masks are constant buffers of
``ops.layers.Conv`` and the padding is asymmetric (top / left), as in the
JAX package. Activations are contiguous NCHW in the model's compute dtype;
``forward`` takes and returns the JAX layout (codes ``[B, H, W]``, logits
``[B, H, W, K]``).

With ``train=False`` BatchNorm is an affine, and the horizontal stack's
residual 1x1 (conv, BN, MC gate) and the head's first 1x1 (conv, BN, ReLU,
MC gate) are each one call of ``kernels.mc_gate.mc_gated_matmul``: 16
launches per forward at 15 layers. In training the batch statistics sit
between the product and the gate, so those stay conv, BN and ``mc_gate``.
CPixelCNN's two 1x1 layers run through the same kernel without the gate.
``use_plain_kernels()`` routes the calls to the plain version, on the card
too.

Sampling draws ``argmax(logits + Gumbel)`` (``jax.random.categorical``'s
rule) from ``[B, K]`` uniforms of the caller's ``torch.Generator``, one draw
per position in raster order, so :func:`sample_codes` (one full forward
per position) and :func:`sample_codes_incremental` (cached vertical rows,
per-position horizontal products) give the same codes from one generator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..evals.metrics import weighted_mean
from ..kernels.mc_gate import bn_epilogue, mc_gated_matmul, mc_gated_matmul_reference
from ..ops.controller import Seeds, mode_code, one_hot
from ..ops.layers import BatchNorm, Conv, Embed, torch_uniform


def _vert_mask(kernel: int, mask_type: str) -> np.ndarray:
    """Vertical-stack mask ``[k//2 + 1, k]``: rows ``i - k//2 .. i``; mask A
    drops the current row."""
    m = np.ones((kernel // 2 + 1, kernel), np.float32)
    if mask_type == "A":
        m[-1] = 0.0
    return m


def _horiz_mask(kernel: int, mask_type: str) -> np.ndarray:
    """Horizontal-stack mask ``[1, k//2 + 1]``: columns ``j - k//2 .. j``;
    mask A drops the current column."""
    m = np.ones((1, kernel // 2 + 1), np.float32)
    if mask_type == "A":
        m[:, -1] = 0.0
    return m


def _conv(cin, cout, kernel, g, **kw):
    return Conv(cin, cout, kernel, generator=g, kernel_init=torch_uniform, **kw)


def _gated_1x1(x, conv, bn, indicator, mc, relu: bool, plain: bool) -> torch.Tensor:
    """``act(BN_eval(conv1x1(x)))`` gated by ``mc`` (None: no gate) as one
    ``mc_gated_matmul`` over ``x [B, C, H, W]`` read as ``[B, C, H*W]``."""
    B, C, H, W = x.shape
    alpha, beta = bn_epilogue(bn, conv.bias)
    w = conv.weight.reshape(conv.weight.shape[0], -1).to(x.dtype)
    ind, cb = (None, None) if mc is None else (indicator, mc.codebook)
    fn = mc_gated_matmul_reference if plain else mc_gated_matmul
    return fn(x.contiguous().reshape(B, C, H * W), w, alpha, beta, ind, cb,
              relu).reshape(B, -1, H, W)


class _GatedActivation(nn.Module):
    """``ReLU(BN(x)) * sigmoid(y)`` over the two halves of the channels,
    optionally MC-gated."""

    def __init__(self, hidden: int, num_mode, rate, g, seeds: Seeds):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(hidden, g)
        self.mc = num_mode is not None
        if self.mc:
            self.MultimodalController_0 = seeds.mc(hidden, num_mode, rate)

    def forward(self, xy, indicator, train: bool):
        x, y = xy.chunk(2, dim=1)
        out = self.BatchNorm_0(x, train).relu() * torch.sigmoid(y)
        return self.MultimodalController_0(out, indicator) if self.mc else out


class _GatedMaskedConv(nn.Module):
    """One vertical / horizontal gated layer; ``conditional`` adds a
    per-class bias into both gates instead of MC."""

    def __init__(self, mask_type: str, hidden: int, kernel: int, residual: bool, num_mode,
                 rate, conditional: bool, g, seeds: Seeds):
        super().__init__()
        h, k = hidden, kernel
        self.mask_type, self.residual, self.conditional = mask_type, residual, conditional
        self.mc = not conditional and num_mode is not None
        self.vert_stack = _conv(h, 2 * h, (k // 2 + 1, k), g,
                                padding=((k // 2, 0), (k // 2, k // 2)),
                                kernel_mask=_vert_mask(k, mask_type))
        self.horiz_stack = _conv(h, 2 * h, (1, k // 2 + 1), g, padding=((0, 0), (k // 2, 0)),
                                 kernel_mask=_horiz_mask(k, mask_type))
        self.vert_to_horiz = _conv(2 * h, 2 * h, 1, g)
        if conditional:
            self.class_cond_embedding = Embed(num_mode, 2 * h, g)
        mc_args = (None, None) if conditional else (num_mode, rate)
        self.gate_v = _GatedActivation(h, *mc_args, g, seeds)
        self.gate_h = _GatedActivation(h, *mc_args, g, seeds)
        self.horiz_resid_conv = _conv(h, h, 1, g)
        self.horiz_resid_bn = BatchNorm(h, g)
        if self.mc:
            self.horiz_resid_mc = seeds.mc(h, num_mode, rate)

    def cond_bias(self, indicator) -> torch.Tensor:
        """The class embedding rows ``[B, 2h]`` (f32) of the indicator's modes."""
        return self.class_cond_embedding(indicator.argmax(-1))

    def forward(self, x_v, x_h, indicator, train: bool, plain: bool = False):
        h_vert = self.vert_stack(x_v)
        h_horiz = self.horiz_stack(x_h)
        v2h = self.vert_to_horiz(h_vert)
        gin_v, gin_h = h_vert, v2h + h_horiz
        if self.conditional:
            cond = self.cond_bias(indicator).to(h_vert.dtype)[:, :, None, None]
            gin_v, gin_h = gin_v + cond, gin_h + cond
        out_v = self.gate_v(gin_v, indicator, train)
        out_h = self.gate_h(gin_h, indicator, train)
        mc = self.horiz_resid_mc if self.mc else None
        if train:
            r = self.horiz_resid_bn(self.horiz_resid_conv(out_h), True)
            if mc is not None:
                r = mc(r, indicator)
        else:
            r = _gated_1x1(out_h, self.horiz_resid_conv, self.horiz_resid_bn, indicator, mc,
                           False, plain)
        return out_v, (r + x_h if self.residual else r)


class _Head(nn.Module):
    """1x1 head: conv, BN, ReLU, [MC], conv."""

    def __init__(self, hidden: int, input_size: int, num_mode, rate, g, seeds: Seeds):
        super().__init__()
        self.Conv_0 = _conv(hidden, 512, 1, g)
        self.BatchNorm_0 = BatchNorm(512, g)
        self.mc = num_mode is not None
        if self.mc:
            self.MultimodalController_0 = seeds.mc(512, num_mode, rate)
        self.Conv_1 = _conv(512, input_size, 1, g)

    def forward(self, x, indicator, train: bool, plain: bool = False):
        mc = self.MultimodalController_0 if self.mc else None
        if train:
            z = self.BatchNorm_0(self.Conv_0(x), True).relu()
            if mc is not None:
                z = mc(z, indicator)
        else:
            z = _gated_1x1(x, self.Conv_0, self.BatchNorm_0, indicator, mc, True, plain)
        return self.Conv_1(z)


class _PixelCNNBase(nn.Module):
    def _build(self, input_size, hidden_size, num_layer, num_mode, rate, conditional,
               compute_dtype, seed):
        g = torch.Generator().manual_seed(seed)
        seeds = Seeds(g)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.num_layer, self.num_mode = num_layer, num_mode
        self.compute_dtype = compute_dtype
        self.plain = False
        self.embedding = Embed(input_size, hidden_size, g)
        for i in range(num_layer):
            setattr(self, f"layer_{i}", _GatedMaskedConv(
                "A" if i == 0 else "B", hidden_size, 7 if i == 0 else 3, i > 0, num_mode,
                rate, conditional, g, seeds))
        self.head = _Head(hidden_size, input_size, None if conditional else num_mode, rate, g,
                          seeds)

    def use_plain_kernels(self, plain: bool = True):
        """Route the eval path's gated products to their plain version, on
        the card too: the reference a run through the kernel is held to."""
        self.plain = plain
        return self

    def layers(self) -> list:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layer)]

    def forward(self, batch: dict, train: bool = False) -> dict:
        """``batch = {"img": int codes [B, H, W], "label": [B][, "w"]}`` ->
        ``{"loss", "logits" [B, H, W, input_size]}``."""
        x = batch["img"].long()
        indicator = one_hot(batch["label"], self.num_mode)
        h = self.embedding(x).to(self.compute_dtype).permute(0, 3, 1, 2).contiguous()
        x_v = x_h = h
        for layer in self.layers():
            x_v, x_h = layer(x_v, x_h, indicator, train, self.plain)
        logits = self.head(x_h, indicator, train, self.plain).permute(0, 2, 3, 1)
        logp = torch.log_softmax(logits.float(), -1)
        nll = -logp.gather(-1, x[..., None])
        return {"loss": weighted_mean(nll, batch.get("w")), "logits": logits}


class MCPixelCNN(_PixelCNNBase):
    def __init__(self, input_size: int = 512, hidden_size: int = 128, num_layer: int = 15,
                 num_mode: int = 10, controller_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self._build(input_size, hidden_size, num_layer, num_mode, controller_rate, False,
                    compute_dtype, seed)


class CPixelCNN(_PixelCNNBase):
    def __init__(self, input_size: int = 512, hidden_size: int = 128, num_layer: int = 15,
                 num_mode: int = 10, compute_dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self._build(input_size, hidden_size, num_layer, num_mode, None, True, compute_dtype,
                    seed)


# ------------------------------------------------------------------ sampling
def _device(model) -> torch.device:
    return next(model.parameters()).device


def _draw(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``argmax(logits + Gumbel)`` from ``[B, K]`` uniforms of ``generator``
    (kept above the f32 ``tiny``, as ``jax.random.gumbel`` keeps them)."""
    u = torch.rand(logits.shape, generator=generator, device=generator.device)
    u = u.to(logits.device).clamp_min(torch.finfo(torch.float32).tiny)
    return (logits.float() - torch.log(-torch.log(u))).argmax(-1)


@torch.no_grad()
def sample_codes(model, C, generator: torch.Generator, grid_hw=(8, 8)) -> torch.Tensor:
    """Raster-scan sampling with one full eval forward per position; codes
    ``int32 [B, H, W]`` on the model's device."""
    H, W = grid_hw
    dev = _device(model)
    C = torch.as_tensor(np.asarray(C), dtype=torch.long, device=dev)
    img = torch.zeros((len(C), H, W), dtype=torch.long, device=dev)
    for t in range(H * W):
        i, j = divmod(t, W)
        logits = model({"img": img, "label": C}, train=False)["logits"][:, i, j]
        img[:, i, j] = _draw(logits, generator)
    return img.int()


@torch.no_grad()
def sample_codes_incremental(model, C, generator: torch.Generator, grid_hw=(8, 8),
                             return_logits: bool = False):
    """The cached-activation raster sampler: per row, every layer's
    vertical stream for all columns at once (it sees only earlier rows);
    per position, each layer's horizontal products over the cached
    left-neighbour windows, the residual 1x1 and the head's first 1x1
    through ``mc_gated_matmul`` (16 launches per position at 15 layers).
    The same codes as :func:`sample_codes` from the same generator, and
    per-position logits equal to a full forward on the sampled codes.

    Buffers follow the JAX sampler: the embedded codes with 3 rows of top
    padding (layer 0's mask-A kernel reaches 3 rows up), each layer's
    vertical output with 1 (mask B reaches 1 row up), and per row the
    horizontal streams left-padded by 3 columns. Products run in the
    model's compute dtype with f32 sums; biases, BatchNorm and gates in f32.
    Returns codes ``int32 [B, H, W]`` (and the f32 logits ``[B, H, W, K]``).
    """
    H, W = grid_hw
    dev, dt = _device(model), model.compute_dtype
    L, h = model.num_layer, model.hidden_size
    C = torch.as_tensor(np.asarray(C), dtype=torch.long, device=dev)
    B = len(C)
    ind = one_hot(C, model.num_mode)
    fn = mc_gated_matmul_reference if model.plain else mc_gated_matmul

    lay = []
    for layer in model.layers():
        vk = layer.vert_stack.masked_weight()      # [2h, h, kh, k]
        hk = layer.horiz_stack.masked_weight()     # [2h, h, 1, kw]
        if layer.mask_type == "A":  # drop the current row / column taps
            vk, hk = vk[:, :, :-1], hk[:, :, :, :-1]
        d = {"vk": vk.to(dt), "vb": layer.vert_stack.bias,
             # the window product's [kw * h, 2h], row index col * h + channel
             "hk": hk[:, :, 0].permute(2, 1, 0).reshape(-1, hk.shape[0]).to(dt),
             "hb": layer.horiz_stack.bias,
             "v2k": layer.vert_to_horiz.weight[:, :, 0, 0].t().to(dt),
             "v2b": layer.vert_to_horiz.bias,
             "rk": layer.horiz_resid_conv.weight[:, :, 0, 0].to(dt),
             "code_v": None, "code_h": None, "cb_r": None, "cond": None}
        d["gv_w"], d["gv_b"] = bn_epilogue(layer.gate_v.BatchNorm_0, 0.0)
        d["gh_w"], d["gh_b"] = bn_epilogue(layer.gate_h.BatchNorm_0, 0.0)
        d["r_alpha"], d["r_beta"] = bn_epilogue(layer.horiz_resid_bn, layer.horiz_resid_conv.bias)
        if layer.conditional:
            d["cond"] = layer.cond_bias(ind)
        else:
            d["code_v"] = mode_code(ind, layer.gate_v.MultimodalController_0.codebook)
            d["code_h"] = mode_code(ind, layer.gate_h.MultimodalController_0.codebook)
            d["cb_r"] = layer.horiz_resid_mc.codebook
        lay.append(d)
    head = model.head
    h_alpha, h_beta = bn_epilogue(head.BatchNorm_0, head.Conv_0.bias)
    h_k1 = head.Conv_0.weight[:, :, 0, 0].to(dt)
    h_cb = head.MultimodalController_0.codebook if head.mc else None
    h_k2 = head.Conv_1.weight[:, :, 0, 0].t().to(dt)
    h_b2 = head.Conv_1.bias
    table = model.embedding.weight.to(dt)

    def gate(x2h, w, b, code):  # x2h [B, 2h(, W)] f32
        shape = (1, -1) + (1,) * (x2h.dim() - 2)
        xg, yg = x2h.chunk(2, dim=1)
        out = (xg * w.reshape(shape) + b.reshape(shape)).relu() * torch.sigmoid(yg)
        return out if code is None else out * code.reshape(code.shape + (1,) * (out.dim() - 2))

    img = torch.zeros((B, H, W), dtype=torch.long, device=dev)
    emb_pad = torch.zeros((B, h, H + 3, W), dtype=dt, device=dev)
    outv = torch.zeros((L, B, h, H + 1, W), dtype=dt, device=dev)
    logits_acc = (torch.zeros((B, H, W, model.input_size), device=dev)
                  if return_logits else None)
    for i in range(H):
        # the vertical rows: all layers, all columns of row i
        hvert = []
        for l, d in enumerate(lay):
            if l == 0:
                x, pw = emb_pad[:, :, i:i + 3], 3
            else:
                x, pw = outv[l - 1][:, :, i:i + 2], 1
            hv = F.conv2d(x, d["vk"], None, 1, (0, pw))[:, :, 0].float() + d["vb"][:, None]
            hvert.append(hv)  # [B, 2h, W]
            gin = hv if d["cond"] is None else hv + d["cond"][:, :, None]
            outv[l][:, :, i + 1] = gate(gin, d["gv_w"], d["gv_b"], d["code_v"]).to(dt)
        # the horizontal streams, position by position; hrow[0] holds the
        # row's embedded codes, hrow[l + 1] layer l's output
        hrow = torch.zeros((L + 1, B, W + 3, h), dtype=dt, device=dev)
        for j in range(W):
            for l, d in enumerate(lay):
                win = hrow[0, :, j:j + 3] if l == 0 else hrow[l, :, j + 2:j + 4]
                hh = (win.reshape(B, -1) @ d["hk"]).float() + d["hb"]
                v2h = (hvert[l][:, :, j].to(dt) @ d["v2k"]).float() + d["v2b"]
                gin = v2h + hh if d["cond"] is None else v2h + hh + d["cond"]
                oh = gate(gin, d["gh_w"], d["gh_b"], d["code_h"]).to(dt)
                r = fn(oh, d["rk"], d["r_alpha"], d["r_beta"],
                       None if d["cb_r"] is None else ind, d["cb_r"])
                if l > 0:
                    r = r + hrow[l, :, j + 3]
                hrow[l + 1, :, j + 3] = r
            z = fn(hrow[L, :, j + 3].contiguous(), h_k1, h_alpha, h_beta,
                   None if h_cb is None else ind, h_cb, True)
            logits = (z @ h_k2).float() + h_b2
            sample = _draw(logits, generator)
            img[:, i, j] = sample
            ev = table[sample]
            emb_pad[:, :, i + 3, j] = ev
            hrow[0, :, j + 3] = ev
            if logits_acc is not None:
                logits_acc[:, i, j] = logits
    img = img.int()
    return (img, logits_acc) if return_logits else img
