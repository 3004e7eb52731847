"""Import checkpoints of the reference (PyTorch) implementation. Port of
``mcgm_tpu/io/torch_import.py``.

A reference trainer's ``state_dict`` (the ``model_dict`` of its checkpoint
pickle) goes through the JAX package's ten converters, copied here in
numpy, to the flax variables of the JAX layout; the port's
``from_jax_variables`` then makes the port's ``state_dict`` from them
(:func:`load_reference`). What the converters carry over:

- ``nn.Conv2d`` ``(out, in, kh, kw)`` and ``ConvTranspose2d`` ``(in, out,
  kh, kw)`` to HWIO, ``nn.Linear`` ``(out, in)`` to ``(in, out)``;
- BatchNorm ``weight`` / ``bias`` / ``running_*`` to ``scale`` / ``bias``
  and ``batch_stats``; the MultimodalController codebooks; the VQ EMA
  buffers; spectral norm's ``weight_orig`` and ``u`` (``weight_v``
  consumed and dropped); Glow's ActNorm, LU invconv factors and zero convs;
- the generator conv biases the JAX package (and the port) drop, folded
  into the following BatchNorm's running mean (``_conv_fold_bias``,
  ``_fold_into_bn``): exact in both modes;
- the CHW-flattened dense and BatchNorm1d features permuted to the HWC
  order of the JAX layout (``_hwc_perm``), which the port's import maps
  back to its own NCHW layout;
- CGlow's conditional-prior embeddings of every block but the last, which
  the reference builds and never uses: consumed and dropped;
- a key no converter reads raises (``_SD.unused``).

``cli/import_reference.py`` writes such a checkpoint as the port's
``_best``.
"""

from __future__ import annotations

import numpy as np
import torch

from .jax_import import from_jax_variables, pack_glow_flows


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


class _SD:
    """state_dict view with access tracking (unconsumed keys = mapping bug)."""

    def __init__(self, sd: dict):
        self.sd = dict(sd)
        self.used: set = set()

    def __call__(self, key: str) -> np.ndarray:
        self.used.add(key)
        return _np(self.sd[key])

    def unused(self):
        return [k for k in self.sd if k not in self.used
                and not k.endswith("num_batches_tracked")]


def _conv(sd: _SD, key: str, bias: bool = True) -> dict:
    out = {"kernel": sd(f"{key}.weight").transpose(2, 3, 1, 0)}
    if bias:
        out["bias"] = sd(f"{key}.bias")
    return out


def _convT(sd: _SD, key: str) -> dict:
    return {"kernel": sd(f"{key}.weight").transpose(2, 3, 0, 1),
            "bias": sd(f"{key}.bias")}


def _dense(sd: _SD, key: str, bias: bool = True) -> dict:
    out = {"kernel": sd(f"{key}.weight").T}
    if bias:
        out["bias"] = sd(f"{key}.bias")
    return out


def _bn(sd: _SD, key: str) -> tuple[dict, dict]:
    params = {"scale": sd(f"{key}.weight"), "bias": sd(f"{key}.bias")}
    stats = {"mean": sd(f"{key}.running_mean"),
             "var": sd(f"{key}.running_var")}
    return {"bn": params}, {"bn": stats}


def _code(sd: _SD, key: str) -> dict:
    return {"codebook": sd(f"{key}.codebook")}


def _conv_fold_bias(sd: _SD, key: str) -> tuple[dict, "np.ndarray"]:
    """Consume a torch conv whose bias our generator blocks no longer carry.

    Returns (bias-free conv params, the torch bias). The caller folds the
    bias into the FOLLOWING BatchNorm's running mean: BN(x + b) with batch
    stats equals BN(x) (the shift cancels), and eval-mode equality holds
    when running_mean is shifted by -b — exact in both modes, because torch's
    running_mean was estimated on the biased activations."""
    return _conv(sd, key, bias=False), sd(f"{key}.bias")


def _fold_into_bn(bn_stats: dict, *biases) -> None:
    bn_stats["bn"]["mean"] = bn_stats["bn"]["mean"] - np.sum(biases, axis=0)


def _hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """Index array mapping HWC-flattened positions to CHW-flattened ones.

    The reference flattens/reshapes encoder features in NCHW order
    (mcvae.py:68 ``x.view(x.size(0), -1)``); this framework is NHWC — any
    Dense/BatchNorm1d touching a flattened spatial tensor needs its feature
    axis permuted CHW→HWC or the import silently scrambles the features."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


def _dense_in_perm(sd: _SD, key: str, perm: np.ndarray) -> dict:
    """Linear whose INPUT is a CHW-flattened tensor (encoder mu/logvar)."""
    return {"kernel": sd(f"{key}.weight")[:, perm].T,
            "bias": sd(f"{key}.bias")}


def _dense_out_perm(sd: _SD, key: str, perm: np.ndarray) -> dict:
    """Linear whose OUTPUT is reshaped to (C,H,W) (decoder projection)."""
    return {"kernel": sd(f"{key}.weight")[perm, :].T,
            "bias": sd(f"{key}.bias")[perm]}


def _bn_perm(sd: _SD, key: str, perm: np.ndarray) -> tuple[dict, dict]:
    """BatchNorm1d over CHW-flattened features (decoder.linear BN)."""
    params = {"scale": sd(f"{key}.weight")[perm],
              "bias": sd(f"{key}.bias")[perm]}
    stats = {"mean": sd(f"{key}.running_mean")[perm],
             "var": sd(f"{key}.running_var")[perm]}
    return {"bn": params}, {"bn": stats}


def _mc_resblock(sd: _SD, base: str) -> tuple[dict, dict, dict]:
    """reference mcvae.py:17-35 ResBlock → MCResBlock (conv.{0,1,3,4,5,6})."""
    p, s = {}, {}
    p["Conv_0"] = _conv(sd, f"{base}.conv.0.module")
    p["BatchNorm_0"], s["BatchNorm_0"] = _bn(sd, f"{base}.conv.1.module")
    p["Conv_1"] = _conv(sd, f"{base}.conv.4.module")
    p["BatchNorm_1"], s["BatchNorm_1"] = _bn(sd, f"{base}.conv.5.module")
    c = {"MultimodalController_0": _code(sd, f"{base}.conv.3"),
         "MultimodalController_1": _code(sd, f"{base}.conv.6")}
    return p, s, c


def _resblock(sd: _SD, base: str) -> tuple[dict, dict]:
    """plain ResBlock (reference cvae.py:16-31 / vqvae.py:9-24): unwrapped
    Sequential — conv.{0,1,3,4}."""
    p, s = {}, {}
    p["Conv_0"] = _conv(sd, f"{base}.conv.0")
    p["BatchNorm_0"], s["BatchNorm_0"] = _bn(sd, f"{base}.conv.1")
    p["Conv_1"] = _conv(sd, f"{base}.conv.3")
    p["BatchNorm_1"], s["BatchNorm_1"] = _bn(sd, f"{base}.conv.4")
    return p, s


def convert_mcvae(state_dict: dict, hidden_size, num_res_block: int,
                  res: int = 32) -> dict:
    """reference mcvae.py Encoder/Decoder → MCVAE variables."""
    sd = _SD(state_dict)
    L, R = len(hidden_size), num_res_block
    eh = res // (2 ** L)
    perm = _hwc_perm(hidden_size[-1], eh, eh)
    enc_p, enc_s, enc_c = {}, {}, {}
    for i in range(L):  # (conv, bn, relu, mc) groups: mcvae.py:41-49
        enc_p[f"Conv_{i}"] = _conv(sd, f"encoder.blocks.{4 * i}.module")
        enc_p[f"BatchNorm_{i}"], enc_s[f"BatchNorm_{i}"] = _bn(
            sd, f"encoder.blocks.{4 * i + 1}.module")
        enc_c[f"MultimodalController_{i}"] = _code(
            sd, f"encoder.blocks.{4 * i + 3}")
    for r in range(R):  # mcvae.py:50-51
        p, s, c = _mc_resblock(sd, f"encoder.blocks.{4 * L + r}")
        enc_p[f"MCResBlock_{r}"], enc_s[f"MCResBlock_{r}"] = p, s
        enc_c[f"MCResBlock_{r}"] = c
    enc_p["mu"] = _dense_in_perm(sd, "encoder.mu", perm)
    enc_p["logvar"] = _dense_in_perm(sd, "encoder.logvar", perm)

    dec_p, dec_s, dec_c = {}, {}, {}
    dec_c["MultimodalController_0"] = _code(sd, "decoder.linear.0")
    dec_p["Dense_0"] = _dense_out_perm(sd, "decoder.linear.1.module", perm)
    dec_p["BatchNorm_0"], dec_s["BatchNorm_0"] = _bn_perm(
        sd, "decoder.linear.2.module", perm)
    dec_c["MultimodalController_1"] = _code(sd, "decoder.blocks.0")
    for r in range(R):  # mcvae.py:84-86
        p, s, c = _mc_resblock(sd, f"decoder.blocks.{1 + r}")
        dec_p[f"MCResBlock_{r}"], dec_s[f"MCResBlock_{r}"] = p, s
        dec_c[f"MCResBlock_{r}"] = c
    for g in range(L - 1):  # upsample groups, mcvae.py:87-92
        base = 1 + R + 4 * g
        dec_p[f"ConvTranspose_{g}"] = _convT(sd, f"decoder.blocks.{base}.module")
        dec_p[f"BatchNorm_{1 + g}"], dec_s[f"BatchNorm_{1 + g}"] = _bn(
            sd, f"decoder.blocks.{base + 1}.module")
        dec_c[f"MultimodalController_{2 + g}"] = _code(
            sd, f"decoder.blocks.{base + 3}")
    dec_p[f"ConvTranspose_{L - 1}"] = _convT(
        sd, f"decoder.blocks.{1 + R + 4 * (L - 1)}.module")

    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {
        "params": {"encoder": enc_p, "decoder": dec_p},
        "batch_stats": {"encoder": enc_s, "decoder": dec_s},
        "codebook": {"encoder": enc_c, "decoder": dec_c},
    }


def convert_cvae(state_dict: dict, hidden_size, num_res_block: int,
                 res: int = 32) -> dict:
    """reference cvae.py → CVAE variables (class embedding instead of MC;
    unwrapped Sequentials — no ``.module`` level)."""
    sd = _SD(state_dict)
    L, R = len(hidden_size), num_res_block
    eh = res // (2 ** L)
    perm = _hwc_perm(hidden_size[-1], eh, eh)
    enc_p, enc_s = {}, {}
    enc_p["embedding"] = _dense(sd, "encoder.embedding", bias=False)
    for i in range(L):  # (conv, bn, relu) groups, cvae.py:38-45
        enc_p[f"Conv_{i}"] = _conv(sd, f"encoder.blocks.{3 * i}")
        enc_p[f"BatchNorm_{i}"], enc_s[f"BatchNorm_{i}"] = _bn(
            sd, f"encoder.blocks.{3 * i + 1}")
    for r in range(R):
        p, s = _resblock(sd, f"encoder.blocks.{3 * L + r}")
        enc_p[f"ResBlock_{r}"], enc_s[f"ResBlock_{r}"] = p, s
    enc_p["mu"] = _dense_in_perm(sd, "encoder.mu", perm)
    enc_p["logvar"] = _dense_in_perm(sd, "encoder.logvar", perm)

    dec_p, dec_s = {}, {}
    dec_p["embedding"] = _dense(sd, "decoder.embedding", bias=False)
    dec_p["Dense_0"] = _dense_out_perm(sd, "decoder.linear.0", perm)
    dec_p["BatchNorm_0"], dec_s["BatchNorm_0"] = _bn_perm(
        sd, "decoder.linear.1", perm)
    for r in range(R):
        p, s = _resblock(sd, f"decoder.blocks.{r}")
        dec_p[f"ResBlock_{r}"], dec_s[f"ResBlock_{r}"] = p, s
    for g in range(L - 1):  # (convT, bn, relu) groups, cvae.py:85-88
        base = R + 3 * g
        dec_p[f"ConvTranspose_{g}"] = _convT(sd, f"decoder.blocks.{base}")
        dec_p[f"BatchNorm_{1 + g}"], dec_s[f"BatchNorm_{1 + g}"] = _bn(
            sd, f"decoder.blocks.{base + 1}")
    dec_p[f"ConvTranspose_{L - 1}"] = _convT(
        sd, f"decoder.blocks.{R + 3 * (L - 1)}")

    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {
        "params": {"encoder": enc_p, "decoder": dec_p},
        "batch_stats": {"encoder": enc_s, "decoder": dec_s},
    }


def convert_vqvae(state_dict: dict, hidden_size, num_res_block: int) -> dict:
    """reference vqvae.py → VQVAE variables incl. the EMA ``vq_stats``
    buffers (modules.py:13-16 embedding/cluster_size/embedding_mean)."""
    sd = _SD(state_dict)
    L, R = len(hidden_size), num_res_block
    enc_p, enc_s = {}, {}
    for i in range(L):  # (conv, bn, relu) stages, vqvae.py:29-36
        enc_p[f"Conv_{i}"] = _conv(sd, f"encoder.blocks.{3 * i}")
        enc_p[f"BatchNorm_{i}"], enc_s[f"BatchNorm_{i}"] = _bn(
            sd, f"encoder.blocks.{3 * i + 1}")
    for r in range(R):
        p, s = _resblock(sd, f"encoder.blocks.{3 * L + r}")
        enc_p[f"ResBlock_{r}"], enc_s[f"ResBlock_{r}"] = p, s
    enc_p[f"Conv_{L}"] = _conv(sd, f"encoder.blocks.{3 * L + R}")

    dec_p, dec_s = {}, {}
    dec_p["Conv_0"] = _conv(sd, "decoder.blocks.0")
    dec_p["BatchNorm_0"], dec_s["BatchNorm_0"] = _bn(sd, "decoder.blocks.1")
    for r in range(R):
        p, s = _resblock(sd, f"decoder.blocks.{3 + r}")
        dec_p[f"ResBlock_{r}"], dec_s[f"ResBlock_{r}"] = p, s
    for g in range(L - 1):
        base = 3 + R + 3 * g
        dec_p[f"ConvTranspose_{g}"] = _convT(sd, f"decoder.blocks.{base}")
        dec_p[f"BatchNorm_{1 + g}"], dec_s[f"BatchNorm_{1 + g}"] = _bn(
            sd, f"decoder.blocks.{base + 1}")
    dec_p[f"ConvTranspose_{L - 1}"] = _convT(
        sd, f"decoder.blocks.{3 + R + 3 * (L - 1)}")

    vq = {"quantizer": {"embedding": sd("quantizer.embedding"),
                        "cluster_size": sd("quantizer.cluster_size"),
                        "embedding_mean": sd("quantizer.embedding_mean")}}
    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {
        "params": {"encoder": enc_p, "decoder": dec_p},
        "batch_stats": {"encoder": enc_s, "decoder": dec_s},
        "vq_stats": vq,
    }


def convert_classifier(state_dict: dict, hidden_size, res: int = 32) -> dict:
    """reference classifier.py → Classifier variables (4 conv-bn-relu[-pool]
    stages at Sequential indices 0,4,8,12 + CHW-flattened linear head)."""
    sd = _SD(state_dict)
    p, s = {}, {}
    for i in range(4):
        p[f"Conv_{i}"] = _conv(sd, f"blocks.{4 * i}")
        p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"] = _bn(sd, f"blocks.{4 * i + 1}")
    eh = res // (2 ** (len(hidden_size) - 1))
    perm = _hwc_perm(hidden_size[-1], eh, eh)
    p["classifier"] = _dense_in_perm(sd, "classifier", perm)
    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {"params": p, "batch_stats": s}


def _snconv(sd: _SD, key: str) -> tuple[dict, dict]:
    """torch.nn.utils.spectral_norm'd conv: weight_orig → raw kernel,
    weight_u → the power-iteration u vector (out-dim space, identical in
    both frameworks); weight_v is consumed but dropped — this framework
    recomputes v from u each call (same torch power-iteration semantics,
    and sigma is invariant to our fan-in flattening order)."""
    p = {"kernel": sd(f"{key}.weight_orig").transpose(2, 3, 1, 0),
         "bias": sd(f"{key}.bias")}
    sd(f"{key}.weight_v")
    return p, {"u": sd(f"{key}.weight_u")}


def _sndense(sd: _SD, key: str, bias: bool = True) -> tuple[dict, dict]:
    p = {"kernel": sd(f"{key}.weight_orig").T}
    if bias:
        p["bias"] = sd(f"{key}.bias")
    sd(f"{key}.weight_v")
    return p, {"u": sd(f"{key}.weight_u")}


def convert_mcgan(state_dict: dict, generator_hidden_size,
                  discriminator_hidden_size, cifar_style: bool = True,
                  res: int = 32) -> dict:
    """reference mcgan.py → MCGAN variables.

    Generator blocks (mcgan.py:9-45): shared mc_1/mc_2 appear in the torch
    state_dict under BOTH their attribute path and their Sequential alias
    paths (conv.3/conv.7/shortcut.1) — aliases are consumed and dropped.
    Discriminator: every Linear/Conv2d is spectral-normalized
    (utils.py:17-21) → weight_orig/u/v triplets (see ``_snconv``).
    """
    sd = _SD(state_dict)
    gh, dh = generator_hidden_size, discriminator_hidden_size
    Lg = len(gh)
    start = res >> (Lg - 1)

    g_p, g_s, g_c = {}, {}, {}
    g_p["Dense_0"] = _dense_out_perm(sd, "generator.linear.module",
                                     _hwc_perm(gh[0], start, start))
    carry_bias = None  # LAST block's Conv_1+Conv_2 biases -> head BN_0
    for i in range(Lg - 1):
        b = f"generator.blocks.{i}"
        last = i == Lg - 2
        bp, bs, bc = {}, {}, {}
        bp["BatchNorm_0"], bs["BatchNorm_0"] = _bn(sd, f"{b}.conv.0.module")
        bp["Conv_0"], b0 = _conv_fold_bias(sd, f"{b}.conv.4.module")
        bp["BatchNorm_1"], bs["BatchNorm_1"] = _bn(sd, f"{b}.conv.5.module")
        _fold_into_bn(bs["BatchNorm_1"], b0)
        if last:  # tail_bias_free: output feeds the head BN with no bypass
            bp["Conv_1"], b1 = _conv_fold_bias(sd, f"{b}.conv.8.module")
            bp["Conv_2"], b2 = _conv_fold_bias(sd, f"{b}.shortcut.2.module")
            carry_bias = (b1, b2)
        else:  # non-final Conv_1/Conv_2 biases are live (shortcut bypass)
            bp["Conv_1"] = _conv(sd, f"{b}.conv.8.module")
            bp["Conv_2"] = _conv(sd, f"{b}.shortcut.2.module")
        bc["mc_1"] = _code(sd, f"{b}.mc_1")
        bc["mc_2"] = _code(sd, f"{b}.mc_2")
        for alias in (f"{b}.conv.3", f"{b}.conv.7", f"{b}.shortcut.1"):
            sd(f"{alias}.codebook")  # shared-module aliases
        name = f"_MCGenResBlock_{i}"
        g_p[name], g_s[name], g_c[name] = bp, bs, bc
    g_p["BatchNorm_0"], g_s["BatchNorm_0"] = _bn(
        sd, f"generator.blocks.{Lg - 1}.module")
    if carry_bias is not None:
        _fold_into_bn(g_s["BatchNorm_0"], *carry_bias)
    g_c["MultimodalController_0"] = _code(sd, f"generator.blocks.{Lg + 1}")
    g_p["Conv_0"] = _conv(sd, f"generator.blocks.{Lg + 2}.module")

    d_p, d_c, d_u = {}, {}, {}
    b = "discriminator.blocks.0"
    fp, fu = {}, {}
    fp["SNConv_0"], fu["SNConv_0"] = _snconv(sd, f"{b}.conv.0.module")
    fp["SNConv_1"], fu["SNConv_1"] = _snconv(sd, f"{b}.conv.3.module")
    fp["SNConv_2"], fu["SNConv_2"] = _snconv(sd, f"{b}.shortcut.0.module")
    d_c["_MCFirstDisResBlock_0"] = {"mc_1": _code(sd, f"{b}.mc_1")}
    sd(f"{b}.conv.2.codebook")
    d_p["_MCFirstDisResBlock_0"], d_u["_MCFirstDisResBlock_0"] = fp, fu
    n_tail = 2 if cifar_style else 1
    for i in range(len(dh) - 1):
        b = f"discriminator.blocks.{1 + i}"
        stride2 = i < len(dh) - 1 - n_tail
        bp, bu, bc = {}, {}, {}
        bp["SNConv_0"], bu["SNConv_0"] = _snconv(sd, f"{b}.conv.2.module")
        bp["SNConv_1"], bu["SNConv_1"] = _snconv(sd, f"{b}.conv.5.module")
        bc["mc_1"] = _code(sd, f"{b}.mc_1")
        bc["mc_2"] = _code(sd, f"{b}.mc_2")
        sd(f"{b}.conv.1.codebook"), sd(f"{b}.conv.4.codebook")
        if stride2 or dh[i] != dh[i + 1]:
            bp["SNConv_2"], bu["SNConv_2"] = _snconv(
                sd, f"{b}.shortcut.1.module" if stride2
                else f"{b}.shortcut.1")
            sd(f"{b}.shortcut.0.codebook")
        name = f"_MCDisResBlock_{i}"
        d_p[name], d_u[name], d_c[name] = bp, bu, bc
    tail = len(dh)
    d_c["MultimodalController_0"] = _code(sd, f"discriminator.blocks.{tail + 1}")
    d_p["SNDense_0"], d_u["SNDense_0"] = _sndense(
        sd, f"discriminator.blocks.{tail + 3}.module")

    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {
        "params": {"generator": g_p, "discriminator": d_p},
        "batch_stats": {"generator": g_s},
        "codebook": {"generator": g_c, "discriminator": d_c},
        "spectral": {"discriminator": d_u},
    }


def convert_mcpixelcnn(state_dict: dict, num_layer: int) -> dict:
    """reference mcpixelcnn.py MCGatedPixelCNN → MCPixelCNN variables.

    Mask-A weight zeroing is a no-op for the import: the reference zeroes
    masked taps in-place (mcpixelcnn.py:43-49) while this framework
    multiplies a constant mask at apply time — either way those taps never
    contribute."""
    sd = _SD(state_dict)
    p = {"embedding": {"embedding": sd("embedding.weight")}}
    s, c = {}, {}
    for l in range(num_layer):
        b = f"layers.{l}"
        lp, ls, lc = {}, {}, {}
        lp["vert_stack"] = _conv(sd, f"{b}.vert_stack")
        lp["horiz_stack"] = _conv(sd, f"{b}.horiz_stack")
        lp["vert_to_horiz"] = _conv(sd, f"{b}.vert_to_horiz")
        for gate in ("gate_v", "gate_h"):
            bnp, bns = _bn(sd, f"{b}.{gate}.bn")
            lp[gate] = {"BatchNorm_0": bnp}
            ls[gate] = {"BatchNorm_0": bns}
            lc[gate] = {"MultimodalController_0": _code(sd, f"{b}.{gate}.mc")}
        lp["horiz_resid_conv"] = _conv(sd, f"{b}.horiz_resid.0.module")
        lp["horiz_resid_bn"], ls["horiz_resid_bn"] = _bn(
            sd, f"{b}.horiz_resid.1.module")
        lc["horiz_resid_mc"] = _code(sd, f"{b}.horiz_resid.2")
        p[f"layer_{l}"], s[f"layer_{l}"], c[f"layer_{l}"] = lp, ls, lc
    hp, hs = {}, {}
    hp["Conv_0"] = _conv(sd, "output_conv.0.module")
    hp["BatchNorm_0"], hs["BatchNorm_0"] = _bn(sd, "output_conv.1.module")
    hp["Conv_1"] = _conv(sd, "output_conv.4.module")
    p["head"], s["head"] = hp, hs
    c["head"] = {"MultimodalController_0": _code(sd, "output_conv.3")}
    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {"params": p, "batch_stats": s, "codebook": c}


def _actnorm(sd: _SD, key: str) -> dict:
    """(1,C,1,1) loc/scale → (C,); the 'initialized' DDI flag is consumed —
    imported checkpoints are data-dependent-initialized already, and this
    framework's DDI is an explicit pass, not a first-call side effect."""
    out = {"loc": sd(f"{key}.loc").ravel(), "scale": sd(f"{key}.scale").ravel()}
    sd(f"{key}.initialized")
    return out


def convert_mcglow(state_dict: dict, K: int, L: int) -> dict:
    """reference mcglow.py → MCGlow variables (``scan_flows=False`` layout:
    per-flow subtrees; ``nn.scan`` users can stack flow_k leaves on axis 0).

    Per flow: actnorm, LU invconv (trainable w_l/w_s/w_u + frozen
    w_p/s_sign into ``glow_const``; the constant masks are dropped — this
    framework rebuilds them from ``jnp.tril``/``eye``), affine-coupling net
    (conv, actnorm, MC, 1x1 conv, actnorm, MC, zero-conv with scale)."""
    sd = _SD(state_dict)
    p, c, g = {}, {}, {}
    for i in range(L):
        bp, bc, bg = {}, {}, {}
        for k in range(K):
            f = f"blocks.{i}.flows.{k}"
            fp, fc, fg = {}, {}, {}
            fp["actnorm"] = _actnorm(sd, f"{f}.actnorm")
            fp["invconv"] = {"w_l": sd(f"{f}.invconv.w_l"),
                             "w_s": sd(f"{f}.invconv.w_s"),
                             "w_u": sd(f"{f}.invconv.w_u")}
            fg["invconv"] = {"const": {"w_p": sd(f"{f}.invconv.w_p"),
                                       "s_sign": sd(f"{f}.invconv.s_sign")}}
            for const in ("u_mask", "l_mask", "l_eye"):
                sd(f"{f}.invconv.{const}")  # rebuilt from tril/eye
            net_p = {
                "Conv_0": _conv(sd, f"{f}.coupling.net.0.module"),
                "ActNorm_0": _actnorm(sd, f"{f}.coupling.net.1.module"),
                "Conv_1": _conv(sd, f"{f}.coupling.net.4.module"),
                "ActNorm_1": _actnorm(sd, f"{f}.coupling.net.5.module"),
                "ZeroConv2d_0": {
                    "conv": _conv(sd, f"{f}.coupling.net.8.module.conv"),
                    "scale": sd(f"{f}.coupling.net.8.module.scale").ravel()},
            }
            net_c = {
                "MultimodalController_0": _code(sd, f"{f}.coupling.net.3"),
                "MultimodalController_1": _code(sd, f"{f}.coupling.net.7"),
            }
            fp["coupling"] = {"net": net_p}
            fc["coupling"] = {"net": net_c}
            bp[f"flow_{k}"], bc[f"flow_{k}"], bg[f"flow_{k}"] = fp, fc, fg
        bp["prior"] = {"conv": _conv(sd, f"blocks.{i}.prior.conv"),
                       "scale": sd(f"blocks.{i}.prior.scale").ravel()}
        p[f"block_{i}"], c[f"block_{i}"], g[f"block_{i}"] = bp, bc, bg
    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {"params": p, "codebook": c, "glow_const": g}


def convert_cgan(state_dict: dict, generator_hidden_size,
                 discriminator_hidden_size, cifar_style: bool = True,
                 res: int = 32) -> dict:
    """reference cgan.py → CGAN variables (class embeddings, unwrapped
    Sequentials; the discriminator embedding is spectral-normalized too)."""
    sd = _SD(state_dict)
    gh, dh = generator_hidden_size, discriminator_hidden_size
    Lg = len(gh)
    start = res >> (Lg - 1)

    g_p, g_s = {}, {}
    g_p["embedding"] = _dense(sd, "generator.embedding", bias=False)
    g_p["Dense_0"] = _dense_out_perm(sd, "generator.linear",
                                     _hwc_perm(gh[0], start, start))
    carry_bias = None  # see convert_mcgan: dead conv biases fold into BN
    for i in range(Lg - 1):  # cgan.py GenResBlock: conv.{0,3,4,6}, shortcut.1
        b = f"generator.blocks.{i}"
        last = i == Lg - 2
        bp, bs = {}, {}
        bp["BatchNorm_0"], bs["BatchNorm_0"] = _bn(sd, f"{b}.conv.0")
        bp["Conv_0"], b0 = _conv_fold_bias(sd, f"{b}.conv.3")
        bp["BatchNorm_1"], bs["BatchNorm_1"] = _bn(sd, f"{b}.conv.4")
        _fold_into_bn(bs["BatchNorm_1"], b0)
        if last:  # tail_bias_free (see convert_mcgan)
            bp["Conv_1"], b1 = _conv_fold_bias(sd, f"{b}.conv.6")
            bp["Conv_2"], b2 = _conv_fold_bias(sd, f"{b}.shortcut.1")
            carry_bias = (b1, b2)
        else:
            bp["Conv_1"] = _conv(sd, f"{b}.conv.6")
            bp["Conv_2"] = _conv(sd, f"{b}.shortcut.1")
        name = f"_CGenResBlock_{i}"
        g_p[name], g_s[name] = bp, bs
    g_p["BatchNorm_0"], g_s["BatchNorm_0"] = _bn(
        sd, f"generator.blocks.{Lg - 1}")
    if carry_bias is not None:
        _fold_into_bn(g_s["BatchNorm_0"], *carry_bias)
    g_p["Conv_0"] = _conv(sd, f"generator.blocks.{Lg + 1}")

    d_p, d_u = {}, {}
    d_p["embedding"], d_u["embedding"] = _sndense(
        sd, "discriminator.embedding", bias=False)
    b = "discriminator.blocks.0"
    fp, fu = {}, {}
    fp["SNConv_0"], fu["SNConv_0"] = _snconv(sd, f"{b}.conv.0")
    fp["SNConv_1"], fu["SNConv_1"] = _snconv(sd, f"{b}.conv.2")
    fp["SNConv_2"], fu["SNConv_2"] = _snconv(sd, f"{b}.shortcut.0")
    d_p["_CFirstDisResBlock_0"], d_u["_CFirstDisResBlock_0"] = fp, fu
    n_tail = 2 if cifar_style else 1
    for i in range(len(dh) - 1):
        b = f"discriminator.blocks.{1 + i}"
        stride2 = i < len(dh) - 1 - n_tail
        bp, bu = {}, {}
        bp["SNConv_0"], bu["SNConv_0"] = _snconv(sd, f"{b}.conv.1")
        bp["SNConv_1"], bu["SNConv_1"] = _snconv(sd, f"{b}.conv.3")
        if stride2 or dh[i] != dh[i + 1]:
            bp["SNConv_2"], bu["SNConv_2"] = _snconv(sd, f"{b}.shortcut.0")
        name = f"_CDisResBlock_{i}"
        d_p[name], d_u[name] = bp, bu
    d_p["SNDense_0"], d_u["SNDense_0"] = _sndense(
        sd, f"discriminator.blocks.{len(dh) + 2}")

    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {
        "params": {"generator": g_p, "discriminator": d_p},
        "batch_stats": {"generator": g_s},
        "spectral": {"discriminator": d_u},
    }


def convert_cpixelcnn(state_dict: dict, num_layer: int) -> dict:
    """reference cpixelcnn.py → CPixelCNN variables (per-class cond-bias
    embeddings instead of MC; unwrapped Sequentials)."""
    sd = _SD(state_dict)
    p = {"embedding": {"embedding": sd("embedding.weight")}}
    s = {}
    for l in range(num_layer):
        b = f"layers.{l}"
        lp, ls = {}, {}
        lp["class_cond_embedding"] = {
            "embedding": sd(f"{b}.class_cond_embedding.weight")}
        lp["vert_stack"] = _conv(sd, f"{b}.vert_stack")
        lp["horiz_stack"] = _conv(sd, f"{b}.horiz_stack")
        lp["vert_to_horiz"] = _conv(sd, f"{b}.vert_to_horiz")
        for gate in ("gate_v", "gate_h"):
            bnp, bns = _bn(sd, f"{b}.{gate}.bn")
            lp[gate] = {"BatchNorm_0": bnp}
            ls[gate] = {"BatchNorm_0": bns}
        lp["horiz_resid_conv"] = _conv(sd, f"{b}.horiz_resid.0")
        lp["horiz_resid_bn"], ls["horiz_resid_bn"] = _bn(
            sd, f"{b}.horiz_resid.1")
        p[f"layer_{l}"], s[f"layer_{l}"] = lp, ls
    hp, hs = {}, {}
    hp["Conv_0"] = _conv(sd, "output_conv.0")
    hp["BatchNorm_0"], hs["BatchNorm_0"] = _bn(sd, "output_conv.1")
    hp["Conv_1"] = _conv(sd, "output_conv.3")
    p["head"], s["head"] = hp, hs
    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {"params": p, "batch_stats": s}


def convert_cglow(state_dict: dict, K: int, L: int) -> dict:
    """reference cglow.py → CGlow variables: like mcglow but no MC (net
    indices 0/1/3/4/6) and a conditional-prior embedding ZeroConv on the
    final block (cglow.py:214,233)."""
    sd = _SD(state_dict)
    p, g = {}, {}
    for i in range(L):
        bp, bg = {}, {}
        for k in range(K):
            f = f"blocks.{i}.flows.{k}"
            fp, fg = {}, {}
            fp["actnorm"] = _actnorm(sd, f"{f}.actnorm")
            fp["invconv"] = {"w_l": sd(f"{f}.invconv.w_l"),
                             "w_s": sd(f"{f}.invconv.w_s"),
                             "w_u": sd(f"{f}.invconv.w_u")}
            fg["invconv"] = {"const": {"w_p": sd(f"{f}.invconv.w_p"),
                                       "s_sign": sd(f"{f}.invconv.s_sign")}}
            for const in ("u_mask", "l_mask", "l_eye"):
                sd(f"{f}.invconv.{const}")
            fp["coupling"] = {"net": {
                "Conv_0": _conv(sd, f"{f}.coupling.net.0"),
                "ActNorm_0": _actnorm(sd, f"{f}.coupling.net.1"),
                "Conv_1": _conv(sd, f"{f}.coupling.net.3"),
                "ActNorm_1": _actnorm(sd, f"{f}.coupling.net.4"),
                "ZeroConv2d_0": {
                    "conv": _conv(sd, f"{f}.coupling.net.6.conv"),
                    "scale": sd(f"{f}.coupling.net.6.scale").ravel()},
            }}
            bp[f"flow_{k}"], bg[f"flow_{k}"] = fp, fg
        bp["prior"] = {"conv": _conv(sd, f"blocks.{i}.prior.conv"),
                       "scale": sd(f"blocks.{i}.prior.scale").ravel()}
        if f"blocks.{i}.embedding.conv.weight" in sd.sd:
            emb = {"conv": _conv(sd, f"blocks.{i}.embedding.conv"),
                   "scale": sd(f"blocks.{i}.embedding.scale").ravel()}
            if i == L - 1:
                bp["embedding"] = emb
            # else: the reference constructs the cond-prior embedding on
            # EVERY block but only uses it on the final (split=False) one
            # (cglow.py:212-233) — dead params, consumed and dropped
        p[f"block_{i}"], g[f"block_{i}"] = bp, bg
    if sd.unused():
        raise ValueError(f"unmapped reference keys: {sd.unused()[:8]}")
    return {"params": p, "glow_const": g}


def stack_glow_flows(variables: dict) -> dict:
    """Imported Glow variables from the per-flow layout (``block_i/flow_k``,
    ``scan_flows=False``) to the scanned one (``block_i/flows/flow`` with
    every leaf stacked on axis 0), as the port's checkpoints hold them."""
    return pack_glow_flows(variables, 1)


CONVERTERS = {
    "mcvae": convert_mcvae,
    "cvae": convert_cvae,
    "vqvae": convert_vqvae,
    "classifier": convert_classifier,
    "mcgan": convert_mcgan,
    "cgan": convert_cgan,
    "mcpixelcnn": convert_mcpixelcnn,
    "cpixelcnn": convert_cpixelcnn,
    "mcglow": convert_mcglow,
    "cglow": convert_cglow,
}


def convert(model_name: str, state_dict: dict, **dims) -> dict:
    if model_name not in CONVERTERS:
        raise NotImplementedError(
            f"no torch importer for {model_name!r} yet "
            f"(have: {sorted(CONVERTERS)})")
    return CONVERTERS[model_name](state_dict, **dims)


def reference_dims(cfg: dict) -> dict:
    """The dimensions the converter of ``cfg['model_name']`` takes, from a
    processed config (the port's ``process_control``)."""
    name = cfg["model_name"]
    res = cfg["data_shape"][0]
    if name in ("mcvae", "cvae"):
        return dict(hidden_size=cfg["vae"]["hidden_size"],
                    num_res_block=cfg["vae"]["num_res_block"], res=res)
    if name == "vqvae":
        return dict(hidden_size=cfg["vqvae"]["hidden_size"],
                    num_res_block=cfg["vqvae"]["num_res_block"])
    if name == "classifier":
        return dict(hidden_size=cfg["classifier"]["hidden_size"], res=res)
    if name in ("mcgan", "cgan"):
        return dict(generator_hidden_size=cfg["gan"]["generator_hidden_size"],
                    discriminator_hidden_size=cfg["gan"]["discriminator_hidden_size"],
                    cifar_style=cfg["data_name"] in ("CIFAR10", "CIFAR100"), res=res)
    if name in ("mcpixelcnn", "cpixelcnn"):
        return dict(num_layer=cfg["pixelcnn"]["num_layer"])
    if name in ("mcglow", "cglow"):
        return dict(K=cfg["glow"]["K"], L=cfg["glow"]["L"])
    raise NotImplementedError(f"no torch importer for {name!r} (have: {sorted(CONVERTERS)})")


def load_reference(model_name: str, state_dict: dict, **dims) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a reference ``state_dict``: the model
    of ``model_name`` built with the same dimensions loads it and computes
    the reference model's function."""
    return from_jax_variables(convert(model_name, state_dict, **dims))
