"""Mode creation and transition for the GAN, VAE, PixelCNN and Glow families. Port of
``mcgm_tpu/models/manipulate.py`` (``create``, ``create_torch_compat``,
``transit``, ``transit_codebook``, ``transit_embedding``).

Each function reads a model's ``state_dict`` and returns a new one; the
model itself is left as it was (entries that do not change are the model's
own tensors, so load the result into a copy, as ``Sampler.with_state``
does). What changes:

- every MultimodalController ``codebook`` (``[num_mode, C]``);
- the class embeddings of CGAN and CVAE: the bias-free ``embedding`` Dense
  of G (CVAE: of the encoder and of the decoder) and ``SNDense`` of D,
  whose port weight is ``[emb, num_mode]`` (mode axis 1; the JAX kernel is
  its transpose); CPixelCNN's ``class_cond_embedding`` tables
  ``[num_mode, 2h]`` (mode axis 0, as in the JAX package); CGlow's prior
  ``embedding`` 1x1 conv, port weight ``[out, num_mode, 1, 1]`` (mode axis
  1; the JAX kernel's axis 2).

``create`` draws ``classes_size`` new modes: fresh codebooks, and Dirichlet
convex mixes of the trained embedding rows; the caller rebuilds the model
with that many modes. ``transit`` moves every mode toward ``root``.

The order of the draws is the JAX package's, so the same seed gives the same
modes: ``create`` visits leaves as ``jax.tree_util`` flattens the flax
variables, by sorted path (collection first, so codebooks before
embeddings, and ``_MCDisResBlock_10`` before ``_MCDisResBlock_2``), with one
counter across both kinds; ``create_torch_compat`` draws from one CPU
``torch.Generator`` seeded once, in the reference's ``named_modules``
order. A Glow's leaves are visited in the JAX tree of its export layout:
with ``scan_flows`` (the default) each MC position of a block is one
``[K, num_mode, C]`` leaf, whose flow ``i`` codebook is
``make_codebook(rng_seed + 1000 * counter + i, ...)``; the reference's
stream draws a block's codebooks flow by flow, ``MC_0`` before ``MC_1``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from ..io.jax_import import from_jax_variables, jax_leaves, to_jax_gan_variables
from ..ops.controller import make_codebook


def _matched(model: nn.Module) -> list:
    """``(state key, JAX path, mode axis or None for a codebook, tensor)``
    of every codebook and class embedding, in ``jax.tree_util`` order."""
    out = []
    for key, path, t in jax_leaves(model):
        if path[-1] == "codebook":
            out.append((key, path, None, t))
        elif "embedding" in path and path[path.index("embedding") + 1:] == ("kernel",):
            out.append((key, path, 1, t))
        elif path[-2:] == ("class_cond_embedding", "embedding"):
            out.append((key, path, 0, t))
        elif path[-3:] == ("embedding", "conv", "kernel"):  # CGlow's prior embedding
            out.append((key, path, 1, t))
    return sorted(out, key=lambda m: m[1])


def _mix_rows(weight: torch.Tensor, mix: np.ndarray, axis: int) -> torch.Tensor:
    """A ``[new_modes, old_modes]`` row-mixing matrix applied along ``axis``."""
    w = weight.detach().movedim(axis, 0)
    mixed = torch.tensordot(torch.as_tensor(mix, dtype=w.dtype, device=w.device), w, dims=1)
    return mixed.movedim(0, axis).contiguous()


def _nat(name: str) -> int:
    m = re.search(r"_(\d+)$", str(name))
    return int(m.group(1)) if m else -1


def _ref_order_key(family: str, parts: tuple):
    """The reference's ``named_modules`` order of a model's matched leaves
    (``parts``: the path below the collection). GAN: G before D; in each,
    the blocks in order (the first D-block first), ``mc_1`` before ``mc_2``,
    then the trailing controller or embedding. VAE: encoder before decoder;
    the encoder's controllers (or embedding), then its residual blocks; the
    decoder's ``MultimodalController_0`` and ``_1``, its residual blocks,
    then ``MultimodalController_2`` on. PixelCNN: the layers in order
    (``gate_v``, ``gate_h``, ``horiz_resid_mc``, or the layer's class
    embedding), then the head. Glow: block by block, flow by flow,
    ``MultimodalController_0`` before ``_1``."""
    if family == "glow":
        return (_nat(parts[0]), _nat(parts[1]) if parts[1].startswith("flow_") else -1,
                max(_nat(parts[-2]), 0))
    if family == "pixelcnn":
        if parts[0] == "head":
            return (1, 0, 0)
        sub = {"gate_v": 0, "gate_h": 1, "horiz_resid_mc": 2}.get(parts[1], 0)
        return (0, _nat(parts[0]), sub)
    top = {"generator": 0, "discriminator": 1, "encoder": 0, "decoder": 1}.get(parts[0], 9)
    name = parts[1] if len(parts) > 1 else ""
    if family == "vae":
        if name.startswith("MCResBlock"):
            return (top, 1, _nat(name), _nat(parts[2]))
        i = _nat(name)
        return (top, 2 if top == 1 and i >= 2 else 0, i, 0)
    if name.startswith("_MC") or name.startswith("_C"):
        blk = -1 if "First" in name else _nat(name)
        return (top, 0, blk, 0 if parts[2] == "mc_1" else 1)
    return (top, 1, 0, 0)


def _torch_create_codebook(g: torch.Generator, classes_size: int, features: int) -> np.ndarray:
    """The reference's ``create_codebook``: Bernoulli(0.5) batches of
    ``[classes_size, features]`` deduped through a set of float tuples, the
    first ``classes_size`` rows in set order."""
    out: set = set()
    while len(out) < classes_size:
        batch = torch.bernoulli(torch.tensor(0.5).expand(classes_size, features), generator=g)
        out.update(tuple(c) for c in batch.tolist())
    return np.asarray(list(out)[:classes_size], np.float32)


def _torch_create_mix(g: torch.Generator, classes_size: int, old_modes: int) -> np.ndarray:
    """The reference's Dirichlet(1) convex weights ``[classes_size, old_modes]``."""
    conc = torch.ones(old_modes).expand(classes_size, old_modes)
    return torch._sample_dirichlet(conc, generator=g).numpy().astype(np.float32)


def create_torch_compat(model: nn.Module, classes_size: int, seed: int,
                        model_name: str) -> dict:
    """The reference's ``create`` stream: ``torch.manual_seed(seed)`` once,
    then codebooks and Dirichlet mixes drawn module by module. As in the
    reference, CGAN's D embedding consumes a draw and keeps its weight (its
    spectral norm recomputes the weight from the original)."""
    family = next((f for f in ("vae", "gan", "pixelcnn", "glow") if f in model_name), None)
    if family is None:
        raise NotImplementedError(
            f"create for {model_name!r}: only the GAN, VAE, PixelCNN and Glow families are "
            "ported (ROADMAP Queue A)")
    g = torch.Generator().manual_seed(seed)
    state = dict(model.state_dict())
    for key, path, axis, t in sorted(_matched(model),
                                     key=lambda m: _ref_order_key(family, m[1][1:])):
        if axis is None:
            state[key] = torch.from_numpy(
                _torch_create_codebook(g, classes_size, t.shape[-1])).to(t.device)
            continue
        mix = _torch_create_mix(g, classes_size, t.shape[axis])
        if path[1] != "discriminator":  # CGAN's D: a dead draw
            state[key] = _mix_rows(t, mix, axis)
    return state


def create(model: nn.Module, classes_size: int, rng_seed: int = 0,
           torch_compat: bool = False, model_name: str = "") -> dict:
    """The ``state_dict`` of ``model`` with ``classes_size`` new modes:
    codebook ``i`` (counting from 1) is ``make_codebook(rng_seed + i,
    classes_size, C, 0.5)``; an embedding met when the counter is ``i`` mixes
    its rows by ``default_rng((rng_seed, i, old_modes)).dirichlet``."""
    if torch_compat:
        return create_torch_compat(model, classes_size, rng_seed, model_name)
    if getattr(model, "scan_flows", False):
        return _create_glow_scanned(model, classes_size, rng_seed)
    state = dict(model.state_dict())
    counter = 0
    for key, _, axis, t in _matched(model):
        if axis is None:
            counter += 1
            state[key] = torch.from_numpy(
                make_codebook(rng_seed + counter, classes_size, t.shape[-1], 0.5)).to(t.device)
        else:
            old_modes = t.shape[axis]
            rng = np.random.default_rng((rng_seed, counter, old_modes))
            counter += 1
            state[key] = _mix_rows(t, rng.dirichlet(np.ones(old_modes), size=classes_size),
                                   axis)
    return state


def _sorted_leaves(tree: dict, path=()):
    """``(path, leaf)`` of a nested dict in ``jax.tree_util``'s order (keys
    sorted at every level)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _sorted_leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _create_glow_scanned(model: nn.Module, classes_size: int, rng_seed: int) -> dict:
    """``create`` over a Glow's JAX tree in its scanned layout: a stacked
    codebook leaf draws ``make_codebook(rng_seed + 1000 * counter + i)`` for
    its row ``i``, the embedding kernel mixes along axis 2."""
    tree = to_jax_gan_variables(model)
    counter = 0
    for path, leaf in _sorted_leaves(tree):
        node = tree
        for k in path[:-1]:
            node = node[k]
        if path[-1] == "codebook":
            counter += 1
            node[path[-1]] = np.stack([make_codebook(rng_seed + 1000 * counter + i,
                                                     classes_size, leaf.shape[-1], 0.5)
                                       for i in range(leaf.shape[0])])
        elif path[-3:] == ("embedding", "conv", "kernel"):
            old_modes = leaf.shape[2]
            rng = np.random.default_rng((rng_seed, counter, old_modes))
            counter += 1
            mix = rng.dirichlet(np.ones(old_modes), size=classes_size)
            node[path[-1]] = np.moveaxis(np.tensordot(mix.astype(np.float32),
                                                      np.moveaxis(leaf, 2, 0), 1), 0, 2)
    dev = next(model.parameters()).device
    return {k: t.to(dev) for k, t in from_jax_variables(tree).items()}


def transit_codebook(codebook: np.ndarray, root: int, alpha: float) -> np.ndarray:
    """Crossover toward the root mask: the first ``round((1 - alpha) C)``
    entries of every row (Python's half-to-even rounding) become the root's."""
    cb = np.array(codebook)
    root_code = cb[root].copy()
    cross = int(round((1 - alpha) * cb.shape[1]))
    cb[:, :cross] = root_code[:cross]
    cb[root] = root_code
    return cb


def transit_embedding(weight: np.ndarray, root: int, alpha: float, axis: int) -> np.ndarray:
    """Linear interpolation of every mode's row toward the root's."""
    w = np.moveaxis(np.array(weight), axis, 0)
    root_row = w[root].copy()
    w = alpha * w + (1 - alpha) * root_row
    w[root] = root_row
    return np.moveaxis(w, 0, axis)


def transit(model: nn.Module, root: int, alpha: float) -> dict:
    """The ``state_dict`` of ``model`` with every mode moved toward ``root``
    by ``alpha`` (1 leaves it, 0 makes it the root). Always from the trained
    model: calls with different alphas are independent."""
    state = dict(model.state_dict())
    for key, _, axis, t in _matched(model):
        a = t.detach().cpu().numpy()
        new = (transit_codebook(a, root, alpha) if axis is None
               else transit_embedding(a, root, alpha, axis))
        state[key] = torch.from_numpy(np.ascontiguousarray(new)).to(t.device)
    return state
