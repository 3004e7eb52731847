"""Map the JAX package's flax variables onto the port's ``state_dict``, and
back.

Input: ``{"params", "batch_stats", "spectral", "codebook", "vq_stats"}`` as
nested dicts of numpy arrays, as ``mcgm_tpu`` checkpoints hold them under
``model_dict``. The port's modules carry the flax module names, so a
variable's path maps to a key by rule:

- a path component naming a residual block (``_MC...ResBlock_i``,
  ``_C...ResBlock_i``) sits under the owning ``blocks`` dict; BatchNorm's inner ``bn`` scope is dropped;
- ``kernel`` -> ``weight``, HWIO -> OIHW for convs, HWIO -> ``[in, out,
  kh, kw]`` for transposed convs (modules named ``ConvTranspose_i``; the JAX
  package flips its kernel where it applies it, so the transpose alone is
  torch's weight) and ``[in,out]`` ->
  ``[out,in]`` for dense layers; an ``Embed``'s ``embedding`` table ->
  ``weight`` as it is; BatchNorm ``scale`` -> ``weight``,
  ``mean``/``var`` -> ``running_mean``/``running_var``; spectral ``u``,
  ``codebook`` and the quantizer's ``vq_stats`` (``embedding``,
  ``cluster_size``, ``embedding_mean``) keep their names.

The inverse, :func:`to_jax_gan_variables`, walks the port's modules, so a
checkpoint the port writes holds the JAX package's variable tree and either
package reads it. InceptionV3 keeps torchvision's module layout (``conv`` /
``bn`` scopes inside each ``BasicConv2d``, ``fc``), which the JAX package's
flax port names the same way: :func:`from_jax_inception` and
:func:`to_jax_inception` map it one to one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import layers
from ..ops.vq import VectorQuantizerEMA

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "embedding"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("spectral", "u"): "u",
    ("codebook", "codebook"): "codebook",
    ("vq_stats", "embedding"): "embedding",
    ("vq_stats", "cluster_size"): "cluster_size",
    ("vq_stats", "embedding_mean"): "embedding_mean",
}
_COLLECTIONS = ("params", "batch_stats", "spectral", "codebook", "vq_stats")


def _walk(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _key(parts, name: str) -> str:
    out = []
    for p in parts:
        if p == "bn":
            continue
        if p.startswith("_") and "ResBlock_" in p:
            out.append("blocks")
        out.append(p)
    return ".".join(out + [name])


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """A ``state_dict`` that makes the port compute the JAX model's function."""
    state = {}
    for collection in _COLLECTIONS:
        for path, arr in _walk(variables.get(collection, {})):
            *mod, leaf = path
            name = _LEAF.get((collection, leaf))
            if name is None:
                raise KeyError(f"unknown variable {collection}/{'/'.join(path)}")
            a = np.asarray(arr, np.float32)
            if leaf == "kernel":
                a = _kernel_from_jax(a, bool(mod) and mod[-1].startswith("ConvTranspose"))
            state[_key(mod, name)] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return state


def from_jax_gan_train_state(g_params, d_params, state) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a JAX ``GANTrainState``'s generator and
    discriminator parameters and its mutable collections (``ts.state``:
    BatchNorm statistics, spectral ``u``, codebooks)."""
    return from_jax_variables({"params": {"generator": g_params, "discriminator": d_params},
                               **state})


def _kernel_from_jax(a: np.ndarray, transposed: bool) -> np.ndarray:
    if a.ndim == 2:
        return a.T
    return a.transpose(2, 3, 0, 1) if transposed else a.transpose(3, 2, 0, 1)


def _kernel_to_jax(w: torch.Tensor, transposed: bool = False) -> np.ndarray:
    # a copy, never a view: a transpose that numpy counts as contiguous (a
    # dimension of 1) would otherwise share the live parameter's storage
    a = w.detach().cpu().numpy()
    if a.ndim == 2:
        return a.T.copy()
    return (a.transpose(2, 3, 0, 1) if transposed else a.transpose(2, 3, 1, 0)).copy()


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def jax_leaves(module: nn.Module):
    """``(state_dict key, JAX path, tensor)`` for each parameter and buffer
    of a model built from this package's layers; the path is the variable's
    place in the flax tree, ``(collection, *modules, leaf)``."""
    for name, mod in module.named_modules():
        path = tuple(p for p in name.split(".") if p and p != "blocks")
        bn = isinstance(mod, layers.BatchNorm)
        for leaf, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if leaf in mod._non_persistent_buffers_set:  # a Conv's causal mask
                continue
            if isinstance(mod, VectorQuantizerEMA):
                coll, key = "vq_stats", leaf
            elif isinstance(mod, layers.Embed):
                coll, key = "params", "embedding"
            elif bn:
                coll, key = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                             "running_mean": ("batch_stats", "mean"),
                             "running_var": ("batch_stats", "var")}[leaf]
            else:
                coll, key = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
                             "u": ("spectral", "u"), "codebook": ("codebook", "codebook")}[leaf]
            yield (f"{name}.{leaf}" if name else leaf,
                   (coll, *path, *(("bn",) if bn else ()), key), t)


def to_jax_gan_variables(module: nn.Module) -> dict:
    """The flax variables (nested dicts of f32 numpy arrays, collections
    ``params`` / ``batch_stats`` / ``spectral`` / ``codebook`` /
    ``vq_stats``) of an MCGAN, CGAN, MCVAE, CVAE, VQ-VAE, MCPixelCNN or
    CPixelCNN (masked kernels unmasked, as flax stores them), or any model
    built from this package's layers: the JAX
    package's layout, as its checkpoints hold it under ``model_dict``. The
    inverse of :func:`from_jax_variables`: loading the result back gives the
    same model exactly."""
    out: dict = {}
    transposed = {n for n, m in module.named_modules() if isinstance(m, layers.ConvTranspose)}
    for key, path, t in jax_leaves(module):
        value = (_kernel_to_jax(t, key.rpartition(".")[0] in transposed) if path[-1] == "kernel"
                 else t.detach().cpu().numpy().astype(np.float32))
        _put(out, path, value)
    return out


def from_jax_classifier(variables) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``models.classifier.Classifier`` for the JAX
    ``Classifier``'s variables (the same layers and names as the GAN's)."""
    return from_jax_variables(variables)


def to_jax_classifier(module: nn.Module) -> dict:
    """The JAX ``Classifier``'s variables (``params``, ``batch_stats``) of
    the port's classifier: what its checkpoints hold under ``model_dict``."""
    return to_jax_gan_variables(module)


_INCEPTION_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
                   ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
                   ("batch_stats", "var"): "running_var"}


def from_jax_inception(variables) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``evals.inception.InceptionV3`` (torchvision's
    layout) for the JAX package's flax InceptionV3 variables
    (``{params, batch_stats}``, as ``inception_v3.pkl`` holds them)."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _walk(variables[collection]):
            *mod, leaf = path
            a = np.asarray(arr, np.float32)
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            state[".".join(mod + [_INCEPTION_LEAF[(collection, leaf)]])] = torch.from_numpy(
                np.array(a, np.float32, order="C"))
            if leaf == "mean":
                state[".".join(mod + ["num_batches_tracked"])] = torch.zeros((), dtype=torch.long)
    return state


def to_jax_inception(state_dict: dict) -> dict:
    """The inverse of :func:`from_jax_inception`: flax ``{params,
    batch_stats}`` as numpy, the layout ``inception_v3.pkl`` holds."""
    out: dict = {}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight" and mod[-1] == "bn":
            coll, name = "params", "scale"
        elif leaf == "weight":
            coll, name, a = "params", "kernel", _kernel_to_jax(t)
        elif leaf == "bias":
            coll, name = "params", "bias"
        else:
            coll, name = "batch_stats", {"running_mean": "mean", "running_var": "var"}[leaf]
        _put(out.setdefault(coll, {}), mod + [name], a)
    return out
