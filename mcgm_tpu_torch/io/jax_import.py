"""Map the JAX package's flax variables onto the port's ``state_dict``, and
back.

Input: ``{"params", "batch_stats", "spectral", "codebook"}`` as nested dicts
of numpy arrays, as ``mcgm_tpu`` checkpoints hold them under
``model_dict``. The port's modules carry the flax module names, so a
variable's path maps to a key by rule:

- a path component naming a residual block (``_MC...ResBlock_i``) sits
  under the owning ``blocks`` dict; BatchNorm's inner ``bn`` scope is dropped;
- ``kernel`` -> ``weight``, HWIO -> OIHW for convs and ``[in,out]`` ->
  ``[out,in]`` for dense layers; BatchNorm ``scale`` -> ``weight``,
  ``mean``/``var`` -> ``running_mean``/``running_var``; spectral ``u`` and
  ``codebook`` keep their names.

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

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("spectral", "u"): "u",
    ("codebook", "codebook"): "codebook",
}


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
        if p.startswith("_MC") and "ResBlock_" in p:
            out.append("blocks")
        out.append(p)
    return ".".join(out + [name])


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    """A ``state_dict`` that makes the port compute the JAX model's function."""
    state = {}
    for collection in ("params", "batch_stats", "spectral", "codebook"):
        for path, arr in _walk(variables.get(collection, {})):
            *mod, leaf = path
            name = _LEAF.get((collection, leaf))
            if name is None:
                raise KeyError(f"unknown variable {collection}/{'/'.join(path)}")
            a = np.asarray(arr, np.float32)
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            state[_key(mod, name)] = torch.from_numpy(np.array(a, np.float32, order="C"))
    return state


def from_jax_gan_train_state(g_params, d_params, state) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a JAX ``GANTrainState``'s generator and
    discriminator parameters and its mutable collections (``ts.state``:
    BatchNorm statistics, spectral ``u``, codebooks)."""
    return from_jax_variables({"params": {"generator": g_params, "discriminator": d_params},
                               **state})


def _kernel_to_jax(w: torch.Tensor) -> np.ndarray:
    # a copy, never a view: a transpose that numpy counts as contiguous (a
    # dimension of 1) would otherwise share the live parameter's storage
    a = w.detach().cpu().numpy()
    return (a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T).copy()


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_jax_gan_variables(module: nn.Module) -> dict:
    """The flax variables (nested dicts of f32 numpy arrays, collections
    ``params`` / ``batch_stats`` / ``spectral`` / ``codebook``) of an MCGAN,
    or any model built from this package's layers: the JAX package's layout,
    as its checkpoints hold it under ``model_dict``. The inverse of
    :func:`from_jax_variables`: loading the result back gives the same
    model exactly."""
    out: dict = {}
    for name, mod in module.named_modules():
        path = [p for p in name.split(".") if p and p != "blocks"]
        if isinstance(mod, layers.BatchNorm):
            path.append("bn")
        for leaf, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if isinstance(mod, layers.BatchNorm):
                coll, key = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                             "running_mean": ("batch_stats", "mean"),
                             "running_var": ("batch_stats", "var")}[leaf]
            else:
                coll, key = {"weight": ("params", "kernel"), "bias": ("params", "bias"),
                             "u": ("spectral", "u"), "codebook": ("codebook", "codebook")}[leaf]
            value = (_kernel_to_jax(t) if key == "kernel"
                     else t.detach().cpu().numpy().astype(np.float32))
            _put(out.setdefault(coll, {}), path + [key], value)
    return out


def from_jax_classifier(variables) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``models.classifier.Classifier`` for the JAX
    ``Classifier``'s variables (the same layers and names as the GAN's)."""
    return from_jax_variables(variables)


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
