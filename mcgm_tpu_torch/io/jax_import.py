"""Map the JAX package's flax variables onto the port's ``state_dict``.

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
"""

from __future__ import annotations

import numpy as np
import torch

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
