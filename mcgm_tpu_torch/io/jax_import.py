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
  ``cluster_size``, ``embedding_mean``) keep their names; the int8
  calibration's ``quant_stats/<module path>/act_amax`` is the module's
  ``act_amax`` buffer.

The inverse, :func:`to_jax_gan_variables`, walks the port's modules, so a
checkpoint the port writes holds the JAX package's variable tree and either
package reads it. InceptionV3 keeps torchvision's module layout (``conv`` /
``bn`` scopes inside each ``BasicConv2d``, ``fc``), which the JAX package's
flax port names the same way: :func:`from_jax_inception` and
:func:`to_jax_inception` map it one to one.
"""

from __future__ import annotations

import re

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
    ("quant_stats", "act_amax"): "act_amax",
}
_COLLECTIONS = ("params", "batch_stats", "spectral", "codebook", "vq_stats", "quant_stats")


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
    if is_glow_tree(variables):
        return _from_jax_glow(variables)
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
        named = getattr(mod, "jax_names", {})  # a module that places its own leaves
        for leaf, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if leaf in mod._non_persistent_buffers_set:  # a Conv's causal mask
                continue
            if leaf in named:
                coll, *rest = named[leaf]
                yield f"{name}.{leaf}", (coll, *path, *rest), t
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
                             "u": ("spectral", "u"), "codebook": ("codebook", "codebook"),
                             "act_amax": ("quant_stats", "act_amax")}[leaf]
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
    if getattr(module, "scan_flows", False):  # a Glow: its flows in the scanned layout
        out = pack_glow_flows(out, module.scan_chunk)
    return out


# ------------------------------------------------------------------ Glow
# A Glow's flows sit in the JAX tree in one of three layouts: unscanned
# (``block_i/flow_k/...``, one subtree per flow, the port's own module
# names), scanned (``block_i/flows/flow/...`` with every leaf stacked
# ``[K, ...]``, the default) or chunked (``block_i/flows/flow_j/...``,
# ``[K/c, ...]``, row ``r`` of ``flow_j`` holding flow ``r*c + j``), in every
# collection (``params``, ``codebook``, ``glow_const``). Numpy copies of the
# JAX package's ``detect_glow_scan_chunk`` / ``rechunk_glow_flows``.

_BLOCK = re.compile(r"block_\d+$")
_FLOW = re.compile(r"flow_(\d+)$")


def is_glow_tree(variables) -> bool:
    """Whether a variable tree is a Glow's (``params`` keyed by blocks)."""
    params = variables.get("params", {})
    return bool(params) and all(_BLOCK.match(k) for k in params)


def detect_glow_scan_chunk(variables) -> int:
    """The ``scan_chunk`` of a tree's scanned flows: 1 for ``flows/flow``,
    c for ``flows/flow_0 .. flow_{c-1}``, 1 where no flows are scanned."""
    def find(node):
        if isinstance(node, dict):
            if "flows" in node:
                keys = node["flows"].keys()
                return 1 if "flow" in keys else len(keys)
            for v in node.values():
                got = find(v)
                if got is not None:
                    return got
        return None

    return find(variables) or 1


def _map_leaves(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def unpack_glow_flows(variables) -> dict:
    """The tree with every block's flows unscanned (``flow_k``), whatever
    its layout."""
    def block(node):
        if "flows" not in node:
            return dict(node)
        fl = node["flows"]
        if "flow" in fl:
            subs, c = [fl["flow"]], 1
        else:
            c = len(fl)
            subs = [fl[f"flow_{j}"] for j in range(c)]
        rows = len(next(_walk(subs[0]))[1])
        out = {k: v for k, v in node.items() if k != "flows"}
        for r in range(rows):
            for j, sub in enumerate(subs):
                out[f"flow_{r * c + j}"] = _map_leaves(lambda a, r=r: np.array(a[r]), sub)
        return out

    return {coll: {k: block(v) if _BLOCK.match(k) else v for k, v in tree.items()}
            for coll, tree in variables.items()}


def pack_glow_flows(variables, chunk: int = 1) -> dict:
    """The tree with every block's ``flow_k`` stacked into the scanned
    layout, ``scan_chunk = chunk``."""
    def block(node):
        ks = sorted((int(_FLOW.match(k).group(1)) for k in node if _FLOW.match(k)))
        if not ks:
            return dict(node)
        if len(ks) % chunk:
            raise ValueError(f"scan_chunk={chunk} must divide K={len(ks)}")
        out = {k: v for k, v in node.items() if not _FLOW.match(k)}

        def stack(idx):
            return _map_leaves(lambda *a: np.stack(a), *(node[f"flow_{i}"] for i in idx))

        out["flows"] = ({"flow": stack(ks)} if chunk == 1 else
                        {f"flow_{j}": stack(ks[j::chunk]) for j in range(chunk)})
        return out

    return {coll: {k: block(v) if _BLOCK.match(k) else v for k, v in tree.items()}
            for coll, tree in variables.items()}


def rechunk_glow_flows(variables, to_chunk: int) -> dict:
    """Repack a tree's flows, in any layout, to ``scan_chunk = to_chunk``."""
    return pack_glow_flows(unpack_glow_flows(variables), to_chunk)


def _from_jax_glow(variables) -> dict[str, torch.Tensor]:
    """A Glow's ``state_dict`` from its JAX tree in any layout: a conv's
    ``kernel`` is its ``weight`` (HWIO -> OIHW), the invconv's ``glow_const``
    ``const/{w_p, s_sign}`` its buffers, every other leaf keeps its name."""
    state = {}
    for coll, tree in unpack_glow_flows(variables).items():
        if coll not in ("params", "codebook", "glow_const"):
            raise KeyError(f"unknown Glow collection {coll}")
        for path, arr in _walk(tree):
            *mod, leaf = path
            a = np.asarray(arr, np.float32)
            if leaf == "kernel":
                a, leaf = _kernel_from_jax(a, False), "weight"
            if mod and mod[-1] == "const":
                mod = mod[:-1]
            state[".".join(mod + [leaf])] = torch.from_numpy(np.array(a, np.float32,
                                                                      order="C"))
    return state


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
