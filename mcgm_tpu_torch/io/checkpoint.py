"""Checkpoints: write, copy to ``_best``, read, and write from a thread.

The format is the JAX package's (``mcgm_tpu/io/checkpoint.py``): one pickle
at ``{output_dir}/model/{tag}_checkpoint.pkl`` every epoch, copied to
``{tag}_best.pkl`` when the pivot metric improves, holding ``cfg``,
``epoch`` (the next one to run; the current one, with ``mid_epoch_step``,
for a checkpoint inside an epoch), ``model_dict`` (the JAX package's
variable tree as numpy: ``io.jax_import.to_jax_gan_variables``),
``optimizer_dict`` and ``scheduler_dict``, and ``logger``. The port adds
``torch_rng``, the state of the train state's noise generator. Everything
is numpy or plain Python, so either package reads the model of the other's
checkpoints. A Glow's variables are written in the layout of its config
(``glow.scan_flows`` / ``scan_chunk``: the model exports that layout), as
the JAX package's resume matches them, and read in any layout, so one
``_best`` serves both packages and a resume under another ``scan_chunk``
repacks.

A checkpoint the JAX package wrote also pickles its ``Logger`` and optax
states; unpickling those the ordinary way would import ``mcgm_tpu``,
``optax`` and ``jax``. The unpickler here resolves only numpy's names, a few
builtins and this package's ``Logger``, and stands an inert stub in for
every other class, so loading never imports them and never runs their code.
"""

from __future__ import annotations

import collections
import os
import pickle
import shutil
import threading
import time

import numpy as np
import torch

from ..report.logger import Logger
from ..utils import ckpt_path, makedir_exist_ok, save

_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
             "bool", "str", "bytes", "bytearray", "slice", "range", "object"}
# what numpy arrays, scalars and dtypes pickle through (numpy 1 and 2 paths)
_NUMPY = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}
_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    # flax FrozenDict pickles as FrozenDict(plain_dict): keep the dict
    ("flax.core.frozen_dict", "FrozenDict"): dict,
    ("collections", "defaultdict"): collections.defaultdict,
    ("mcgm_tpu_torch.report.logger", "Logger"): Logger,
}


class _Stub:
    """Stands in for a class outside numpy and the builtins: takes any
    constructor arguments, items and state, and keeps them."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        self._args = args

    def __setstate__(self, state):
        self._state = state

    def __setitem__(self, key, value):
        self.__dict__.setdefault("_items", {})[key] = value

    def append(self, value):
        self.__dict__.setdefault("_list", []).append(value)

    def extend(self, values):
        self.__dict__.setdefault("_list", []).extend(values)


class _ModelDictUnpickler(pickle.Unpickler):
    def __init__(self, file, classes: dict | None = None):
        super().__init__(file)
        self._classes = {**_ALLOWED, **(classes or {})}

    def find_class(self, module, name):
        if (module == "numpy" or module.startswith("numpy.")) and name in _NUMPY:
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if (module, name) in self._classes:
            return self._classes[(module, name)]
        return type(name, (_Stub,), {"__module__": f"stub:{module}"})


def load_pickle(path: str, classes: dict | None = None):
    """Unpickle ``path`` with the restricted unpickler above; ``classes``
    maps more ``(module, name)`` pairs to the classes to build."""
    with open(path, "rb") as f:
        return _ModelDictUnpickler(f, classes).load()


def _load_payload(path: str) -> dict:
    payload = load_pickle(path)
    if not isinstance(payload, dict) or "model_dict" not in payload:
        raise ValueError(f"{path} holds no model_dict")
    return payload


def load_model_dict(path: str) -> dict:
    """``model_dict`` of a checkpoint either package wrote: the flax
    variables as nested dicts of numpy arrays (see ``io.jax_import``)."""
    return _load_payload(path)["model_dict"]


def load_checkpoint(cfg: dict, tag: str, kind: str = "checkpoint") -> dict | None:
    """The payload of ``{tag}_{kind}.pkl`` under ``cfg['output_dir']``, or
    ``None`` if there is none."""
    path = ckpt_path(cfg, tag, kind)
    return _load_payload(path) if os.path.exists(path) else None


def to_numpy(tree):
    """``tree`` with every tensor copied to a numpy array on the host
    (dicts, lists and tuples walked; anything else kept). A tensor already
    on the CPU is copied too: its numpy view would follow in-place updates."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def to_torch(tree):
    """The inverse of :func:`to_numpy` for what it wrote: numpy arrays back
    to CPU tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return tree


def save_checkpoint(cfg: dict, tag: str, payload: dict, kind: str = "checkpoint") -> str:
    """Write ``payload`` (numpy and plain Python only) atomically to
    ``{tag}_{kind}.pkl``; returns the path."""
    path = ckpt_path(cfg, tag, kind)
    save(payload, path)
    return path


def copy_best(cfg: dict, tag: str) -> None:
    """Copy ``{tag}_checkpoint.pkl`` to ``{tag}_best.pkl``."""
    dst = ckpt_path(cfg, tag, "best")
    makedir_exist_ok(os.path.dirname(dst))
    shutil.copy(ckpt_path(cfg, tag, "checkpoint"), dst)


class AsyncCheckpointer:
    """Write checkpoints on a thread while the next steps run.

    ``submit`` takes the payload's snapshot on the calling thread (every
    tensor copied to host numpy, so later in-place updates of the model and
    optimizers cannot reach the file), then pickles and writes it, and
    copies it to ``_best`` if asked, on a writer thread. One write is
    outstanding at a time: ``submit`` first joins the previous one. A
    writer's failure is raised by the next ``wait`` or ``submit``.
    ``submit`` returns the write's record, which later gets ``write_s``
    (its seconds on the thread) and ``join_s`` (the seconds its join
    blocked the caller).
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._rec: dict | None = None

    def submit(self, cfg: dict, tag: str, payload: dict, copy_to_best: bool = False) -> dict:
        self.wait()
        payload = to_numpy(payload)
        rec = self._rec = {}

        def work():
            try:
                t = time.perf_counter()
                save_checkpoint(cfg, tag, payload)
                if copy_to_best:
                    copy_best(cfg, tag)
                rec["write_s"] = time.perf_counter() - t
            except BaseException as e:  # raised again on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return rec

    def wait(self) -> None:
        """Join the outstanding write; raise its failure here."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self._rec["join_s"] = time.perf_counter() - t0
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err
