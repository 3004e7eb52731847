"""Read the model variables out of a checkpoint the JAX package wrote.

A ``{tag}_best.pkl`` / ``{tag}_checkpoint.pkl`` payload pickles, besides
``model_dict`` (nested dicts of numpy arrays), the JAX package's ``Logger``
and optax optimizer states. Unpickling those the ordinary way would import
``mcgm_tpu``, ``optax`` and ``jax``. The unpickler here resolves only numpy's
and a few builtin names and stands an inert stub in for every other class,
so loading never imports them and never runs their code.
"""

from __future__ import annotations

import collections
import pickle

_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
             "bool", "str", "bytes", "bytearray", "slice", "range", "object"}
# what numpy arrays, scalars and dtypes pickle through (numpy 1 and 2 paths)
_NUMPY = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}
_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    # flax FrozenDict pickles as FrozenDict(plain_dict): keep the dict
    ("flax.core.frozen_dict", "FrozenDict"): dict,
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
    def find_class(self, module, name):
        if (module == "numpy" or module.startswith("numpy.")) and name in _NUMPY:
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        return type(name, (_Stub,), {"__module__": f"stub:{module}"})


def load_model_dict(path: str) -> dict:
    """``model_dict`` of a JAX-written checkpoint: the flax variables as
    nested dicts of numpy arrays (see ``io.jax_import``)."""
    with open(path, "rb") as f:
        payload = _ModelDictUnpickler(f).load()
    if not isinstance(payload, dict) or "model_dict" not in payload:
        raise ValueError(f"{path} holds no model_dict")
    return payload["model_dict"]
