"""Experiment logger. Port of ``mcgm_tpu/report/logger.py`` with its jsonl
backend.

Batch-size-weighted running means per ``tag/metric``, an epoch's means
appended to ``history`` by ``safe(False)``, and one formatted line per
``write``. Scalars go to ``{log_path}/scalars.jsonl``, one JSON object per
line. The logger rides inside checkpoints (its history is how learning
curves are recovered), pickled without its file handle. This module imports
neither torch nor JAX.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from numbers import Number


class Logger:
    def __init__(self, log_path: str | None = None, backend: str = "jsonl"):
        if backend != "jsonl":
            raise ValueError(f"unknown logger backend {backend!r}: this package writes jsonl")
        self.log_path = log_path
        self.backend = backend
        self.tracker = {}
        self.counter = defaultdict(int)
        self.mean = defaultdict(float)
        self.history = defaultdict(list)
        self.iterator = defaultdict(int)
        self._fh = None

    def safe(self, write: bool):
        """``True`` opens the sink for an epoch; ``False`` closes it and
        appends the epoch's means to ``history``."""
        if write:
            if self.log_path:
                os.makedirs(self.log_path, exist_ok=True)
                self._fh = open(os.path.join(self.log_path, "scalars.jsonl"), "a")
        else:
            self.close()
            for name in self.mean:
                self.history[name].append(self.mean[name])

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def reset(self):
        self.tracker = {}
        self.counter = defaultdict(int)
        self.mean = defaultdict(float)

    def append(self, result: dict, tag: str, n: int = 1, mean: bool = True):
        for k, v in result.items():
            name = f"{tag}/{k}"
            self.tracker[name] = v
            self.counter[name] += n
            if mean and isinstance(v, Number):
                c = self.counter[name]
                self.mean[name] = ((c - n) * self.mean[name] + n * float(v)) / c

    def write(self, tag: str, metric_names: list):
        info = []
        for k in metric_names:
            name = f"{tag}/{k}"
            s = self.mean[name]
            info.append(f"{k}: {s:.4f}")
            if self._fh is not None:
                self.iterator[name] += 1
                self._fh.write(json.dumps({"name": name, "value": s,
                                           "step": self.iterator[name],
                                           "time": time.time()}) + "\n")
        header = self.tracker.get(f"{tag}/info", [])
        print("  ".join(list(header[:2]) + info + list(header[2:])), flush=True)
        self.flush()

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def __getstate__(self):
        return dict(self.__dict__, _fh=None)
