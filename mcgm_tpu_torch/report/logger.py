"""Experiment logger. Port of ``mcgm_tpu/report/logger.py``.

Batch-size-weighted running means per ``tag/metric``, an epoch's means
appended to ``history`` by ``safe(False)``, and one formatted line per
``write``. ``backend`` picks the sinks of the scalars, as in the JAX
package: ``jsonl`` (``{log_path}/scalars.jsonl``, one JSON object per line),
``tensorboard`` (event files under ``log_path``: ``add_scalar`` per metric
and the formatted line as text, through one
``torch.utils.tensorboard.SummaryWriter`` per run, imported when first
opened; where that import fails, a warning and jsonl instead) or ``both``.
The logger rides inside checkpoints (its history is how learning curves are
recovered), pickled without its sinks. This module imports neither torch
nor JAX.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from collections import defaultdict
from numbers import Number

BACKENDS = ("jsonl", "tensorboard", "both")


class Logger:
    def __init__(self, log_path: str | None = None, backend: str = "jsonl"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown logger backend {backend!r}: want one of {BACKENDS}")
        self.log_path = log_path
        self.backend = backend
        self.tracker = {}
        self.counter = defaultdict(int)
        self.mean = defaultdict(float)
        self.history = defaultdict(list)
        self.iterator = defaultdict(int)
        self._fh = None
        self._tb = None

    def _open_tb(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception as e:  # no usable tensorboard: jsonl instead
            warnings.warn(f"tensorboard backend unavailable ({e}); falling back to jsonl")
            self.backend = "jsonl"
            return None
        return SummaryWriter(self.log_path)

    def safe(self, write: bool):
        """``True`` opens the sinks for an epoch; ``False`` closes the jsonl
        file, flushes the event file and appends the epoch's means to
        ``history``."""
        if write:
            if self.log_path:
                # the backend is read each time (a resumed run sets it anew);
                # one writer per run, kept across epochs (each SummaryWriter
                # opens an event file of its own)
                if self.backend in ("tensorboard", "both") and self._tb is None:
                    self._tb = self._open_tb()
                if self.backend in ("jsonl", "both"):
                    os.makedirs(self.log_path, exist_ok=True)
                    self._fh = open(os.path.join(self.log_path, "scalars.jsonl"), "a")
        else:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self._tb is not None:
                self._tb.flush()
            for name in self.mean:
                self.history[name].append(self.mean[name])

    def close(self):
        """Release the sinks (end of a run; ``safe(True)`` opens them again)."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

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
            if self._fh is not None or self._tb is not None:
                self.iterator[name] += 1
            if self._fh is not None:
                self._fh.write(json.dumps({"name": name, "value": s,
                                           "step": self.iterator[name],
                                           "time": time.time()}) + "\n")
            if self._tb is not None:
                self._tb.add_scalar(name, s, self.iterator[name])
        header = self.tracker.get(f"{tag}/info", [])
        line = "  ".join(list(header[:2]) + info + list(header[2:]))
        print(line, flush=True)
        if self._tb is not None:
            info_name = f"{tag}/info"
            self.iterator[info_name] += 1
            self._tb.add_text(info_name, line, self.iterator[info_name])
        self.flush()

    def flush(self):
        if self._fh is not None:
            self._fh.flush()
        if self._tb is not None:
            self._tb.flush()

    def __getstate__(self):
        return dict(self.__dict__, _fh=None, _tb=None)

    def __setstate__(self, d):
        d.setdefault("backend", "jsonl")
        d.setdefault("_tb", None)  # pickled before the tensorboard backend
        self.__dict__.update(d)
