"""Step timing. Port of ``mcgm_tpu/report/profiling.py::StepTimer``.

Host-clock time per item between ``start`` and ``stop``; on the card the
caller synchronises first where it needs device time (the train loop reads
its images/s at log points, which wait for the device anyway).
"""

from __future__ import annotations

import time

import numpy as np


class StepTimer:
    """Per-item seconds of up to ``capacity`` timed spans: mean, p50, p95
    and items/s."""

    def __init__(self, capacity: int = 2048):
        self.times: list[float] = []
        self.capacity = capacity
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_items: int = 1):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if len(self.times) < self.capacity:
            self.times.append(dt / max(n_items, 1))

    def stats(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"mean_s": float(arr.mean()), "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)), "items_per_s": float(1.0 / arr.mean())}
