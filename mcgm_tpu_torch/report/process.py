"""Results over seeds (port of ``mcgm_tpu/report/process.py``):

    python -m mcgm_tpu_torch.report.process [OUTPUT_DIR]

Reads ``{output_dir}/result/``: each ``{tag}.pkl`` of ``cli.test_model``
(the last value of every metric in its logger's history) and each
``is_`` / ``fid_`` / ``dbi_`` ``{generated,created}_{tag}.npy`` of
``cli.test_generated``, written by either package (the pickles are read by
``io.checkpoint``'s restricted unpickler, which imports nothing of the JAX
package). Each (data, subset, model, control) cell's metric becomes its
mean / std / max / min over the seeds, with the seed of the max and of the
min, in ``{output_dir}/processed_result.json``; a seed whose value is not
finite (a diverged run) is listed, not averaged. ``make_vis`` writes
``{output_dir}/vis.sh``: the ``cli.sample`` calls for each cell's best seed.
"""

from __future__ import annotations

import json
import os
import re
import sys
from collections import defaultdict

import numpy as np

from ..io.checkpoint import load_pickle
from ..utils import makedir_exist_ok

_SCORES = {"is": "InceptionScore", "fid": "FID", "dbi": "DBI"}
_MIN_BETTER = ("fid", "loss", "nll", "mse", "bce", "dbi")


def _cell_of(tag: str) -> tuple[str, str]:
    """``'{seed}_{rest}'`` -> ``(seed, rest)``."""
    seed, _, rest = tag.partition("_")
    return seed, rest


def logger_history(logger) -> dict:
    """The history of a pickled logger of either package: this package's
    ``Logger``, or the JAX package's as the restricted unpickler leaves it
    (a stub holding the pickled state)."""
    if hasattr(logger, "history"):
        return logger.history
    return getattr(logger, "_state", {}).get("history", {})


def collect_results(output_dir: str = "./output") -> dict:
    """cell -> metric -> {seed: value}."""
    rdir = os.path.join(output_dir, "result")
    results: dict = defaultdict(lambda: defaultdict(dict))
    if not os.path.isdir(rdir):
        return results
    for fn in sorted(os.listdir(rdir)):
        path = os.path.join(rdir, fn)
        if fn.endswith(".pkl"):
            seed, cell = _cell_of(fn[:-4])
            for name, hist in logger_history(load_pickle(path)["logger"]).items():
                if not name.endswith("/info") and hist:
                    results[cell][name][seed] = float(hist[-1])
        elif fn.endswith(".npy"):
            m = re.match(r"(is|fid|dbi)_(generated|created)_(.+)\.npy$", fn)
            if m:
                seed, cell = _cell_of(m.group(3))
                results[cell][f"{m.group(2)}/{_SCORES[m.group(1)]}"][seed] = float(np.load(path))
    return results


def summarize(results: dict) -> dict:
    """Each cell's metrics over their seeds: ``n_seeds``, ``mean``, ``std``,
    ``max``, ``min``, ``argmax``, ``argmin`` of the finite values; seeds
    whose value is not finite are counted in ``n_diverged`` and named in
    ``diverged_seeds``, and a cell with none finite has null statistics."""
    out = {}
    for cell, metrics in results.items():
        out[cell] = {}
        for name, per_seed in metrics.items():
            seeds = sorted(per_seed)
            vals = np.asarray([per_seed[s] for s in seeds], dtype=float)
            finite = np.isfinite(vals)
            entry = {"n_seeds": len(seeds)}
            if not finite.all():
                entry["n_diverged"] = int((~finite).sum())
                entry["diverged_seeds"] = [s for s, f in zip(seeds, finite) if not f]
            kept = [s for s, f in zip(seeds, finite) if f]
            v = vals[finite]
            entry.update({"mean": float(v.mean()), "std": float(v.std()), "max": float(v.max()),
                          "min": float(v.min()), "argmax": kept[int(v.argmax())],
                          "argmin": kept[int(v.argmin())]} if len(v) else
                         dict.fromkeys(("mean", "std", "max", "min", "argmax", "argmin")))
            out[cell][name] = entry
    return out


def process(output_dir: str = "./output") -> dict:
    """Summarise ``{output_dir}/result`` into ``processed_result.json``;
    returns the summary."""
    summary = summarize(collect_results(output_dir))
    makedir_exist_ok(output_dir)
    with open(os.path.join(output_dir, "processed_result.json"), "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
    return summary


def make_vis(summary: dict, output_dir: str = "./output",
             pivot: str = "generated/InceptionScore") -> str:
    """Write ``{output_dir}/vis.sh``: ``generate``, ``transit`` and
    ``create`` through this package's ``cli.sample`` for each cell's best
    seed by ``pivot`` (its ``argmin`` where a smaller value is better: FID,
    losses, NLL, MSE, BCE, DBI; else its ``argmax``). Cells without the
    pivot, or whose every seed diverged, are left out. Returns the path."""
    arg = "argmin" if any(m in pivot.lower() for m in _MIN_BETTER) else "argmax"
    lines = ["#!/bin/bash"]
    for cell, metrics in sorted(summary.items()):
        best = metrics.get(pivot, {}).get(arg)
        if best is None:
            continue
        parts = cell.split("_")  # {data}_{subset}_{model}[_{control}]
        control = parts[3] if len(parts) > 3 else "None"
        base = (f"--data_name {parts[0]} --subset {parts[1]} --model_name {parts[2]} "
                f"--control_name {control} --init_seed {best}")
        lines += [f"python -m mcgm_tpu_torch.cli.sample {w} {base}"
                  for w in ("generate", "transit", "create")]
    path = os.path.join(output_dir, "vis.sh")
    makedir_exist_ok(output_dir)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


if __name__ == "__main__":
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "./output"
    make_vis(process(out_dir), out_dir)
