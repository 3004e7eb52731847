"""Learning curves from the checkpoints' loggers (port of
``mcgm_tpu/report/learning_curve.py``):

    python -m mcgm_tpu_torch.report.learning_curve [OUTPUT_DIR] [--metric test/FID ...] [--png]

Each ``{output_dir}/model/{tag}_checkpoint.pkl`` (either package's) holds
its run's logger, whose history is a metric's value per epoch. Per metric
and (data, subset, model, control) cell, the seeds' curves (cut to the
shortest) give a mean and std by epoch, written as
``{output_dir}/vis/curves/{metric}.json``; ``--png`` also draws them, one
PNG per metric, with matplotlib (which must then be installed).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from ..io.checkpoint import load_pickle
from ..utils import makedir_exist_ok
from .process import logger_history

DEFAULT_METRICS = ("test/InceptionScore", "test/FID")


def checkpoint_histories(output_dir: str) -> list[tuple[str, dict]]:
    """``(cell, logger history)`` of each ``{tag}_checkpoint.pkl`` under
    ``{output_dir}/model``, in file order (each file unpickled once)."""
    mdir = os.path.join(output_dir, "model")
    if not os.path.isdir(mdir):
        return []
    return [(fn[:-len("_checkpoint.pkl")].partition("_")[2],
             dict(logger_history(load_pickle(os.path.join(mdir, fn))["logger"])))
            for fn in sorted(os.listdir(mdir)) if fn.endswith("_checkpoint.pkl")]


def collect_curves(output_dir: str, metric: str, histories=None) -> dict:
    """cell -> the per-seed curves of ``metric`` (from ``histories``, read
    from the checkpoints if not given)."""
    curves = defaultdict(list)
    for cell, hist in (checkpoint_histories(output_dir) if histories is None else histories):
        if hist.get(metric):
            curves[cell].append(list(hist[metric]))
    return curves


def curve_stats(seed_curves: list) -> dict:
    """Mean and std over seeds by epoch, the curves cut to the shortest."""
    n = min(len(c) for c in seed_curves)
    arr = np.asarray([c[:n] for c in seed_curves], np.float64)
    return {"seeds": len(seed_curves), "epochs": n, "mean": arr.mean(0).tolist(),
            "std": arr.std(0).tolist()}


def plot_curves(output_dir: str = "./output", metrics=DEFAULT_METRICS, png: bool = False) -> list:
    """Write each metric's curves as JSON under ``{output_dir}/vis/curves``
    and, with ``png``, draw them too (raises ``ImportError`` without
    matplotlib). Returns the paths written."""
    if png:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("plot_curves(png=True) draws with matplotlib, which is not "
                              "installed; without png=True the curves are written as JSON") from e
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    vis = os.path.join(output_dir, "vis", "curves")
    makedir_exist_ok(vis)
    histories = checkpoint_histories(output_dir)
    written = []
    for metric in metrics:
        curves = collect_curves(output_dir, metric, histories)
        if not curves:
            continue
        stats = {cell: curve_stats(c) for cell, c in sorted(curves.items())}
        stem = os.path.join(vis, metric.replace("/", "_"))
        with open(stem + ".json", "w") as f:
            json.dump(stats, f, indent=2)
        written.append(stem + ".json")
        if png:
            fig, ax = plt.subplots(figsize=(6, 4))
            for cell, s in stats.items():
                x, mean, std = np.arange(1, s["epochs"] + 1), np.asarray(s["mean"]), np.asarray(
                    s["std"])
                ax.plot(x, mean, label=cell)
                if s["seeds"] > 1:
                    ax.fill_between(x, mean - std, mean + std, alpha=0.2)
            ax.set_xlabel("epoch")
            ax.set_ylabel(metric)
            ax.legend(fontsize=7)
            fig.savefig(stem + ".png", dpi=120, bbox_inches="tight")
            plt.close(fig)
            written.append(stem + ".png")
    return written


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="learning curves from the checkpoints' loggers")
    ap.add_argument("output_dir", nargs="?", default="./output")
    ap.add_argument("--metric", action="append", help="a logger name, e.g. test/FID (repeatable)")
    ap.add_argument("--png", action="store_true", help="also draw PNGs (needs matplotlib)")
    args = ap.parse_args()
    for p in plot_curves(args.output_dir, tuple(args.metric or DEFAULT_METRICS), args.png):
        print(p)
