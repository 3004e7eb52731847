"""Export a trained model's generate path as a serving artifact (port of
``mcgm_tpu/cli/export.py``):

    python -m mcgm_tpu_torch.cli.export --data_name CIFAR10 --model_name mcgan \
        --control_name 0.5 [--batch b|N] [--quantize int8|int8_static] [--device cpu]

For each seed it loads ``{tag}_best`` (for a PixelCNN also its VQ-VAE's) and
writes ``{output_dir}/export/{tag}.pt2`` (``.int8.pt2`` / ``.int8s.pt2``
quantized): a ``torch.export`` program with the weights baked in, loadable
with ``mcgm_tpu_torch.io.export.load_artifact``, which needs torch and
``mcgm_tpu_torch.kernels.ops`` and no model code. The artifact is made for
the card unless ``--device cpu`` is given (``--platforms cpu`` or ``cuda``
says the same; an artifact runs on one device). ``int8_static`` first
calibrates on 4 generate batches of 256 drawn with the seed.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import make_model_tag, process_control
from ..data.datasets import fetch_dataset, process_dataset
from ..io.export import calibrate_int8, export_sampler, save_artifact
from ..train.loop import apply_family_overrides
from ..workflows.sampling import load_sampler
from ._common import parse_cfg

SUFFIX = {None: ".pt2", "int8": ".int8.pt2", "int8_static": ".int8s.pt2"}
PLATFORMS = ("cpu", "cuda")


def export_flags(argv, defaults: dict):
    """The export-only flags (``--platforms``, ``--batch``, ``--quantize``),
    peeled off before ``parse_cfg``, which knows only config keys: ``(own,
    rest)``. ``own.batch`` is an int or a symbolic dimension's name;
    ``own.platforms`` None or one of ``cpu`` / ``cuda``."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--platforms", default=defaults.pop("platforms", None))
    pre.add_argument("--batch", default=defaults.pop("export_batch", "b"))
    pre.add_argument("--quantize", default=defaults.pop("quantize", None),
                     choices=(None, "int8", "int8_static"),
                     help="post-training int8 (gan / vae): int8 = dynamic per-example "
                          "activation scales; int8_static = calibrated per-layer scales")
    own, rest = pre.parse_known_args(argv)
    if own.platforms is not None:
        names = [p for p in str(own.platforms).split(",") if p]
        bad = [p for p in names if p not in PLATFORMS]
        if bad or len(names) != 1:
            raise SystemExit(f"--platforms {own.platforms!r}: name one of {PLATFORMS} (an "
                             "artifact runs on the device it was exported for)")
        own.platforms = names[0]
    if isinstance(own.batch, str) and own.batch.isdigit():
        own.batch = int(own.batch)
    return own, rest


def main(argv=None, **defaults) -> list:
    """Write one artifact per seed; returns their paths."""
    own, rest = export_flags(list(sys.argv[1:] if argv is None else argv), defaults)
    cfg = apply_family_overrides(process_control(parse_cfg(rest, **defaults)))
    device = own.platforms or cfg.get("device") or "cuda"
    paths = []
    for i in range(int(cfg.get("num_experiments", 1))):
        seed = cfg["init_seed"] + i
        tag = make_model_tag(cfg, seed)
        print(f"Export: {tag}")
        dataset = fetch_dataset(cfg["data_name"], cfg["subset"], cfg.get("data_dir", "./data"))
        cfg_i = dict(process_dataset(dataset["train"], cfg), model_tag=tag)
        sampler = load_sampler(cfg_i, tag, device=device)
        if own.quantize == "int8_static":
            sampler = calibrate_int8(sampler, torch.Generator(sampler.device).manual_seed(seed))
        blob = export_sampler(sampler, batch=own.batch, quantize=own.quantize)
        path = os.path.join(cfg["output_dir"], "export", f"{tag}{SUFFIX[own.quantize]}")
        save_artifact(blob, path)
        print(f"wrote {path} ({len(blob) / 1e6:.1f} MB)")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
