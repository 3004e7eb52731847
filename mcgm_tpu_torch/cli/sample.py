"""The generate / transit / create workflows from the command line (port of
``mcgm_tpu/cli/sample.py``):

    python -m mcgm_tpu_torch.cli.sample {generate,transit,create} \
        --data_name MNIST --model_name {mcgan,cgan,mcvae,cvae,mcpixelcnn,cpixelcnn,mcglow,cglow} \
        [--control_name 0.5] [--save_npy true] [--device cpu]

For each seed it reads the dataset's processed files for the class count,
loads ``{tag}_best`` (written by the port's trainer or by the JAX package;
for a PixelCNN also its VQ-VAE's ``_best``) and runs the workflow with noise from a ``torch.Generator`` seeded with the
seed. It runs on the card unless ``--device cpu`` is given, and raises if
there is no card.
"""

from __future__ import annotations

import sys

import torch

from ..config import make_model_tag, process_control
from ..data.datasets import fetch_dataset, process_dataset
from ..train.loop import apply_family_overrides
from ..workflows.create import create_workflow
from ..workflows.generate import generate
from ..workflows.sampling import load_sampler
from ..workflows.transit import transit_workflow
from ._common import parse_cfg

WORKFLOWS = {"generate": generate, "transit": transit_workflow, "create": create_workflow}


def main(workflow: str, argv=None, **defaults) -> list:
    """Run ``workflow`` for each seed; returns what it returned, per seed."""
    if workflow not in WORKFLOWS:
        raise SystemExit(f"workflow must be one of {sorted(WORKFLOWS)}, got {workflow!r}")
    cfg = apply_family_overrides(process_control(parse_cfg(argv, **defaults)))
    out = []
    for i in range(int(cfg.get("num_experiments", 1))):
        seed = cfg["init_seed"] + i
        tag = make_model_tag(cfg, seed)
        print(f"Experiment: {tag}")
        dataset = fetch_dataset(cfg["data_name"], cfg["subset"], cfg.get("data_dir", "./data"))
        cfg_i = dict(process_dataset(dataset["train"], cfg), model_tag=tag)
        sampler = load_sampler(cfg_i, tag, device=cfg_i.get("device"))
        generator = torch.Generator(sampler.device).manual_seed(seed)
        out.append(WORKFLOWS[workflow](sampler, tag, generator))
    return out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
