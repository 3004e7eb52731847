"""Model size tables from the command line (port of ``mcgm_tpu/cli/summary.py``):

    python -m mcgm_tpu_torch.cli.summary [--model_name mcgan] [--data_name CIFAR10] [--device cpu]

Builds ``--model_name``'s model (the config's, ``mcgan``, by default; all
ten with ``--model_name ''``) at the configuration's sizes for
``--data_name``, with random weights, on the card unless ``--device cpu``
is given, and appends its table to ``{output_dir}/summary.md``
(``report.summary``); prints each model's total.
"""

from __future__ import annotations

from ..config import process_control
from ..models import build_model
from ..report.summary import summarize_model
from ..train.loop import apply_family_overrides
from ..utils import resolve_device
from ._common import parse_cfg

MODELS = ("cvae", "mcvae", "vqvae", "classifier", "cgan", "mcgan", "cglow", "mcglow",
          "cpixelcnn", "mcpixelcnn")


def summarize_cfg_model(cfg: dict, model_name: str) -> str:
    """The table of ``model_name`` built from ``cfg`` (10 classes unless
    ``cfg`` sets ``classes_size``)."""
    cfg = apply_family_overrides(process_control(dict(cfg, model_name=model_name)))
    cfg.setdefault("classes_size", 10)
    model = build_model(cfg, device=resolve_device(cfg.get("device")))
    return summarize_model(model, model_name, cfg["output_dir"])


def main(argv=None, **defaults) -> dict:
    """Summarise the models; returns ``{model_name: table}``."""
    cfg = parse_cfg(argv, **defaults)
    out = {}
    for name in [cfg["model_name"]] if cfg["model_name"] else MODELS:
        out[name] = summarize_cfg_model(cfg, name)
        print(out[name].splitlines()[-1], "-", name)
    return out


if __name__ == "__main__":
    main()
