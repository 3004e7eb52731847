"""Shared CLI plumbing (port of ``mcgm_tpu/cli/_common.py::parse_cfg``).

Every key of the base config is a flag (``--data_name``, ``--model_name``,
``--init_seed``, ``--resume_mode``, ``--device`` ...); dict- and list-valued
keys take YAML literals (``--batch_size '{train: 64, test: 256}'``).
``--control_name`` zips onto the ``control`` keys, and ``--config PATH``
replaces the packaged ``config.yml`` as the base (its extra keys become
flags too).
"""

from __future__ import annotations

import argparse
import sys

import yaml

from ..config import apply_control_name, load_config


def _split_config_flag(argv):
    """Take ``--config PATH`` / ``--config=PATH`` out of ``argv`` before
    argparse runs: the other flags are built from the file it names."""
    path, rest, i = None, [], 0
    while i < len(argv):
        a = argv[i]
        if a == "--config":
            if i + 1 >= len(argv):
                raise SystemExit("--config requires a path argument")
            path, i = argv[i + 1], i + 2
        elif a.startswith("--config="):
            path, i = a.split("=", 1)[1], i + 1
        else:
            rest.append(a)
            i += 1
    return path, rest


def parse_cfg(argv=None, **defaults) -> dict:
    """The config from the base file, then ``defaults``, then the flags."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    config_path, argv = _split_config_flag(argv)
    cfg = load_config(config_path)
    cfg.update(defaults)
    parser = argparse.ArgumentParser(description="cfg")
    for k, v in cfg.items():
        if isinstance(v, (bool, dict, list)):
            parser.add_argument(f"--{k}", default=None, type=yaml.safe_load)
        else:
            parser.add_argument(f"--{k}", default=None, type=type(v))
    parser.add_argument("--control_name", default=None, type=str)
    args = vars(parser.parse_args(argv))
    control_name = args.pop("control_name")
    for k, v in args.items():
        if v is not None:
            cfg[k] = v
    return apply_control_name(cfg, control_name)
