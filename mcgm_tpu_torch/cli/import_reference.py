"""Import a checkpoint of the reference (PyTorch) implementation as the
port's ``_best`` (the port's counterpart of ``tools/import_torch_checkpoint.py``):

    python -m mcgm_tpu_torch.cli.import_reference REF_CKPT.pt --data_name CIFAR10 \
        --model_name mcgan --control_name 0.5 [--classes_size 10] [--device cpu]

``REF_CKPT.pt`` is a reference trainer's checkpoint (a torch pickle with
``model_dict``) or a bare ``state_dict``. Its weights go through
``io.torch_import`` into the model the flags describe, built on the card
unless ``--device cpu`` is given (the import is checked there: every key
loads), and are written as ``{output_dir}/model/{tag}_best.pkl`` in the
layout the port's checkpoints hold, which ``cli.test_model`` and
``cli.sample`` read.
"""

from __future__ import annotations

import torch

from ..config import make_model_tag, process_control
from ..io.checkpoint import save_checkpoint
from ..io.jax_import import to_jax_gan_variables
from ..io.torch_import import load_reference, reference_dims
from ..models import build_model
from ._common import parse_cfg


def main(argv: list, **defaults) -> str:
    """``argv``: the reference checkpoint's path, then the flags. Returns
    the path written."""
    path, *flags = argv
    cfg = process_control(parse_cfg(flags, **{"classes_size": 10, **defaults}))
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model_dict", blob) if isinstance(blob, dict) else blob
    epoch = blob.get("epoch", 1) if isinstance(blob, dict) else 1
    model = build_model(cfg, cfg.get("device"))
    model.load_state_dict(load_reference(cfg["model_name"], sd, **reference_dims(cfg)),
                          strict=True)
    tag = make_model_tag(cfg, cfg["init_seed"])
    out = save_checkpoint(cfg, tag, {"cfg": cfg, "epoch": epoch,
                                     "model_dict": to_jax_gan_variables(model)}, "best")
    print(f"imported {path} as {out}")
    return out


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
