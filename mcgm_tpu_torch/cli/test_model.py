"""Re-evaluate a trained model from its ``_best`` checkpoint (port of
``mcgm_tpu/cli/test_model.py``):

    python -m mcgm_tpu_torch.cli.test_model --data_name MNIST --model_name classifier \
        --control_name None [--device cpu]

(any model ``cli.train`` takes; a Glow's test pass is its bits/dim on the
train split, its noise from a generator seeded with the seed).

For each seed: build the experiment, load ``{tag}_best`` (written by either
package), run the trainer's test pass and save ``{cfg, epoch, logger}`` to
``{output_dir}/result/{tag}.pkl``. It runs on the card unless ``--device
cpu`` is given, and raises if there is no card.
"""

from __future__ import annotations

import datetime

from ..io.checkpoint import load_checkpoint
from ..io.jax_import import from_jax_variables
from ..report.logger import Logger
from ..train.loop import Experiment
from ..utils import result_path, save
from ._common import parse_cfg


def evaluate_best(cfg: dict, seed: int) -> Logger:
    """The test pass of seed ``seed``'s ``_best`` checkpoint; returns its logger."""
    exp = Experiment(cfg, seed=seed)
    exp.setup()
    ckpt = load_checkpoint(exp.cfg, exp.tag, "best")
    if ckpt is None:
        raise FileNotFoundError(f"no best checkpoint for {exp.tag}")
    exp.model.load_state_dict(from_jax_variables(ckpt["model_dict"]))
    stamp = datetime.datetime.now().strftime("%b%d_%H-%M-%S")
    exp.logger = Logger(f"{exp.cfg['output_dir']}/runs/test_{exp.tag}_{stamp}",
                        backend=exp.cfg.get("log_backend", "jsonl"))
    exp.epoch_stats.append({"epoch": ckpt["epoch"] - 1})
    exp.logger.safe(True)
    exp.test_epoch(ckpt["epoch"] - 1)
    exp.logger.safe(False)
    save({"cfg": exp.cfg, "epoch": ckpt["epoch"], "logger": exp.logger},
         result_path(exp.cfg, exp.tag, "pkl"))
    exp.logger.close()
    return exp.logger


def main(argv=None, **defaults) -> list[Logger]:
    """Parse the flags (``defaults`` set keys first) and evaluate each seed."""
    cfg = parse_cfg(argv, **defaults)
    out = []
    for i in range(int(cfg.get("num_experiments", 1))):
        seed = cfg["init_seed"] + i
        print(f"Experiment: seed {seed}")
        out.append(evaluate_best(cfg, seed))
    return out


if __name__ == "__main__":
    main()
