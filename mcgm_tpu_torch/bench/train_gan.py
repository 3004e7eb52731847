"""MCGAN / CIFAR10 training throughput on one card: ``bench.py``'s protocol
run by the port.

The model is the port's CIFAR10 MCGAN at full width and depth (G hidden
256x4, D hidden 128x4, latent 128, 10 modes, controller rate 0.5,
``cifar_style``), with random weights from seed 0, bf16 operands and f32
parameters; Adam 2e-4 with betas (0.5, 0.999) for G and D; one step is 5 D
updates and 1 G update with the fused D pass and the hinge loss. The batch is
128 uniform images in [-1, 1] with labels ``arange(128) % 10`` (the repo
holds no dataset). 3 warm-up steps, then 30 timed steps between
``torch.cuda.synchronize()`` calls. Usage, on a machine with a card:

    python -m mcgm_tpu_torch.bench.train_gan [--plain]

``--plain`` routes every hand-written kernel to its plain PyTorch version.
Prints one JSON line: images/s, the card's name and power limit, and the
first D-block kernel's launches per step.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import process_control
from ..kernels import first_dblock as fd
from ..models import build_model
from ..train.optim import make_optimizer
from ..train.state import GANTrainState, make_gan_train_step
from ..utils import card_name_and_limit

LR, BETAS, D_ITER = 2e-4, (0.5, 0.999), 5
NUM_MODE = 10
WARMUP, STEPS = 3, 30


def bench_config(gan: dict | None = None, batch: int | None = None) -> dict:
    """The processed config of the CIFAR10 MCGAN; ``gan`` and ``batch``
    shrink it (tests only)."""
    cfg = process_control({"data_name": "CIFAR10", "model_name": "mcgan",
                           "control": {"controller_rate": "0.5"},
                           "derive_model_params": gan is None})
    if gan is not None:
        cfg["gan"] = gan
    if batch is not None:
        cfg["batch_size"] = {"train": batch, "test": batch}
    cfg.update(classes_size=NUM_MODE, init_seed=0)
    return cfg


def bench_state(cfg: dict, device=None, plain: bool = False):
    """``(GANTrainState, batch)`` on ``device`` (the card unless the caller
    passes ``"cpu"``): the model, Adam for G and D, z's generator seeded 1,
    and the batch from seed 0."""
    model = build_model(cfg, device).use_plain_kernels(plain)
    dev = model.generator.Dense_0.weight.device
    opt = {"optimizer_name": "Adam", "lr": LR, "weight_decay": 0}
    ts = GANTrainState(model, make_optimizer(model.generator.parameters(), opt, LR, BETAS),
                       make_optimizer(model.discriminator.parameters(), opt, LR, BETAS),
                       torch.Generator(dev).manual_seed(1))
    B = cfg["batch_size"]["train"]
    g = torch.Generator(dev).manual_seed(0)
    img = torch.rand((B, *cfg["data_shape"]), generator=g, device=dev) * 2 - 1
    return ts, {"img": img, "label": torch.arange(B, device=dev) % cfg["classes_size"]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_steps(ts: GANTrainState, batch: dict, step, steps: int, warmup: int) -> dict:
    """``warmup`` steps, then ``steps`` steps on the host clock between
    synchronisations. Returns images/s, ms per step, the first D-block
    kernel's launches per timed step and the last step's losses."""
    dev = batch["img"].device
    for _ in range(warmup):
        step(ts, batch)
    _sync(dev)
    fd.first_dblock.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(ts, batch)
    _sync(dev)
    dt = time.perf_counter() - t0
    return {"images_per_sec": batch["img"].shape[0] * steps / dt, "ms_per_step": dt / steps * 1e3,
            "first_dblock_launches_per_step": fd.first_dblock.launches / steps,
            "losses": {k: float(v) for k, v in metrics.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plain", action="store_true",
                    help="route the hand-written kernels to their plain versions")
    args = ap.parse_args(argv)
    ts, batch = bench_state(bench_config(), plain=args.plain)  # raises without a card
    res = time_steps(ts, batch, make_gan_train_step(D_ITER), STEPS, WARMUP)
    name, limit = card_name_and_limit().rsplit(",", 1)
    print(json.dumps({"metric": "mcgan_cifar10_train_images_per_sec",
                      "value": res["images_per_sec"], "unit": "images/sec", "device": name.strip(),
                      "power_limit_w": float(limit.split()[0]),
                      "first_dblock_launches_per_step": res["first_dblock_launches_per_step"],
                      "ms_per_step": res["ms_per_step"], "plain": args.plain}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
