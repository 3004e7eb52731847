"""MCGlow / CGlow on CIFAR10 at full width on one card: where a train step's
time goes, with and without ``remat_flows``, and the eval forward's and
``generate``'s time.

The model is the port's CIFAR10 Glow (hidden 512, K 16, L 3, affine, LU,
10 modes, rate 0.5 for MCGlow) from seed 0, bf16 convs, set by one DDI
forward over 1,024 seeded images; the trainer's optimizer (Adam 3e-4, a
16-step warmup, clip 1) and step (non-finite updates skipped). The batch is
128 uniform images in [-1, 1] with labels ``arange(128) % 10`` and one
noise draw. Each case: 2 warm-up calls, then ``--reps`` timed calls between
``torch.cuda.synchronize()``. Usage, on a machine with a card:

    python -m mcgm_tpu_torch.bench.glow_step [--model_name cglow] [--reps 5]

Prints one JSON line per case (``step`` through the kernel and through its
plain version, each with ``remat_flows`` on and off; ``eval_forward``;
``generate`` of 128), each with ms per call, images/s, the kernel's
launches per call and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import process_control
from ..kernels import mc_gate
from ..models import build_model
from ..train.loop import apply_family_overrides
from ..train.optim import make_optimizer
from ..train.state import TrainState, make_train_step
from ..utils import card_name_and_limit

B, DDI_IMAGES, WARMUP = 128, 1024, 2


def timed(fn, reps: int) -> tuple[float, float]:
    """Mean ms per call of ``fn`` and the kernel's launches per call."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    before = mc_gate.mc_gated_matmul.launches
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / reps * 1e3,
            (mc_gate.mc_gated_matmul.launches - before) / reps)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_name", default="mcglow", choices=("mcglow", "cglow"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    cfg = apply_family_overrides(process_control({
        "data_name": "CIFAR10", "model_name": args.model_name,
        "control": {"controller_rate": "0.5"}}))
    cfg["classes_size"] = 10
    g = torch.Generator(device=dev).manual_seed(0)
    big = {"img": torch.rand((DDI_IMAGES, 32, 32, 3), generator=g, device=dev) * 2 - 1,
           "label": torch.arange(DDI_IMAGES, device=dev) % 10}
    batch = {k: v[:B] for k, v in big.items()}
    noise = torch.rand((B, 32, 32, 3), generator=g, device=dev)
    model = build_model(cfg, dev)
    with torch.no_grad():
        model(big, train=True, ddi=True,
              noise=torch.rand((DDI_IMAGES, 32, 32, 3), generator=g, device=dev))
    state = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_train_step(skip_nonfinite=True)
    card = card_name_and_limit()
    rows = []

    def report(case, ms, launches, **extra):
        rows.append({"model": args.model_name, "case": case, "ms": ms,
                     "images_per_s": B / ms * 1e3, "mc_gated_matmul_launches": launches,
                     **extra, "card": card})
        print(json.dumps(rows[-1]), flush=True)

    for plain in (False, True):
        for remat in (True, False):
            model.load_state_dict(state)
            model.use_plain_kernels(plain).remat_flows = remat
            ts = TrainState(model, make_optimizer(model.parameters(), cfg,
                                                  grad_clip=cfg["grad_clip"]))
            ms, n = timed(lambda: step(ts, batch, noise=noise), args.reps)
            report("step", ms, n, plain=plain, remat_flows=remat)
    model.load_state_dict(state)
    model.use_plain_kernels(False)
    with torch.no_grad():
        report("eval_forward", *timed(lambda: model(batch, noise=noise), args.reps))
        report("generate", *timed(lambda: model.generate(batch["label"], rng=g), args.reps))
    return rows


if __name__ == "__main__":
    main()
