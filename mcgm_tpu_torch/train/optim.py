"""Optimizers. Port of ``mcgm_tpu/train/optim.py::make_optimizer``,
``get_learning_rate`` and ``set_learning_rate``.

The JAX package chains optax transforms: global-norm clipping, then the
decayed weights, then the rule (SGD / RMSprop / Adam / Adamax), then a
linear per-step warm-up factor. Here each rule is a ``torch.optim``
optimizer that applies the same chain in :meth:`_Chain.step`:

- SGD, Adam and Adamax are torch's own: their updates (L2 weight decay added
  to the gradient, ``lr * m_hat / (sqrt(v_hat) + eps)`` for Adam,
  ``max(b2 * u, |g| + eps)`` for Adamax, momentum ``t = g + m t``) are optax's;
  the warm-up factor scales their lr for the step.
- RMSprop is written here: optax adds eps inside the square root, decays by
  0.9 and keeps lr inside the momentum trace, torch does none of these.

The lr lives in each ``param_group`` and may be set between steps
(:func:`set_learning_rate`); the host-side :class:`Scheduler` (port of the
JAX package's) computes each epoch's lr, which the train loop writes there.
"""

from __future__ import annotations

import math

import torch


class _Chain:
    """Clip, then the rule with its weight decay, then the warm-up factor
    ``min(1, (count + 1) / warmup)`` for the ``count``-th update (off at 0)."""

    def __init__(self, params, *args, warmup: int = 0, grad_clip: float | None = None,
                 **kwargs):
        super().__init__(params, *args, **kwargs)
        self.warmup, self.grad_clip, self.count = warmup, grad_clip, 0

    def warmup_factor(self) -> float:
        return min(1.0, (self.count + 1) / self.warmup) if self.warmup > 0 else 1.0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("the optimizers of this package take no closure")
        if self.grad_clip is not None:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        self._update(self.warmup_factor())
        self.count += 1

    def state_dict(self) -> dict:
        """torch's state, plus the count of updates the warm-up reads."""
        return {**super().state_dict(), "chain_count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("chain_count", 0))
        super().load_state_dict(state_dict)

    def _update(self, factor: float) -> None:
        """torch's rule, with lr scaled by ``factor`` for this step."""
        lrs = [g["lr"] for g in self.param_groups]
        for g in self.param_groups:
            g["lr"] = g["lr"] * factor
        try:
            super().step()
        finally:
            for g, lr in zip(self.param_groups, lrs):
                g["lr"] = lr


class SGD(_Chain, torch.optim.SGD):
    pass


class Adam(_Chain, torch.optim.Adam):
    pass


class Adamax(_Chain, torch.optim.Adamax):
    pass


class RMSprop(_Chain, torch.optim.Optimizer):
    """optax's ``rmsprop(lr, decay=0.9, eps=1e-8, momentum)``:
    ``nu = decay nu + (1 - decay) g^2``, ``t = momentum t + lr g / sqrt(nu + eps)``,
    update ``-factor t``."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.0, weight_decay: float = 0.0, **chain):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay), **chain)

    def _update(self, factor: float) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                nu, trace = state["nu"], state["trace"]
                nu.mul_(group["decay"]).addcmul_(g, g, value=1 - group["decay"])
                u = g * torch.rsqrt(nu + group["eps"]) * group["lr"]
                trace.mul_(group["momentum"]).add_(u)
                p.sub_(trace * factor)


def make_optimizer(params, cfg: dict, lr: float | None = None, betas: tuple = (0.9, 0.999),
                   grad_clip: float | None = None) -> torch.optim.Optimizer:
    """The optimizer ``cfg["optimizer_name"]`` names over ``params``, with
    ``cfg["lr"]`` (unless ``lr`` is given), ``cfg["weight_decay"]``,
    ``cfg["momentum"]`` (SGD, RMSprop), ``betas`` (Adam, Adamax),
    ``cfg["lr_warmup_steps"]`` and ``grad_clip`` (global norm)."""
    lr = cfg["lr"] if lr is None else lr
    name = cfg["optimizer_name"]
    wd = cfg.get("weight_decay", 0.0) or 0.0
    mom = cfg.get("momentum", 0.0) or 0.0
    chain = dict(warmup=int(cfg.get("lr_warmup_steps", 0) or 0), grad_clip=grad_clip)
    if name == "SGD":
        return SGD(params, lr=lr, momentum=mom, weight_decay=wd, **chain)
    if name == "RMSprop":
        return RMSprop(params, lr=lr, momentum=mom, weight_decay=wd, **chain)
    if name == "Adam":
        return Adam(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd, **chain)
    if name == "Adamax":
        return Adamax(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd, **chain)
    raise ValueError(f"Not valid optimizer name: {name}")


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set the lr of every param group; the next step uses it."""
    for g in opt.param_groups:
        g["lr"] = float(lr)


class Scheduler:
    """Host-side epoch scheduler (port of ``mcgm_tpu/train/optim.py::Scheduler``).

    ``step(metric)`` advances one epoch and returns the new lr; the caller
    writes it into its optimizers with :func:`set_learning_rate`. Names:
    ``None``, ``StepLR``, ``MultiStepLR``, ``ExponentialLR``,
    ``CosineAnnealingLR``, ``ReduceLROnPlateau`` (relative threshold, mode
    ``cfg['plateau_mode']``) and ``CyclicLR`` (an epoch-level triangle over
    ``[base, 10 base]`` with torch's 2000-step half cycle). Its state is a
    plain dict for checkpoints.
    """

    def __init__(self, cfg: dict, base_lr: float | None = None):
        self.name = cfg["scheduler_name"]
        self.base_lr = cfg["lr"] if base_lr is None else base_lr
        self.cfg = {
            "step_size": cfg.get("step_size", 1),
            "milestones": list(cfg.get("milestones", [])),
            "factor": cfg.get("factor", 0.5),
            "patience": cfg.get("patience", 10),
            "threshold": cfg.get("threshold", 1e-3),
            "min_lr": cfg.get("min_lr", 1e-5),
            "num_epochs": cfg.get("num_epochs", 200),
            "plateau_mode": cfg.get("plateau_mode", "min"),
        }
        self.epoch = 0
        self.lr = self.base_lr
        self.best = math.inf if self.cfg["plateau_mode"] == "min" else -math.inf
        self.num_bad = 0

    def step(self, metric: float | None = None) -> float:
        self.epoch += 1
        c, name = self.cfg, self.name
        if name in ("None", None):
            pass
        elif name == "StepLR":
            self.lr = self.base_lr * c["factor"] ** (self.epoch // c["step_size"])
        elif name == "MultiStepLR":
            self.lr = self.base_lr * c["factor"] ** sum(self.epoch >= m for m in c["milestones"])
        elif name == "ExponentialLR":
            self.lr = self.base_lr * 0.99 ** self.epoch
        elif name == "CosineAnnealingLR":
            self.lr = 0.5 * self.base_lr * (1 + math.cos(math.pi * self.epoch / c["num_epochs"]))
        elif name == "ReduceLROnPlateau":
            if metric is None:
                raise ValueError("ReduceLROnPlateau requires a metric")
            if c["plateau_mode"] == "max":
                improved = metric > self.best * (1 + c["threshold"])
            else:
                improved = metric < self.best * (1 - c["threshold"])
            if improved:
                self.best, self.num_bad = metric, 0
            else:
                self.num_bad += 1
            if self.num_bad > c["patience"]:
                self.lr = max(self.lr * c["factor"], c["min_lr"])
                self.num_bad = 0
        elif name == "CyclicLR":
            cycle = math.floor(1 + self.epoch / (2 * 2000))
            frac = abs(self.epoch / 2000 - 2 * cycle + 1)
            self.lr = self.base_lr + (10 * self.base_lr - self.base_lr) * max(0.0, 1 - frac)
        else:
            raise ValueError(f"Not valid scheduler name: {name}")
        return self.lr

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.epoch, self.lr, self.best = d["epoch"], d["lr"], d["best"]
        self.num_bad = d["num_bad"]
