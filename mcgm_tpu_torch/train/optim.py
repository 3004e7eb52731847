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
(:func:`set_learning_rate`); the host-side epoch ``Scheduler`` comes with the
training loop.
"""

from __future__ import annotations

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
