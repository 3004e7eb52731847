"""The train steps. Port of ``mcgm_tpu/train/state.py``: the generic
single-model ``make_train_step`` and ``make_eval_step``, and
``GANTrainState`` with ``make_gan_train_step``, which takes an MCGAN or a
CGAN.

The single-model step runs the model in train mode on the batch, takes
``output["loss"]``'s gradient and lets the optimizer (which clips) update
the parameters; BatchNorm statistics move in the forward, as the JAX step's
mutated collections do.

One step is ``d_iter`` discriminator updates on the same batch, each with a
fresh z, then one generator update with its own z (the reference's 5:1
alternation). Losses are taken in f32 whatever the compute dtype. Modules
and optimizers carry their own state, so the state object holds them; the
JAX package threads the same state through its pure step:

- each D update runs ``generate`` in train mode on no gradient (the fake is
  a constant of D's loss, but G's BatchNorm running statistics move), then
  D in train mode once on ``concat(real, fake)`` with the labels doubled
  (``fuse_d_pass``), or twice, on real and on fake; every D call in train
  mode stores one power iteration in each spectral ``u``;
- the G update runs ``generate`` and D in train mode with D's parameters
  frozen (``requires_grad`` off for the update, so no gradient of D's is
  formed and none leaks into the next D update); D's ``u`` still moves.

So with ``fuse_d_pass`` a step calls ``generate`` and ``discriminate``
``d_iter + 1`` times each (6 at ``d_iter=5``), without it ``discriminate``
``2 d_iter + 1`` times.

The JAX factory also takes the model and the two optax transforms, which
hold no state there; here they carry their parameters and moments, so they
ride in :class:`GANTrainState` and the factory takes only the step's options.
z comes from the state's ``torch.Generator`` unless the caller passes the
``d_iter + 1`` latents: ``jax.random``'s streams cannot be reproduced here,
so a parity test hands both packages the same z. The JAX step's ``unroll``
is an XLA compile knob with no counterpart in eager PyTorch.

``remat`` (both factories) recomputes each loss's forward in its backward
(``ops.remat``: the buffers the forward moved and the noise generators are
put back for the recompute, so the results equal the step without it). ``fuse_g_pass`` draws the ``d_iter``
fakes from one ``generate`` at batch ``d_iter * B`` with each B-slice's own
BatchNorm statistics and the running ones moved slice by slice
(``ops.layers.batch_stat_slices``), the same z and the same state as the
unfused step's ``d_iter`` calls; the D updates then take those fakes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import batch_stat_slices
from ..ops.remat import remat as _remat

LOSS_TYPES = ("Hinge", "BCE")


@dataclass
class TrainState:
    """A single model, its optimizer, the generator of the model's train-time
    noise (the VAEs' reparameterisation; ``None`` for a model that draws
    none) and the count of steps taken."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0
    rng: torch.Generator | None = None


def make_train_step(skip_nonfinite: bool = False, remat: bool = False):
    """``step(ts, batch, **inputs) -> {"loss", "output"[, "skipped"]}``: one
    update of ``ts.model`` on ``batch``, in place, whose ``model(batch,
    train=True, **inputs)`` returns a dict with ``loss``. ``ts.rng``, if
    set, is passed as ``rng`` (the JAX step's ``rng_streams``); ``inputs``
    may hand the model its noise instead (a VAE's ``eps``).

    ``skip_nonfinite``: when the gradients' global norm is not finite the
    whole update is dropped (parameters, optimizer state, the buffers the
    forward moved) and the result has ``skipped`` = 1.0 (else 0.0); the step
    count still advances. Deciding it reads the norm on the host, one wait
    for the device per step; without the option the step never waits.

    ``remat``: the forward is recomputed in the backward (``ops.remat``),
    with the same gradients, buffers and noise."""

    def step(ts: TrainState, batch: dict, **inputs) -> dict:
        model = ts.model
        saved = ([b.clone() for b in model.buffers()] if skip_nonfinite else None)
        if ts.rng is not None:
            inputs.setdefault("rng", ts.rng)
        if remat:
            out = _remat(model, batch, train=True, modules=(model,),
                         generators=(inputs.get("rng"),), **inputs)
        else:
            out = model(batch, train=True, **inputs)
        ts.opt.zero_grad(set_to_none=True)
        out["loss"].backward()
        aux = {"loss": out["loss"].detach(), "output": out}
        ok = True
        if skip_nonfinite:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            ok = bool(torch.isfinite(norm))
            aux["skipped"] = torch.tensor(0.0 if ok else 1.0, device=norm.device)
            if not ok:
                with torch.no_grad():
                    for b, old in zip(model.buffers(), saved):
                        b.copy_(old)
        if ok:
            ts.opt.step()
        ts.step += 1
        return aux

    return step


def make_eval_step():
    """``step(model, batch, **inputs) -> output``: the forward in eval mode
    (running statistics), without gradients; ``inputs`` go to the model (a
    Glow's noise generator, ``rng``)."""

    @torch.no_grad()
    def step(model: nn.Module, batch: dict, **inputs) -> dict:
        return model(batch, train=False, **inputs)

    return step


def d_loss(d_real: torch.Tensor, d_fake: torch.Tensor, loss_type: str = "Hinge") -> torch.Tensor:
    """Discriminator loss in f32: hinge ``relu(1 - D(x)) + relu(1 + D(G(z)))``,
    or BCE with logits (real 1, fake 0), averaged over the batch."""
    d_real, d_fake = d_real.float(), d_fake.float()
    if loss_type == "Hinge":
        return (F.relu(1.0 - d_real) + F.relu(1.0 + d_fake)).mean()
    bce = F.binary_cross_entropy_with_logits
    return (bce(d_real, torch.ones_like(d_real), reduction="none")
            + bce(d_fake, torch.zeros_like(d_fake), reduction="none")).mean()


def g_loss(d_fake: torch.Tensor, loss_type: str = "Hinge") -> torch.Tensor:
    """Generator loss in f32: ``-mean D(G(z))`` (hinge) or BCE against 1."""
    d_fake = d_fake.float()
    if loss_type == "Hinge":
        return -d_fake.mean()
    return F.binary_cross_entropy_with_logits(d_fake, torch.ones_like(d_fake))


@dataclass
class GANTrainState:
    """The GAN (G and D), their optimizers, the generator of z on the
    model's device, and the count of steps taken."""

    model: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0


def _requires_grad(module: nn.Module, flag: bool) -> None:
    for p in module.parameters():
        p.requires_grad_(flag)


def make_gan_train_step(d_iter: int = 5, loss_type: str = "Hinge", fuse_d_pass: bool = True,
                        remat: bool = False, fuse_g_pass: bool = False):
    """``step(ts, batch, z=None) -> metrics``: one GAN step on
    ``batch = {"img": [B,H,W,C] in [-1, 1], "label": [B]}``, in place on
    ``ts``. ``z``, if given, is ``d_iter + 1`` latents ``[B, latent]`` (one per
    D update, then G's). Returns ``{"Loss_D": mean of the d_iter D losses,
    "Loss_G", "Loss"}`` as f32 tensors on the device (reading them waits for
    the card). ``remat``: each D loss and the G loss recomputed in their
    backward; ``fuse_g_pass``: the D updates' fakes from one ``generate``
    at batch ``d_iter * B`` (see the module's docstring)."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss_type must be one of {LOSS_TYPES}, got {loss_type!r}")

    def d_pass(model, img, fake, label):
        B = img.shape[0]
        if fuse_d_pass:
            out = model.discriminate(torch.cat([img.to(fake.dtype), fake]),
                                     torch.cat([label, label]), train=True)
            d_real, d_fake = out[:B], out[B:]
        else:
            d_real = model.discriminate(img, label, train=True)
            d_fake = model.discriminate(fake, label, train=True)
        return d_loss(d_real, d_fake, loss_type)

    def g_pass(model, z, label):
        fake = model.generate(label, z, train=True)
        return g_loss(model.discriminate(fake, label, train=True), loss_type)

    def run(fn, model, *args, moving=None):
        return (_remat(fn, model, *args, modules=(moving or model,)) if remat
                else fn(model, *args))

    def step(ts: GANTrainState, batch: dict, z=None) -> dict:
        model = ts.model
        img, label = batch["img"], batch["label"]
        B = img.shape[0]
        if z is None:
            z = [torch.randn((B, model.latent_size), generator=ts.rng, device=ts.rng.device)
                 for _ in range(d_iter + 1)]
        if len(z) != d_iter + 1:
            raise ValueError(f"step takes d_iter + 1 = {d_iter + 1} latents, got {len(z)}")

        fakes = None
        if fuse_g_pass:
            with torch.no_grad(), batch_stat_slices(model.generator, d_iter):
                fakes = model.generate(label.repeat(d_iter), torch.cat(list(z[:d_iter])),
                                       train=True).chunk(d_iter)
        d_losses = []
        for i in range(d_iter):
            if fakes is None:
                with torch.no_grad():
                    fake = model.generate(label, z[i], train=True)
            else:
                fake = fakes[i]
            loss = run(d_pass, model, img, fake, label, moving=model.discriminator)
            ts.d_opt.zero_grad(set_to_none=True)
            loss.backward()
            ts.d_opt.step()
            d_losses.append(loss.detach())
        del fakes

        _requires_grad(model.discriminator, False)
        try:
            loss_g = run(g_pass, model, z[d_iter], label)
            ts.g_opt.zero_grad(set_to_none=True)
            loss_g.backward()
            ts.g_opt.step()
        finally:
            _requires_grad(model.discriminator, True)
        ts.step += 1
        loss_d = torch.stack(d_losses).mean()
        loss_g = loss_g.detach()
        return {"Loss_D": loss_d, "Loss_G": loss_g, "Loss": loss_d + loss_g}

    return step
