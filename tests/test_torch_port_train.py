"""CPU parity of the PyTorch port's GAN train step and optimizers against the
JAX package.

One tiny CIFAR-style MCGAN (G and D hidden 16, B=4, 32x32) gets its
variables from numpy (``jax.eval_shape`` of the JAX init plus values, so no
init is compiled); the JAX step is built and compiled once, at ``d_iter=2``
with the D loop unrolled, and both packages take one step from the same
state, batch and z, in f32. The z are JAX's own draws from the step's key
chain, handed to the port.

Tolerances, and why:

- losses and gradients: f32 on both sides, in other summation orders through
  a dozen layers: ``rtol=1e-4`` and ``atol = 1e-4 * max|grad|`` per tensor;
- parameters: Adam's first update is ``lr * g / |g|``, a sign, so an element
  whose gradient is rounding noise may step the other way: every element
  within ``2 lr`` per update it took (D two, G one), and every element whose
  first gradient exceeds ``1e-4 * max|grad|`` of its tensor within
  ``lr / 100`` of JAX's;
- BatchNorm statistics, spectral ``u`` and codebooks: ``rtol=1e-4, atol=1e-5``.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from mcgm_tpu.models.gan import MCGAN as JaxMCGAN
from mcgm_tpu.train import optim as jopt
from mcgm_tpu.train import state as jstate
from mcgm_tpu_torch.bench import train_gan as bench
from mcgm_tpu_torch.io.jax_import import from_jax_gan_train_state, from_jax_variables
from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.models.gan import MCGAN
from mcgm_tpu_torch.train import optim as popt
from mcgm_tpu_torch.train import state as pstate
from test_torch_port_gan import _fill

LR, BETAS = 2e-4, (0.5, 0.999)
D_ITER, B, K, LATENT = 2, 4, 4, 16
ARCH = dict(data_shape=(32, 32, 3), latent_size=LATENT, generator_hidden_size=(16,) * 4,
            discriminator_hidden_size=(16,) * 4, num_mode=K, controller_rate=0.5,
            cifar_style=True)
ADAM = {"optimizer_name": "Adam", "lr": LR, "weight_decay": 0}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
# the parameters by module, as the tiny model has them (3 G blocks; D's first
# block and 3 more): each is checked on its own
GROUPS = [f"generator.{m}." for m in ("Dense_0", "blocks._MCGenResBlock_0",
                                      "blocks._MCGenResBlock_1", "blocks._MCGenResBlock_2",
                                      "BatchNorm_0", "Conv_0")]
GROUPS += [f"discriminator.{m}." for m in ("blocks._MCFirstDisResBlock_0",
                                          "blocks._MCDisResBlock_0", "blocks._MCDisResBlock_1",
                                          "blocks._MCDisResBlock_2", "SNDense_0")]
SIGN_NOISE = 1e-4
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _recording(opt):
    """``opt`` whose state also keeps the gradients of its first update."""

    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params), jnp.zeros((), jnp.int32)

    def update(grads, state, params=None):
        inner, first, n = state
        first = jax.tree.map(lambda f, g: jnp.where(n == 0, g, f), first, grads)
        updates, inner = opt.update(grads, inner, params)
        return updates, (inner, first, n + 1)

    return optax.GradientTransformation(init, update)


def _record_grads(opt, module, prefix):
    """Before each step of ``opt``, the gradients of ``module``'s parameters
    under their ``state_dict`` keys."""
    seen = []
    opt.register_step_pre_hook(lambda *_: seen.append(
        {f"{prefix}.{n}": p.grad.clone() for n, p in module.named_parameters()
         if p.grad is not None}))
    return seen


def _port_state(variables=None, seed=0):
    """The port's train state, with the JAX model's ``variables`` if given."""
    model = MCGAN(**ARCH, seed=seed)
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables), strict=True)
    return pstate.GANTrainState(
        model, popt.make_optimizer(model.generator.parameters(), ADAM, LR, BETAS),
        popt.make_optimizer(model.discriminator.parameters(), ADAM, LR, BETAS),
        torch.Generator().manual_seed(seed))


def _tree_keys(collection, tree):
    return from_jax_variables({"params": {collection: tree}})


def _jax_step(variables, img, label):
    """The JAX step, compiled once at a low backend optimisation level (the
    compile, not the run, is what costs here), from a fresh optimizer state;
    returns the new state, the metrics and the z it drew."""
    jm = JaxMCGAN(**ARCH)
    g_opt = _recording(jopt.make_optimizer(ADAM, LR, BETAS))
    d_opt = _recording(jopt.make_optimizer(ADAM, LR, BETAS))
    step = jstate.make_gan_train_step(jm, g_opt, d_opt, d_iter=D_ITER, unroll=D_ITER)

    def run(v, batch, key):
        params, state = jstate.split_variables(v)
        ts = jstate.GANTrainState(
            g_params=params["generator"], d_params=params["discriminator"], state=state,
            g_opt_state=g_opt.init(params["generator"]),
            d_opt_state=d_opt.init(params["discriminator"]), rng=key)
        zs = []  # the step's own draws: one split per D update, then G's
        for _ in range(D_ITER + 1):
            key, sub = jax.random.split(key)
            zs.append(jax.random.normal(sub, (B, LATENT)))
        return (*step(ts, batch), zs)

    args = (variables, {"img": img, "label": label}, jax.random.PRNGKey(1))
    compiled = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    return compiled(*args)


@pytest.fixture(scope="module")
def stepped():
    """One JAX step and one port step from the same state, batch and z."""
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    label = (np.arange(B) % K).astype(np.int32)
    rngs = {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(1)}
    v = _fill(jax.eval_shape(lambda: JaxMCGAN(**ARCH).init(
        rngs, {"img": img, "label": label}, train=True)), rng)
    # torch's first optimizer imports torch._dynamo (seconds): build the
    # port's state while XLA compiles, which releases the interpreter lock
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_state, v)
        new, metrics, zs = _jax_step(v, img, label)
        pts = port.result()
    before = {k: t.clone() for k, t in pts.model.state_dict().items()}
    g_seen = _record_grads(pts.g_opt, pts.model.generator, "generator")
    d_seen = _record_grads(pts.d_opt, pts.model.discriminator, "discriminator")
    launches = fd.first_dblock.launches
    got = pstate.make_gan_train_step(d_iter=D_ITER)(
        pts, {"img": torch.from_numpy(img), "label": torch.from_numpy(label)},
        z=[torch.tensor(np.asarray(z)) for z in zs])
    return dict(
        jax_metrics={k: float(m) for k, m in metrics.items()},
        port_metrics={k: float(m) for k, m in got.items()},
        jax_grads={**_tree_keys("generator", new.g_opt_state[1]),
                   **_tree_keys("discriminator", new.d_opt_state[1])},
        port_grads={**g_seen[0], **d_seen[0]}, n_updates=(len(d_seen), len(g_seen)),
        jax_after=from_jax_gan_train_state(new.g_params, new.d_params, new.state),
        port_after=pts.model.state_dict(), before=before, port=pts,
        launches=fd.first_dblock.launches - launches)


def test_step_losses_match_jax(stepped):
    for k in ("Loss_D", "Loss_G", "Loss"):
        np.testing.assert_allclose(stepped["port_metrics"][k], stepped["jax_metrics"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert stepped["n_updates"] == (D_ITER, 1)
    assert stepped["launches"] == 0  # CPU tensors: the plain version, no kernel
    names = [n for n, _ in stepped["port"].model.named_parameters()]
    assert all(sum(n.startswith(g) for g in GROUPS) == 1 for n in names)  # GROUPS cover all


@pytest.mark.parametrize("group", GROUPS)
def test_step_gradients_match_jax(stepped, group):
    """The first D update's gradients and the G update's, against those the
    JAX step handed its optimizers."""
    want = {k: a for k, a in stepped["jax_grads"].items() if k.startswith(group)}
    got = {k: g for k, g in stepped["port_grads"].items() if k.startswith(group)}
    assert want and set(got) == set(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max(), err_msg=k)
        assert np.abs(w).max() > 0, k


@pytest.mark.parametrize("group", GROUPS)
def test_step_parameters_match_jax(stepped, group):
    updates = D_ITER if group.startswith("discriminator") else 1
    params = [n for n, _ in stepped["port"].model.named_parameters() if n.startswith(group)]
    assert params
    for k in params:
        want, got = stepped["jax_after"][k].numpy(), stepped["port_after"][k].numpy()
        assert np.abs(want - stepped["before"][k].numpy()).max() > 0.5 * LR, k
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * updates, (k, diff.max() / LR)
        g = np.abs(stepped["jax_grads"][k].numpy())  # the first update's gradient
        clear = g > SIGN_NOISE * g.max()
        assert diff[clear].max() <= LR / 100, (k, diff[clear].max() / LR)


@pytest.mark.parametrize("kind", ["running_mean", "running_var", ".u", "codebook"])
def test_step_buffers_match_jax(stepped, kind):
    """BatchNorm statistics moved once per generate call and each ``u`` once
    per discriminate call, as in the JAX step (``d_iter + 1`` of each)."""
    keys = [k for k in stepped["jax_after"] if k.endswith(kind)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(stepped["port_after"][k].numpy(),
                                   stepped["jax_after"][k].numpy(), err_msg=k, **STATE_TOL)
        if kind != "codebook" and stepped["before"][k].numel() > 1:  # a 1-vector u is +-1
            assert not torch.equal(stepped["port_after"][k], stepped["before"][k]), k


# ------------------------------------------------------------- losses
def _jax_losses(loss_type):
    """The JAX step's own loss closures."""
    step = jstate.make_gan_train_step(SimpleNamespace(latent_size=1), None, None,
                                      loss_type=loss_type)
    cells = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    return cells["_d_losses"], cells["_g_loss"]


@pytest.mark.parametrize("loss_type", ["Hinge", "BCE"])
def test_losses_match_jax(loss_type):
    rng = np.random.default_rng(3)
    real, fake = (rng.normal(0, 2, (8, 1)).astype(np.float32) for _ in range(2))
    jd, jg = _jax_losses(loss_type)
    tr, tf = torch.from_numpy(real), torch.from_numpy(fake)
    np.testing.assert_allclose(float(pstate.d_loss(tr, tf, loss_type)), float(jd(real, fake)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(pstate.g_loss(tf, loss_type)), float(jg(fake)), rtol=1e-6)
    assert pstate.d_loss(tr.bfloat16(), tf.bfloat16(), loss_type).dtype == torch.float32


@pytest.mark.parametrize("loss_type", ["Hinge", "BCE"])
@pytest.mark.parametrize("net", ["D", "G"])
def test_loss_gradients_match_jax(loss_type, net):
    """Gradients of the losses with respect to D's outputs, which start the
    step's backward, against ``jax.grad`` of the JAX step's loss closures."""
    rng = np.random.default_rng(4)
    real, fake = (rng.normal(0, 2, (8, 1)).astype(np.float32) for _ in range(2))
    jd, jg = _jax_losses(loss_type)
    tr, tf = (torch.from_numpy(a).requires_grad_(True) for a in (real, fake))
    if net == "D":
        pstate.d_loss(tr, tf, loss_type).backward()
        pairs = zip((tr.grad, tf.grad), jax.grad(jd, argnums=(0, 1))(real, fake))
    else:
        pstate.g_loss(tf, loss_type).backward()
        pairs = [(tf.grad, jax.grad(jg)(fake))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)


# ------------------------------------------------------------- optimizers
OPTIMIZERS = {
    "adam_warmup": dict(cfg={"optimizer_name": "Adam", "lr": 1e-2, "lr_warmup_steps": 2},
                        betas=(0.5, 0.999)),
    "adam_decay_clip": dict(cfg={"optimizer_name": "Adam", "lr": 1e-2, "weight_decay": 0.1},
                            grad_clip=0.5),
    "adam_set_lr": dict(cfg={"optimizer_name": "Adam", "lr": 1e-2}, set_lr=3e-2),
    "sgd_momentum": dict(cfg={"optimizer_name": "SGD", "lr": 1e-1, "momentum": 0.9,
                              "weight_decay": 0.01}),
    "sgd_set_lr": dict(cfg={"optimizer_name": "SGD", "lr": 1e-1, "momentum": 0.9},
                       set_lr=2e-1),
    "rmsprop_momentum_warmup": dict(cfg={"optimizer_name": "RMSprop", "lr": 1e-2,
                                         "momentum": 0.9, "lr_warmup_steps": 3}),
    "rmsprop": dict(cfg={"optimizer_name": "RMSprop", "lr": 1e-2, "weight_decay": 0.1}),
    "adamax": dict(cfg={"optimizer_name": "Adamax", "lr": 1e-2}, betas=(0.5, 0.99)),
    "adam_bench_decay_warmup": dict(cfg={"optimizer_name": "Adam", "lr": 2e-4,
                                         "weight_decay": 1e-3, "lr_warmup_steps": 3},
                                    betas=(0.5, 0.999)),
    "sgd": dict(cfg={"optimizer_name": "SGD", "lr": 1e-1}),
    "sgd_warmup_clip": dict(cfg={"optimizer_name": "SGD", "lr": 1e-1, "momentum": 0.5,
                                 "lr_warmup_steps": 2}, grad_clip=1.0),
    "sgd_clip_inactive": dict(cfg={"optimizer_name": "SGD", "lr": 1e-1}, grad_clip=100.0),
    "rmsprop_momentum_clip": dict(cfg={"optimizer_name": "RMSprop", "lr": 1e-2,
                                       "momentum": 0.9}, grad_clip=0.5),
    "rmsprop_set_lr": dict(cfg={"optimizer_name": "RMSprop", "lr": 1e-2, "momentum": 0.9},
                           set_lr=5e-3),
    "adamax_decay_clip_warmup": dict(cfg={"optimizer_name": "Adamax", "lr": 1e-2,
                                          "weight_decay": 0.1, "lr_warmup_steps": 2},
                                     grad_clip=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Three steps on fixed gradients; with ``set_lr`` the lr is set after
    the first. f32 both sides; optax takes Adam's bias corrections
    ``1 - b**t`` in f32 (``1 - 0.999`` is off by 1.3e-5 relative there) and
    torch in double, so each update may differ by ``1e-4`` of itself:
    ``rtol=1e-6``, ``atol = 1e-4 * lr`` per step taken."""
    case = OPTIMIZERS[name]
    kw = dict(betas=case.get("betas", (0.9, 0.999)), grad_clip=case.get("grad_clip"))
    rng = np.random.default_rng(7)
    params = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params] for _ in range(3)]

    jo = jopt.make_optimizer(case["cfg"], **kw)
    jp = [jnp.asarray(p) for p in params]
    js = jo.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    to = popt.make_optimizer(tp, case["cfg"], **kw)
    assert popt.get_learning_rate(to) == case["cfg"]["lr"]
    for i, g in enumerate(grads):
        if i == 1 and "set_lr" in case:
            js = jopt.set_learning_rate(js, case["set_lr"])
            popt.set_learning_rate(to, case["set_lr"])
            assert popt.get_learning_rate(to) == case["set_lr"]
        updates, js = jo.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        to.step()
        lr = popt.get_learning_rate(to)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-4 * lr * (i + 1), err_msg=f"{name} step {i}")


def test_set_learning_rate_takes_effect():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = popt.make_optimizer([p], {"optimizer_name": "SGD", "lr": 1.0})
    p.grad = torch.ones(2)
    opt.step()
    popt.set_learning_rate(opt, 0.25)
    opt.step()
    torch.testing.assert_close(p.detach(), torch.full((2,), -1.25), rtol=0, atol=0)
    with pytest.raises(ValueError, match="Not valid optimizer"):
        popt.make_optimizer([p], {"optimizer_name": "Lion", "lr": 1.0})


def test_from_jax_gan_train_state_is_the_model_state_dict(stepped):
    """Every key of the port's MCGAN, with JAX's layouts carried over (HWIO
    kernels to OIHW, [in, out] dense kernels to [out, in])."""
    got, model = stepped["jax_after"], stepped["port"].model
    assert set(got) == set(model.state_dict())
    for k, t in model.state_dict().items():
        assert got[k].shape == t.shape and got[k].dtype == torch.float32, k


# --------------------------------------------------- the step's bookkeeping
def _tiny_batch():
    g = torch.Generator().manual_seed(1)
    return {"img": torch.rand((B, 32, 32, 3), generator=g) * 2 - 1, "label": torch.arange(B) % K}


@pytest.mark.parametrize("d_iter", [1, 3])
@pytest.mark.parametrize("fuse_d_pass", [True, False])
def test_step_calls_and_frozen_discriminator(fuse_d_pass, d_iter):
    """``generate`` and ``discriminate`` in train mode ``d_iter + 1`` times
    each (``2 d_iter + 1`` D calls without the fused pass); no gradient of
    D's is formed in the G update, and D's parameters train again after."""
    ts = _port_state()
    calls = {"generator": 0, "discriminator": 0}
    for name in calls:
        getattr(ts.model, name).register_forward_pre_hook(
            lambda m, args, name=name: calls.__setitem__(name, calls[name] + 1))
    d_seen = _record_grads(ts.d_opt, ts.model.discriminator, "discriminator")
    pstate.make_gan_train_step(d_iter=d_iter, fuse_d_pass=fuse_d_pass)(ts, _tiny_batch())
    assert calls == {"generator": d_iter + 1,
                     "discriminator": d_iter + 1 if fuse_d_pass else 2 * d_iter + 1}
    assert len(d_seen) == d_iter and ts.step == 1
    for n, p in ts.model.discriminator.named_parameters():
        assert p.requires_grad, n
        assert torch.equal(p.grad, d_seen[-1][f"discriminator.{n}"]), n


def test_step_draws_z_from_the_state_generator():
    step = pstate.make_gan_train_step(d_iter=1)
    runs = [step(_port_state(seed=3), _tiny_batch()) for _ in range(2)]
    for k in ("Loss_D", "Loss_G", "Loss"):
        assert torch.equal(runs[0][k], runs[1][k]) and torch.isfinite(runs[0][k])
    with pytest.raises(ValueError, match="latents"):
        step(_port_state(), _tiny_batch(), z=[torch.zeros(B, LATENT)])
    with pytest.raises(ValueError, match="loss_type"):
        pstate.make_gan_train_step(loss_type="Wasserstein")


def test_bench_protocol_on_cpu():
    """The bench's state and timing loop at a tiny width on the CPU, where
    it counts no kernel launch; its entry point refuses to run without a card."""
    cfg = bench.bench_config(gan={"latent_size": LATENT, "generator_hidden_size": [16] * 4,
                                  "discriminator_hidden_size": [16] * 4,
                                  "embedding_size": 8},
                             batch=B)
    assert cfg["data_shape"] == [32, 32, 3] and cfg["classes_size"] == 10
    ts, batch = bench.bench_state(cfg, device="cpu")
    assert ts.model.compute_dtype == torch.float32
    assert batch["img"].shape == (B, 32, 32, 3) and batch["label"].tolist() == [0, 1, 2, 3]
    res = bench.time_steps(ts, batch, pstate.make_gan_train_step(d_iter=1), steps=1, warmup=1)
    assert res["first_dblock_launches_per_step"] == 0 and res["images_per_sec"] > 0
    assert all(np.isfinite(v) for v in res["losses"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main([])
