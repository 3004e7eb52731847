"""CPU parity of the port's VAE family (MCVAE, CVAE) and VQ-VAE against the
JAX package, and their trainer, checkpoint, mode manipulation, workflows
and CLIs on the CPU.

Each tiny model (hidden ``(8, 8)``, one residual block, latent 8, 4
modes, embedding 4, D = 8, K = 16) takes its variables from numpy values on the
port model's tree, which must be the JAX model's (``jax.eval_shape`` of its
init), so both packages compute from the same weights in f32. The JAX
eval step, ``generate`` and one ``make_train_step`` (Adam 3e-4, global-norm
clip 1.0, as the trainers set them) are compiled once per model at a low
XLA optimisation level; the train step for MCVAE and VQ-VAE (CVAE's
forwards are held to the JAX ones in eval mode). The VAEs' reparameterisation noise is one numpy
draw, handed to the port step as ``eps`` and to the JAX step in place of
its ``reparam`` draw. Tolerances, as in ``tests/test_torch_port_classifier.py``
and why there:

- losses ``rtol=1e-4``; the step's gradients ``rtol=1e-4`` /
  ``atol=1e-4 * max|grad|`` per tensor (f32, summation order only);
- parameters after the step within ``2 lr`` everywhere and within
  ``lr / 100`` where the gradient exceeds ``1e-4`` of its tensor's largest
  (Adam's first step is a sign);
- every conv (and the decoder Dense's) bias that feeds a BatchNorm is dead:
  its gradient is rounding noise in both packages (under ``1e-4`` of the
  model's largest gradient), so those are compared as noise;
- BatchNorm statistics and the VQ buffers after the step, the eval
  outputs and ``generate``: ``rtol=1e-4``, ``atol=1e-5 * max|ref|``; VQ
  codes equal;
- ``create`` and ``transit``: codebooks bit-equal, mixed embeddings within
  ``1e-6``.
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcgm_tpu import config as jconfig
from mcgm_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from mcgm_tpu.models import manipulate as jmanip
from mcgm_tpu.models.vae import CVAE as JaxCVAE
from mcgm_tpu.models.vae import MCVAE as JaxMCVAE
from mcgm_tpu.models.vqvae import VQVAE as JaxVQVAE
from mcgm_tpu.train import loop as jloop
from mcgm_tpu.train import optim as jopt
from mcgm_tpu.train import state as jstate
from mcgm_tpu_torch import config as pconfig
from mcgm_tpu_torch.cli import sample as cli_sample
from mcgm_tpu_torch.cli import test_model as cli_test_model
from mcgm_tpu_torch.cli import train as cli_train
from mcgm_tpu_torch.data import datasets as pdatasets
from mcgm_tpu_torch.data.datasets import _make_synthetic
from mcgm_tpu_torch.io.checkpoint import save_checkpoint, to_numpy
from mcgm_tpu_torch.io.images import read_png
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_gan_variables
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.models import manipulate as pmanip
from mcgm_tpu_torch.models.vae import CVAE, MCVAE
from mcgm_tpu_torch.models.vqvae import VQVAE
from mcgm_tpu_torch.train import loop as ploop
from mcgm_tpu_torch.train import optim as popt
from mcgm_tpu_torch.train import state as pstate
from test_torch_port_gan import _fill
from test_torch_port_train import _recording, _tree_keys

B, M, LATENT = 6, 4, 8
STEP = {"mcvae", "vqvae"}  # the models held to one JAX train step (CVAE: its forwards)
LR, CLIP = 3e-4, 1.0
OPT = {"optimizer_name": "Adam", "lr": LR, "weight_decay": 0}
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
ARCH = {
    "mcvae": (MCVAE, JaxMCVAE, dict(data_shape=(32, 32, 3), hidden_size=(8, 8),
                                    latent_size=LATENT, num_res_block=1, num_mode=M,
                                    controller_rate=0.5)),
    "cvae": (CVAE, JaxCVAE, dict(data_shape=(32, 32, 1), hidden_size=(8, 8),
                                 latent_size=LATENT, num_res_block=1, num_mode=M,
                                 embedding_size=4)),
    "vqvae": (VQVAE, JaxVQVAE, dict(data_shape=(32, 32, 3), hidden_size=(8, 8),
                                    embedding_size=8, num_embedding=16, num_res_block=1)),
}
VAE_CFG = {"hidden_size": [8, 8], "latent_size": LATENT, "num_res_block": 1,
           "embedding_size": 4}
VQ_CFG = {"hidden_size": [8, 8], "num_res_block": 1, "embedding_size": 8, "num_embedding": 16,
          "vq_commit": 0.25}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30), err_msg=msg)


def _variables(port, rng):
    v = _fill(to_jax_gan_variables(port), rng)
    if "vq_stats" in v:  # cluster sizes well away from 0, a mean consistent with them
        s = v["vq_stats"]["quantizer"]
        s["cluster_size"] = rng.uniform(1.0, 3.0, s["cluster_size"].shape).astype(np.float32)
        s["embedding"] = rng.standard_normal(s["embedding"].shape).astype(np.float32)
        s["embedding_mean"] = (s["embedding"] * s["cluster_size"]).astype(np.float32)
    return v


@contextlib.contextmanager
def _jax_normal_is(eps):
    """While the JAX step is traced, its one ``jax.random.normal`` of the
    latent's shape (the ``reparam`` draw) returns ``eps``."""
    real = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == eps.shape:
            return jnp.asarray(eps, dtype)
        return real(key, shape, dtype)

    jax.random.normal = normal
    try:
        yield
    finally:
        jax.random.normal = real


@pytest.fixture(scope="module")
def stepped():
    """Per model: one JAX eval step, ``generate`` and train step compiled
    together, and the port's eval, ``generate`` and train step from the
    same variables on the same batch."""
    out = {}
    for i, (name, (pcls, jcls, arch)) in enumerate(ARCH.items()):
        rng = np.random.default_rng(10 + i)
        port = pcls(**arch)
        v = _variables(port, rng)
        port.load_state_dict(from_jax_variables(v), strict=True)
        before = {k: t.clone() for k, t in port.state_dict().items()}
        shape = arch["data_shape"]
        batch = {"img": rng.uniform(-1, 1, (B, *shape)).astype(np.float32),
                 "label": (np.arange(B) % M).astype(np.int32)}
        eps = rng.standard_normal((B, LATENT)).astype(np.float32)
        z = rng.standard_normal((B, LATENT)).astype(np.float32)
        vae = name != "vqvae"

        jm = jcls(**arch)
        opt = _recording(jopt.make_optimizer(OPT, grad_clip=CLIP))
        streams = ("reparam",) if vae else ()
        step = jstate.make_train_step(jm, opt, rng_streams=streams)
        ev = jstate.make_eval_step(jm, rng_streams=streams)
        params, state = jstate.split_variables(v)

        def run(params, state, b, z):  # the optimizer's state made inside: one compile
            ts = jstate.TrainState(params=params, state=state, opt_state=opt.init(params),
                                   rng=jax.random.PRNGKey(0))
            gen = (jm.apply({"params": params, **state}, b["label"], z, method="generate")
                   if vae else None)
            return (ev(params, state, b, jax.random.PRNGKey(1)), gen,
                    step(ts, b) if name in STEP else None)

        with _jax_normal_is(eps):
            compiled = jax.jit(run).lower(params, state, batch, z).compile(compiler_options=O0)
        jev, jgen, stepped_ts = compiled(params, state, batch, z)

        tb = {k: torch.from_numpy(a) for k, a in batch.items()}
        pev = pstate.make_eval_step()(port, tb)
        with torch.no_grad():
            pgen = port.generate(tb["label"], torch.from_numpy(z)) if vae else None
        out[name] = dict(port=port, before=before,
                         jax_eval=jax.tree_util.tree_map(np.asarray, jev), port_eval=pev,
                         jax_gen=None if jgen is None else np.asarray(jgen), port_gen=pgen)
        if name not in STEP:
            continue
        ts, aux = stepped_ts
        pts = pstate.TrainState(port, popt.make_optimizer(port.parameters(), OPT,
                                                          grad_clip=CLIP),
                                rng=torch.Generator() if vae else None)
        first = []
        pts.opt.register_step_pre_hook(lambda *_, p=port, f=first: f.append(
            {n: q.grad.clone() for n, q in p.named_parameters()}))
        paux = pstate.make_train_step()(pts, tb, **({"eps": torch.from_numpy(eps)} if vae
                                                      else {}))
        out[name].update(
            jax_loss=float(aux["loss"]), port_loss=float(paux["loss"]),
            jax_grads=_tree_keys("x", ts.opt_state[1]), port_grads=first[0],
            jax_after=from_jax_variables(jax.tree_util.tree_map(
                np.asarray, {"params": ts.params, **ts.state})),
            jax_out=jax.tree_util.tree_map(np.asarray, aux["output"]), port_out=paux["output"])
    return out


@pytest.mark.parametrize("name", list(ARCH))
def test_forward_and_generate_match_jax(stepped, name):
    """Eval mode from the starting variables (z = mu for the VAEs), the
    train forward's outputs with the injected noise (the models that take a
    step below), and ``generate``."""
    s = stepped[name]
    keys = ("loss", "img", "mu", "logvar") if name != "vqvae" else ("loss", "img", "code")
    pairs = [("port_eval", "jax_eval")] + ([("port_out", "jax_out")] if name in STEP else [])
    for k in keys:
        for got, want in ((s[p][k].detach(), s[j][k]) for p, j in pairs):
            if k == "code":
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                _close(got.numpy(), want, msg=k)
    if name != "vqvae":
        assert s["port_gen"].shape == (B, 32, 32, ARCH[name][2]["data_shape"][-1])
        _close(s["port_gen"].numpy(), s["jax_gen"])
    if name in STEP:
        np.testing.assert_allclose(s["port_loss"], s["jax_loss"], rtol=1e-4)


@pytest.mark.parametrize("name", sorted(STEP))
def test_train_step_matches_jax(stepped, name):
    """The step's gradients, every parameter after the clipped Adam update,
    the BatchNorm statistics and the VQ buffers it moved."""
    s = stepped[name]
    port = s["port"]
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == {k[len("x."):] for k in s["jax_grads"]}
    top = max(np.abs(g.numpy()).max() for g in s["jax_grads"].values())
    after = port.state_dict()
    dead = []
    for k in names:
        w, g = s["jax_grads"][f"x.{k}"].numpy(), s["port_grads"][k].numpy()
        want, got = s["jax_after"][k].numpy(), after[k].numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR, (k, diff.max() / LR)
        if np.abs(w).max() <= 1e-4 * top:  # zero but for rounding in both
            assert np.abs(g).max() <= 1e-4 * top, k
            dead.append(k)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
        clear = np.abs(w) > 1e-4 * np.abs(w).max()
        assert diff[clear].max() <= LR / 100, (k, diff[clear].max() / LR)
    assert dead and all(k.endswith(".bias") for k in dead), dead
    buffers = [k for k, _ in port.named_buffers() if not k.endswith("codebook")]
    for k in buffers:
        _close(after[k].numpy(), s["jax_after"][k].numpy(), msg=k)
        assert not torch.equal(after[k], s["before"][k]), k


def test_skipped_step_restores_the_vq_buffers():
    """A NaN in the batch: the whole update is dropped, the quantizer's
    three buffers and the BatchNorm statistics with it."""
    model = VQVAE(**ARCH["vqvae"][2])
    ts = pstate.TrainState(model, popt.make_optimizer(model.parameters(), OPT, grad_clip=CLIP))
    step = pstate.make_train_step(skip_nonfinite=True)
    img = torch.rand((B, 32, 32, 3)) * 2 - 1
    step(ts, {"img": img})
    before = {k: t.clone() for k, t in model.state_dict().items()}
    bad = img.clone()
    bad[0, 0, 0, 0] = float("nan")
    aux = step(ts, {"img": bad})
    assert float(aux["skipped"]) == 1.0
    assert all(torch.equal(t, before[k]) for k, t in model.state_dict().items())
    aux = step(ts, {"img": img})
    assert float(aux["skipped"]) == 0.0
    assert not torch.equal(model.quantizer.embedding, before["quantizer.embedding"])


# ---------------------------------------------------------- manipulation
@pytest.mark.parametrize("torch_compat", [False, True])
@pytest.mark.parametrize("name", ["mcvae", "cvae"])
def test_create_and_transit_match_jax(name, torch_compat):
    """``create`` in both streams (the reference's torch stream visits the
    decoder's ``MultimodalController_0`` and ``_1``, its residual blocks,
    then ``_2`` on) and ``transit``, on the port model's state and on the
    same variables in the JAX package."""
    pcls, _, arch = ARCH[name]
    model = pcls(**dict(arch, hidden_size=(8, 8, 8), num_res_block=3), seed=1)
    variables = to_jax_gan_variables(model)

    def check(got, want):
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, want))
        assert set(got) == set(want)
        for k, w in want.items():
            if k.endswith("codebook"):
                assert torch.equal(got[k], w), k
            elif k.endswith("embedding.weight"):
                assert got[k].shape == w.shape and (got[k] - w).abs().max() <= 1e-6, k
            else:
                assert torch.equal(got[k], w) and torch.equal(got[k], model.state_dict()[k]), k

    check(pmanip.create(model, 7, rng_seed=5, torch_compat=torch_compat, model_name=name),
          jmanip.create(variables, 7, rng_seed=5, torch_compat=torch_compat, model_name=name))
    alpha = 0.375 if torch_compat else 0.8
    check(pmanip.transit(model, 1, alpha), jmanip.transit(variables, 1, alpha))


# ---------------------------------------------------------------- trainer
@pytest.mark.parametrize("name", ["mcvae", "cvae", "vqvae"])
def test_config_matches_jax(name):
    """``process_control`` and the trainers' overrides (Adam 3e-4, clip 1,
    ReduceLROnPlateau on BCE / MSE, min) equal the JAX package's; the
    factory builds the model, on the card unless asked for the CPU."""
    base = dict(jconfig.load_config(), data_name="CIFAR10", model_name=name)
    ctrl = "0.5" if name == "mcvae" else "None"
    p = ploop.apply_family_overrides(pconfig.process_control(
        pconfig.apply_control_name(base, ctrl)))
    j = jloop.apply_family_overrides(jconfig.process_control(
        jconfig.apply_control_name(base, ctrl)))
    assert p == j
    assert (p["pivot_metric"], p["scheduler_name"], p["lr"]) == (
        "MSE" if name == "vqvae" else "BCE", "ReduceLROnPlateau", 3e-4)
    p["classes_size"] = 10
    assert isinstance(build_model(p, "cpu"), ARCH[name][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(p)


def _argv(tmp, name, *extra):
    return ["--data_name", "Synthetic", "--model_name", name, "--control_name",
            "0.5" if name == "mcvae" else "None", "--device", "cpu",
            "--output_dir", str(tmp), *extra]


COMMON = dict(derive_model_params=False, vae=VAE_CFG, vqvae=VQ_CFG, derive_batch_size=False,
              batch_size={"train": 64, "test": 64}, limit_train_batches=2, log_interval=1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """MCVAE: 2 epochs of 2 steps through ``cli.train``, each evaluated on
    the whole train split; 1 epoch, then ``resume_mode=1`` to epoch 2
    (another folder); ``cli.test_model`` on the first run's ``_best``.
    VQ-VAE: 1 epoch and ``cli.test_model``."""
    tmp = tmp_path_factory.mktemp("vae")
    with pytest.MonkeyPatch.context() as mp:  # one draw of the synthetic data for all six
        mp.setattr(pdatasets, "_make_synthetic", functools.lru_cache(_make_synthetic))
        (full,) = cli_train.main(_argv(tmp / "full", "mcvae", "--num_epochs", "2"), **COMMON)
        cli_train.main(_argv(tmp / "split", "mcvae", "--num_epochs", "1"), **COMMON)
        (split,) = cli_train.main(_argv(tmp / "split", "mcvae", "--num_epochs", "2",
                                        "--resume_mode", "1"), **COMMON)
        (tested,) = cli_test_model.main(_argv(tmp / "full", "mcvae"), **COMMON)
        (vq,) = cli_train.main(_argv(tmp / "vq", "vqvae", "--num_epochs", "1"), **COMMON)
        (vq_tested,) = cli_test_model.main(_argv(tmp / "vq", "vqvae"), **COMMON)
    return dict(tmp=tmp, full=full, split=split, tested=tested, vq=vq, vq_tested=vq_tested)


def test_resume_is_bit_equal(runs):
    """Mode 1 from the epoch-1 checkpoint ends where the uninterrupted run
    ends: weights, BatchNorm statistics, Adam's state, the scheduler, the
    reparameterisation generator and the logger's history."""
    full, split = runs["full"], runs["split"]
    assert split.resumed["epoch"] == 2 and [s["epoch"] for s in split.epoch_stats] == [2]
    a, b = to_numpy(full.state_dict()), to_numpy(split.state_dict())
    assert "torch_rng" in a
    for k in ("model_dict", "optimizer_dict", "scheduler_dict", "torch_rng"):
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, a[k], b[k])), k
    assert dict(full.logger.history) == dict(split.logger.history)


def test_trainers_evaluate_and_reevaluate(runs):
    """BCE (MCVAE) and MSE (VQ-VAE) each epoch on the train split;
    ``cli.test_model`` scores ``_best`` as the run that wrote it."""
    for exp, tested, metric in ((runs["full"], runs["tested"], "BCE"),
                                (runs["vq"], runs["vq_tested"], "MSE")):
        hist = exp.logger.history
        assert all(np.isfinite(hist[f"{s}/{m}"]).all() and len(hist[f"{s}/{m}"]) ==
                   len(exp.epoch_stats) for s in ("train", "test") for m in ("Loss", metric))
        assert exp.epoch_stats[-1]["train_steps"] == 2 and exp.epoch_stats[-1]["eval_images"] == 1024
        best = int(np.argmin(hist[f"test/{metric}"]))
        np.testing.assert_allclose(tested.history[f"test/{metric}"],
                                   hist[f"test/{metric}"][best], rtol=1e-6)


def test_checkpoints_read_by_jax(runs, stepped):
    """The JAX package's ``load_checkpoint`` reads the port's MCVAE and
    VQ-VAE checkpoints: the models' variable trees, ``vq_stats`` included,
    which ``stepped`` holds to the JAX models' own."""
    for exp in (runs["full"], runs["vq"]):
        ckpt = jax_load_checkpoint(exp.cfg, exp.tag, "best")
        want = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype),
                                      to_jax_gan_variables(exp.model))
        got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), ckpt["model_dict"])
        assert got == want
    assert set(ckpt["model_dict"]) == {"params", "batch_stats", "vq_stats"}


@pytest.mark.parametrize("name,workflow", [("mcvae", "generate"), ("mcvae", "transit"),
                                           ("mcvae", "create"), ("cvae", "transit")])
def test_sample_cli_on_the_cpu(runs, name, workflow):
    """The workflows from the trained MCVAE's ``_best``, and ``transit``
    (which interpolates both embeddings) from a CVAE checkpoint; every PNG
    read back. A VQ-VAE cannot sample."""
    tmp = runs["tmp"]
    out = tmp / ("full" if name == "mcvae" else "cvae")
    if name == "cvae":
        model = CVAE((32, 32, 3), (8, 8), LATENT, 1, 10, 4)
        save_checkpoint({"output_dir": str(out)}, "0_Synthetic_label_cvae",
                        {"model_dict": to_jax_gan_variables(model), "epoch": 1}, kind="best")
    prefix = {"generate": "generated", "transit": "transited", "create": "created"}[workflow]
    cli_sample.main(workflow, _argv(out, name, "--save_per_mode", "2"), **COMMON)
    vis = [f for f in sorted(os.listdir(out / "vis")) if f.startswith(prefix)]
    assert vis
    for f in vis:
        assert read_png(str(out / "vis" / f)).shape[-1] == 3


def test_vqvae_cannot_sample(runs):
    with pytest.raises(ValueError, match="cannot sample"):
        cli_sample.main("generate", _argv(runs["tmp"] / "vq", "vqvae"), **COMMON)
