"""CPU parity of the port's single-model trainer, on the classifier, against
the JAX package: the generic step (``make_train_step``, with the
classifier's clipped Adam), the eval step, the trainer's config, and an
``Experiment`` on the repo's real UCI digits whose ``_best`` checkpoint
becomes the IS / FID feature model and is re-evaluated by ``cli.test_model``.

The JAX step is compiled once at a low XLA optimisation level and both
packages take 3 steps on 3 batches of real digits (B=16, 32x32x1) from the
same variables (numpy values on the port classifier's tree, which is the
JAX classifier's: ``test_classifier_checkpoint_read_by_jax``), in f32.
Tolerances, as in ``tests/test_torch_port_train.py`` and why there:

- losses ``rtol=1e-4``; the first step's gradients ``rtol=1e-4`` /
  ``atol=1e-4 * max|grad|`` per tensor (f32, summation order only);
- parameters: within ``2 lr`` per update everywhere, and within ``lr / 100``
  where the first gradient exceeds ``1e-4`` of its tensor's largest (Adam's
  first step is a sign, so an element whose gradient is rounding noise may
  step the other way);
- BatchNorm statistics after the first step, and the eval step's outputs
  from the same variables, ``rtol=1e-4, atol=1e-5``.

Every conv bias of the classifier feeds a BatchNorm, which removes it in
train mode: its gradient is rounding noise in both packages (each must be
under ``1e-4`` of the model's largest gradient), Adam steps it by a random
sign, and the running means that absorb it part after the first step. So
the statistics are compared after one step, and the eval step on the
starting variables.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcgm_tpu import config as jconfig
from mcgm_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from mcgm_tpu.models.classifier import Classifier as JaxClassifier
from mcgm_tpu.train import loop as jloop
from mcgm_tpu.train import optim as jopt
from mcgm_tpu.train import state as jstate
from mcgm_tpu_torch import config as pconfig
from mcgm_tpu_torch.cli import test_model as cli_test_model
from mcgm_tpu_torch.cli import train as cli_train
from mcgm_tpu_torch.data.datasets import _save_processed
from mcgm_tpu_torch.evals.features import classifier_feature_fn, make_feature_fn
from mcgm_tpu_torch.io.checkpoint import load_checkpoint
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_classifier
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.models.classifier import Classifier
from mcgm_tpu_torch.models.gan import CGAN, MCGAN
from mcgm_tpu_torch.train import loop as ploop
from mcgm_tpu_torch.train import optim as popt
from mcgm_tpu_torch.train import state as pstate
from test_torch_port_gan import _fill
from test_torch_port_train import _recording, _tree_keys

DIGITS = os.path.join(os.path.dirname(__file__), "fixtures", "real_digits_shard.npz")
HIDDEN, SHAPE, B, STEPS = (4, 8, 8, 8), (32, 32, 1), 16, 3
OPT = {"optimizer_name": "Adam", "lr": 1e-2, "weight_decay": 0}  # the classifier's
LR, CLIP = 1e-2, 1.0
TOL = dict(rtol=1e-4, atol=1e-5)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _digits():
    with np.load(DIGITS) as z:
        return z["img"], z["labels"]


def _batches():
    img, labels = _digits()
    x = img[:B * STEPS].astype(np.float32) / 127.5 - 1
    return [{"img": x[i * B:(i + 1) * B], "label": labels[i * B:(i + 1) * B].astype(np.int32)}
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def stepped():
    """3 JAX steps and 3 port steps from the same variables on the same
    batches, then one eval step of each."""
    batches = _batches()
    v = _fill(to_jax_classifier(Classifier(SHAPE, HIDDEN, 10)), np.random.default_rng(2))
    jm = JaxClassifier(SHAPE, HIDDEN, 10)
    opt = _recording(jopt.make_optimizer(OPT, grad_clip=CLIP))
    step, ev = jstate.make_train_step(jm, opt), jstate.make_eval_step(jm)
    params, state = jstate.split_variables(v)
    ts = jstate.TrainState(params=params, state=state, opt_state=opt.init(params),
                           rng=jax.random.PRNGKey(0))

    def run(ts, b):  # one compile: the eval step before the train step
        return ev(ts.params, ts.state, b, jax.random.PRNGKey(1)), step(ts, b)

    compiled = jax.jit(run).lower(ts, batches[0]).compile(compiler_options=O0)
    losses, jax_eval, jax_stats = [], None, None
    for b in batches:
        out, (ts, aux) = compiled(ts, b)
        losses.append(float(aux["loss"]))
        jax_eval = jax_eval or out
        jax_stats = jax_stats or from_jax_variables(jax.device_get(ts.state))

    model = Classifier(SHAPE, HIDDEN, 10)
    model.load_state_dict(from_jax_variables(v), strict=True)
    pts = pstate.TrainState(model, popt.make_optimizer(model.parameters(), OPT,
                                                       grad_clip=CLIP))
    first = []
    pts.opt.register_step_pre_hook(lambda *_: first.append(
        {n: p.grad.clone() for n, p in model.named_parameters()}) if not first else None)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    port_eval = pstate.make_eval_step()(
        model, {k: torch.from_numpy(a) for k, a in batches[0].items()})
    pstep = pstate.make_train_step()
    port_losses, port_stats = [], None
    for b in batches:
        port_losses.append(float(pstep(pts, {k: torch.from_numpy(a) for k, a in b.items()})
                                 ["loss"]))
        port_stats = port_stats or {k: t.clone() for k, t in model.named_buffers()}
    return dict(jax_losses=losses, port_losses=port_losses,
                jax_grads=_tree_keys("x", ts.opt_state[1]), port_grads=first[0],
                jax_after=from_jax_variables(jax.tree_util.tree_map(np.asarray, {
                    "params": ts.params, **ts.state})),
                port_after=model.state_dict(), before=before, model=model, steps=pts.step,
                jax_stats=jax_stats, port_stats=port_stats,
                jax_eval=jax.tree_util.tree_map(np.asarray, jax_eval), port_eval=port_eval)


def test_train_step_losses_match_jax(stepped):
    np.testing.assert_allclose(stepped["port_losses"], stepped["jax_losses"], rtol=1e-4)
    assert stepped["steps"] == STEPS


def test_train_step_gradients_and_parameters_match_jax(stepped):
    """The first step's (unclipped) gradients, then every parameter after
    the three clipped updates."""
    names = [n for n, _ in stepped["model"].named_parameters()]
    assert set(names) == {k[len("x."):] for k in stepped["jax_grads"]}
    top = max(np.abs(g.numpy()).max() for g in stepped["jax_grads"].values())
    dead = []
    for k in names:
        w, g = stepped["jax_grads"][f"x.{k}"].numpy(), stepped["port_grads"][k].numpy()
        want, got = stepped["jax_after"][k].numpy(), stepped["port_after"][k].numpy()
        assert np.abs(want - stepped["before"][k].numpy()).max() > LR / 2, k
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * STEPS, (k, diff.max() / LR)
        if np.abs(w).max() <= 1e-4 * top:  # zero but for rounding in both
            assert np.abs(g).max() <= 1e-4 * top, k
            dead.append(k)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
        clear = np.abs(w) > 1e-4 * np.abs(w).max()
        assert diff[clear].max() <= LR / 100, (k, diff[clear].max() / LR)
    assert sorted(dead) == [f"Conv_{i}.bias" for i in range(len(HIDDEN))]


def test_train_step_batch_statistics_and_eval_match_jax(stepped):
    assert stepped["port_stats"].keys() == stepped["jax_stats"].keys()
    for k, want in stepped["jax_stats"].items():
        got = stepped["port_stats"][k]
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=k, **TOL)
        assert not torch.equal(got, stepped["before"][k]), k
    for k in ("label", "loss"):
        np.testing.assert_allclose(stepped["port_eval"][k].numpy(), stepped["jax_eval"][k],
                                   err_msg=k, **TOL)


def test_skip_nonfinite_drops_the_whole_update():
    """A NaN in the batch makes every gradient NaN: parameters, Adam's
    state and the BatchNorm statistics stay as they were, ``skipped`` is 1,
    the step count advances; the next finite batch updates as usual."""
    model = Classifier(SHAPE, HIDDEN, 10, seed=3)
    ts = pstate.TrainState(model, popt.make_optimizer(model.parameters(), OPT,
                                                      grad_clip=CLIP))
    step = pstate.make_train_step(skip_nonfinite=True)
    b = {k: torch.from_numpy(a) for k, a in _batches()[0].items()}
    step(ts, b)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    opt_before = {i: {n: t.clone() for n, t in s.items()}
                  for i, s in ts.opt.state_dict()["state"].items()}
    bad = dict(b, img=b["img"].clone())
    bad["img"][0, 0, 0, 0] = float("nan")
    aux = step(ts, bad)
    assert float(aux["skipped"]) == 1.0 and ts.step == 2 and ts.opt.count == 1
    assert all(torch.equal(t, before[k]) for k, t in model.state_dict().items())
    for i, s in ts.opt.state_dict()["state"].items():
        assert all(torch.equal(t, opt_before[i][n]) for n, t in s.items())
    aux = step(ts, b)
    assert float(aux["skipped"]) == 0.0 and ts.opt.count == 2
    assert not torch.equal(model.Conv_0.weight, before["Conv_0.weight"])


# ------------------------------------------------------------- trainer
def test_classifier_config_matches_jax():
    """``process_control`` and the classifier's trainer overrides (Adam lr
    1e-2, MultiStepLR at 100 by 0.1, clip 1.0, pivot Accuracy) equal the
    JAX package's; ``build_model`` builds all three ported models."""
    base = dict(jconfig.load_config(), data_name="MNIST", model_name="classifier")
    p = ploop.apply_family_overrides(pconfig.process_control(
        pconfig.apply_control_name(base, "None")))
    j = jloop.apply_family_overrides(jconfig.process_control(
        jconfig.apply_control_name(base, "None")))
    assert p == j
    assert pconfig.make_model_tag(p, 0) == "0_MNIST_label_classifier"
    p["classes_size"] = 10
    assert isinstance(build_model(p, "cpu"), Classifier)
    gan = pconfig.process_control(dict(p, model_name="cgan"))
    assert isinstance(build_model(dict(gan, classes_size=10), "cpu"), CGAN)
    assert isinstance(build_model(dict(gan, model_name="mcgan", classes_size=10), "cpu"), MCGAN)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the classifier on the real digits staged as MNIST
    (1,297 train / 500 test), 2 train batches and the eval pass over the
    train split, through ``cli.train``; then ``cli.test_model`` on its
    ``_best``."""
    tmp = tmp_path_factory.mktemp("classifier")
    img, labels = _digits()
    classes = [str(i) for i in range(10)]
    root = str(tmp / "data" / "MNIST")
    _save_processed(root, "train", "label", img[:1297], labels[:1297], classes)
    _save_processed(root, "test", "label", img[1297:], labels[1297:], classes)
    argv = ["--data_name", "MNIST", "--model_name", "classifier", "--control_name", "None",
            "--device", "cpu", "--data_dir", str(tmp / "data"), "--output_dir", str(tmp / "out"),
            "--num_epochs", "1"]
    common = dict(limit_train_batches=2, derive_batch_size=False,
                  batch_size={"train": 64, "test": 64})
    (exp,) = cli_train.main(argv, **common)
    (logger,) = cli_test_model.main(argv, **common)
    return exp, logger


def test_experiment_trains_and_reevaluates(trained):
    exp, logger = trained
    hist = exp.logger.history
    assert [len(hist[f"{s}/{m}"]) for s in ("train", "test") for m in ("Loss", "Accuracy")] \
        == [1] * 4
    assert exp.epoch_stats[0]["train_steps"] == 2 and exp.epoch_stats[0]["eval_images"] == 1297
    assert np.isfinite(hist["test/Loss"][0]) and 0 <= hist["test/Accuracy"][0] <= 100
    # the reloaded _best scores as the model that wrote it
    np.testing.assert_allclose(logger.history["test/Accuracy"], hist["test/Accuracy"],
                               rtol=1e-6)
    np.testing.assert_allclose(logger.history["test/Loss"], hist["test/Loss"], rtol=1e-6)
    with open(os.path.join(exp.cfg["output_dir"], "result", f"{exp.tag}.pkl"), "rb") as f:
        assert pickle.load(f)["epoch"] == 2


def test_trained_classifier_is_the_feature_model(trained):
    """Rule 3 of ``evals.features``: with no InceptionV3 weights, the
    dataset's classifier ``_best`` is the feature model."""
    exp, _ = trained
    fn = make_feature_fn(exp.cfg, "cpu")
    ckpt = load_checkpoint(exp.cfg, exp.tag, "best")
    want = classifier_feature_fn(exp.cfg, ckpt["model_dict"], "cpu")
    x = torch.from_numpy(_batches()[0]["img"])
    for a, b in zip(fn(x), want(x)):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.allclose(fn(x)[0], exp.model(x, feature_only=True))


def test_classifier_checkpoint_read_by_jax(trained):
    """The JAX package's ``load_checkpoint`` reads the port's classifier
    checkpoint: the JAX classifier's variable tree and one optimizer and
    scheduler state, as its single-model trainer writes them."""
    exp, _ = trained
    ckpt = jax_load_checkpoint(exp.cfg, exp.tag, "best")
    shapes = jax.eval_shape(lambda: JaxClassifier(SHAPE, (8, 16, 32, 64), 10).init(
        jax.random.PRNGKey(0), jnp.zeros((2, *SHAPE)), train=True))
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), np.dtype(s.dtype)), shapes)
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), ckpt["model_dict"])
    assert got == want
    assert set(ckpt["optimizer_dict"]) >= {"state", "param_groups"}
    assert set(ckpt["scheduler_dict"]) == {"epoch", "lr", "best", "num_bad"}
