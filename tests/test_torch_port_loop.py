"""CPU tests of the PyTorch port's trainer: data, loader, scheduler, logger,
config, checkpoints and the GAN ``Experiment``, against the JAX package
where it has the same function.

No JAX ``Experiment`` and no JAX train step run here (their compiles are
what fills ``tests/test_train.py``'s clock): the JAX side is its loader, its
scheduler, its logger, its config functions, its checkpoint reader and
``jax.eval_shape`` of its MCGAN. The port's own ``Experiment`` runs at tiny
width on ``Synthetic`` (G and D hidden 16, B=8, ``d_iter=2``, 2 steps per
epoch) on the CPU, with a tiny classifier checkpoint as its feature model so
that IS / FID run.

Tolerances: none. Loader batches, schedules, logger means, configs and the
checkpoint's variable tree are equal to the JAX package's exactly; a
resumed run's parameters, optimizer moments and logger history are equal to
an uninterrupted run's bit for bit (the same CPU kernels in the same order,
the batch order a pure function of ``(seed, epoch)``, the z generator's
state in the checkpoint).
"""

import copy
import os
import pickle
import signal
import threading

import numpy as np
import pytest
import torch
import jax

from fixture_utils import randomize_variables
from mcgm_tpu import config as jconfig
from mcgm_tpu.data import datasets as jdatasets
from mcgm_tpu.data.loader import DataLoader as JaxDataLoader
from mcgm_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from mcgm_tpu.models import build_model as jax_build_model
from mcgm_tpu.report.logger import Logger as JaxLogger
from mcgm_tpu.train import loop as jloop
from mcgm_tpu.train.optim import Scheduler as JaxScheduler
from mcgm_tpu_torch import config as pconfig
from mcgm_tpu_torch.cli import train as cli_train
from mcgm_tpu_torch.data import datasets as pdatasets
from mcgm_tpu_torch.data.loader import DataLoader
from mcgm_tpu_torch.io import checkpoint as pcheckpoint
from mcgm_tpu_torch.io.checkpoint import load_checkpoint, to_numpy
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_gan_variables
from mcgm_tpu_torch.models.classifier import Classifier
from mcgm_tpu_torch.models.gan import MCGAN
from mcgm_tpu_torch.report.logger import Logger
from mcgm_tpu_torch.train import loop as ploop
from mcgm_tpu_torch.train.optim import Scheduler
from mcgm_tpu_torch.utils import ckpt_path

GAN = {"latent_size": 16, "generator_hidden_size": [16] * 4,
       "discriminator_hidden_size": [16] * 4, "embedding_size": 8}
CLASSIFIER = {"hidden_size": [4, 8, 8, 8]}
SCHEDULERS = ["None", "StepLR", "MultiStepLR", "ExponentialLR", "CosineAnnealingLR",
              "ReduceLROnPlateau", "CyclicLR"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------------- data
@pytest.fixture(scope="module")
def synthetic():
    return pdatasets.fetch_dataset("Synthetic", verbose=False)


def test_synthetic_equals_jax(synthetic):
    want = jdatasets.fetch_dataset("Synthetic", verbose=False)
    for split in ("train", "test"):
        assert np.array_equal(synthetic[split].img, want[split].img)
        assert np.array_equal(synthetic[split].labels, want[split].labels)
        assert synthetic[split].classes == want[split].classes
    k100 = pdatasets.fetch_dataset("Synthetic100", verbose=False)["train"]
    want100 = jdatasets.fetch_dataset("Synthetic100", verbose=False)["train"]
    assert k100.num_classes == 100 and np.array_equal(k100.img, want100.img)
    assert np.array_equal(k100.labels, want100.labels)


def test_processed_files_cross_read(tmp_path, synthetic):
    """The port writes ``processed/{split}.npz`` the JAX package reads, and
    reads the JAX package's."""
    ds = synthetic["test"]
    pdatasets._save_processed(str(tmp_path / "a"), "train", "label", ds.img, ds.labels, ds.classes)
    got = jdatasets._load_processed(str(tmp_path / "a"), "train", "label", "X")
    assert np.array_equal(got.img, ds.img) and got.classes == ds.classes
    jdatasets._save_processed(str(tmp_path / "b"), "test", "label", ds.img, ds.labels, ds.classes)
    got = pdatasets._load_processed(str(tmp_path / "b"), "test", "label", "X")
    assert np.array_equal(got.labels, ds.labels) and got.num_classes == 10


def test_cifar_packs_from_raw_batches(tmp_path):
    """CIFAR10 python batches on disk become ``processed/*.npz`` (CHW rows
    to HWC); without them the error names the folder."""
    with pytest.raises(FileNotFoundError, match="cifar-10-batches-py"):
        pdatasets.fetch_dataset("CIFAR10", data_dir=str(tmp_path), verbose=False)
    folder = tmp_path / "CIFAR10" / "raw" / "cifar-10-batches-py"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = [f"c{i}" for i in range(10)]
    with open(folder / "batches.meta", "wb") as f:
        pickle.dump({"label_names": names}, f)
    batches = {}
    for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batches[fn] = {"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                       "labels": list(rng.integers(0, 10, 3))}
        with open(folder / fn, "wb") as f:
            pickle.dump(batches[fn], f)
    ds = pdatasets.fetch_dataset("CIFAR10", data_dir=str(tmp_path), verbose=False)
    assert ds["train"].img.shape == (15, 32, 32, 3) and ds["train"].classes == names
    first = batches["data_batch_1"]["data"][1].reshape(3, 32, 32).transpose(1, 2, 0)
    assert np.array_equal(ds["train"].img[1], first)
    assert list(ds["test"].labels) == batches["test_batch"]["labels"]
    want = jdatasets._load_processed(str(tmp_path / "CIFAR10"), "train", "label", "CIFAR10")
    assert np.array_equal(want.img, ds["train"].img)


@pytest.mark.parametrize("kw", [dict(shuffle=True), dict(shuffle=True, drop_last=True),
                                dict(shuffle=False, pad_to_batch=True)])
def test_loader_matches_jax(synthetic, kw):
    """Two epochs of batches: order, normalised images, labels, counts and
    padding masks equal to the JAX loader's."""
    ds = synthetic["train"]
    port = DataLoader(ds, 100, "cpu", seed=3, **kw)
    ref = JaxDataLoader(ds, 100, seed=3, **kw)
    assert len(port) == len(ref)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["n"] == w["n"]
            assert np.array_equal(g["img"].numpy(), np.asarray(w["img"]))
            assert np.array_equal(g["label"].numpy(), np.asarray(w["label"]))
            assert ("w" in g) == ("w" in w)
            if "w" in g:
                assert np.array_equal(g["w"].numpy(), np.asarray(w["w"]))
    port.set_epoch(2)
    assert all(np.array_equal(a["img"].numpy(), b["img"].numpy())
               for a, b in zip(port.iter_from(3), got[3:]))


# ------------------------------------------------ scheduler, logger, config
@pytest.mark.parametrize("name", SCHEDULERS)
def test_scheduler_matches_jax(name):
    cfg = {"scheduler_name": name, "lr": 0.1, "step_size": 3, "milestones": [2, 5],
           "factor": 0.5, "patience": 1, "threshold": 1e-3, "min_lr": 1e-3, "num_epochs": 10}
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9]
    port, ref = Scheduler(cfg, 0.2), JaxScheduler(cfg, 0.2)
    for m in metrics:
        assert port.step(m) == ref.step(m)
        assert port.state_dict() == ref.state_dict()
    again = Scheduler(cfg, 0.2)
    again.load_state_dict(port.state_dict())
    assert again.step(0.1) == ref.step(0.1)


def test_logger_matches_jax(tmp_path):
    port, ref = Logger(str(tmp_path / "p")), JaxLogger(str(tmp_path / "j"))
    rng = np.random.default_rng(0)
    for epoch in range(3):
        for lg in (port, ref):
            lg.safe(True)
        for _ in range(4):
            vals, n = {"Loss": float(rng.normal()), "Loss_D": float(rng.normal())}, int(rng.integers(1, 9))
            for lg in (port, ref):
                lg.append(vals, "train", n)
                lg.append({"info": ["x"]}, "train", mean=False)
        for lg in (port, ref):
            lg.write("train", ["Loss", "Loss_D"])
            lg.safe(False)
            assert dict(lg.mean) == dict(ref.mean)
            if epoch < 2:
                lg.reset()
    assert dict(port.history) == dict(ref.history)
    lines = (tmp_path / "p" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 6
    back = pickle.loads(pickle.dumps(port))
    assert back._fh is None and dict(back.history) == dict(port.history)


@pytest.mark.parametrize("model_name", ["mcgan", "cgan"])
@pytest.mark.parametrize("data_name", ["CIFAR10", "Synthetic"])
def test_config_matches_jax(model_name, data_name):
    """From the same input: ``apply_control_name``, ``process_control``,
    ``apply_family_overrides`` and ``make_model_tag`` equal the JAX
    package's. The JAX overrides' ``steps_per_dispatch`` (its multi-step
    dispatch groups, which the port has not) is the one key left out."""
    base = dict(jconfig.load_config(), data_name=data_name, model_name=model_name)
    for control in ("0.5", "None"):
        p = pconfig.apply_control_name(base, control)
        j = jconfig.apply_control_name(base, control)
        assert p == j
        p = ploop.apply_family_overrides(pconfig.process_control(p))
        j = jloop.apply_family_overrides(jconfig.process_control(j))
        assert j.pop("steps_per_dispatch") == 1
        p.pop("steps_per_dispatch")  # the JAX default's key, passed through untouched
        assert p == j
        assert pconfig.make_model_tag(p, 3) == jconfig.make_model_tag(j, 3)
    # the port's defaults: the JAX package's, less its TPU keys, on the card,
    # with the one model it trains as the default model
    port, ref = pconfig.load_config(), jconfig.load_config()
    assert {k: v for k, v in port.items() if port[k] != ref.get(k)} == {
        "device": "cuda", "model_name": "mcgan"}


# ------------------------------------------------------------- experiment
def _write_classifier(out_dir: str) -> None:
    """A tiny seeded classifier as ``0_Synthetic_label_classifier_best``:
    the feature model IS / FID use for a dataset without inception weights."""
    model = Classifier((32, 32, 3), CLASSIFIER["hidden_size"], 10, seed=1)
    path = ckpt_path({"output_dir": out_dir}, "0_Synthetic_label_classifier", "best")
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as f:
        pickle.dump({"model_dict": to_jax_gan_variables(model)}, f)


def _cfg(out_dir: str, **kw) -> dict:
    cfg = dict(pconfig.load_config(), data_name="Synthetic", model_name="mcgan",
               device="cpu", output_dir=out_dir, derive_model_params=False, gan=GAN,
               classifier=CLASSIFIER, derive_batch_size=False,
               batch_size={"train": 8, "test": 40}, limit_train_batches=2, d_iter=2,
               log_interval=1.0)
    cfg.update(kw)
    return cfg


class _IS:
    """Stands in for ``inception_score``: the given values, one per eval,
    so that ``_best`` sees an epoch that does not improve."""

    def __init__(self, values):
        self.values = list(values)

    def __call__(self, probs, splits=1):
        assert probs.shape == (80, 10) and np.allclose(probs.sum(1), 1, atol=1e-5)
        return self.values.pop(0)


def _run(monkeypatch, cfg, num_epochs, is_values, crash_at=None, term_at=None):
    """One ``Experiment.run``; returns it and its ``(epoch, copy_to_best)``
    checkpoints. ``crash_at``: the train step raises on that call;
    ``term_at``: the process sends itself SIGTERM just before that call
    (once the run's own handler is in place)."""
    monkeypatch.setattr(ploop, "inception_score", _IS(is_values))
    exp = ploop.Experiment(cfg)
    calls, ckpts = [0], []
    real_ckpt = exp._checkpoint

    def spy(epoch, copy_to_best=False, mid_step=None):
        ckpts.append((epoch, copy_to_best, mid_step))
        real_ckpt(epoch, copy_to_best, mid_step)

    exp._checkpoint = spy
    setup = exp.setup

    def setup_then_wrap():
        setup()
        step = exp.train_step

        def counted(ts, batch):
            calls[0] += 1
            if calls[0] == crash_at:
                raise KeyboardInterrupt("stopped")
            if calls[0] == term_at:
                handler = signal.getsignal(signal.SIGTERM)
                assert getattr(handler, "__name__", "") == "on_term", handler  # never the default
                os.kill(os.getpid(), signal.SIGTERM)
            return step(ts, batch)

        exp.train_step = counted

    exp.setup = setup_then_wrap
    if crash_at:
        with pytest.raises(KeyboardInterrupt):
            exp.run(num_epochs)
    else:
        exp.run(num_epochs)
    return exp, ckpts


def _state(exp):
    return ({k: t.clone() for k, t in exp.model.state_dict().items()},
            [copy.deepcopy(o.state_dict()) for o in (exp.ts.g_opt, exp.ts.d_opt)])


def _assert_same_state(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for oa, ob in zip(a[1], b[1]):
        assert oa["chain_count"] == ob["chain_count"]
        for i, sa in oa["state"].items():
            for name, t in sa.items():
                assert torch.equal(t, ob["state"][i][name]), (i, name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted 3-epoch run; the same stopped after 2 epochs and
    resumed (mode 1) to 3; the same stopped inside epoch 3 after a
    mid-epoch checkpoint and resumed; the same stopped by SIGTERM, with and
    without step checkpoints, and resumed."""
    mp = pytest.MonkeyPatch()
    try:
        dirs = {k: str(tmp_path_factory.mktemp(k))
                for k in ("full", "split", "mid", "term_step", "term_epoch")}
        for d in dirs.values():
            _write_classifier(d)
        out = {}
        out["full"] = _run(mp, _cfg(dirs["full"]), 3, [2.0, 1.0, 3.0])
        first = _run(mp, _cfg(dirs["split"]), 2, [2.0, 1.0])
        out["split_first"] = first
        out["split_state_at_2"] = _state(first[0])
        out["split_payload_at_2"] = to_numpy(first[0].state_dict())
        out["history_at_2"] = dict(first[0].logger.history)
        split_cfg = _cfg(dirs["split"])
        out["ckpt_at_2"] = load_checkpoint(split_cfg, first[0].tag, "checkpoint")
        out["best_at_2"] = load_checkpoint(split_cfg, first[0].tag, "best")["epoch"]
        out["split"] = _run(mp, _cfg(dirs["split"], resume_mode=1), 3, [3.0])
        # epoch 3's second step raises; the checkpoint after its first step holds
        out["mid_first"] = _run(mp, _cfg(dirs["mid"], save_every_steps=1), 3, [2.0, 1.0],
                                crash_at=6)
        out["mid"] = _run(mp, _cfg(dirs["mid"], resume_mode=1, save_every_steps=1), 3, [3.0])
        # SIGTERM in epoch 3's first step, with step checkpoints: it stops there
        out["term_step_first"] = _run(mp, _cfg(dirs["term_step"], save_every_steps=1), 3,
                                      [2.0, 1.0], term_at=5)
        out["term_step"] = _run(mp, _cfg(dirs["term_step"], resume_mode=1, save_every_steps=1),
                                3, [3.0])
        # SIGTERM in epoch 2's first step, without: it stops after epoch 2
        out["term_epoch_first"] = _run(mp, _cfg(dirs["term_epoch"]), 3, [2.0, 1.0], term_at=3)
        out["term_epoch"] = _run(mp, _cfg(dirs["term_epoch"], resume_mode=1), 3, [3.0])
        out["dirs"] = dirs
        yield out
    finally:
        mp.undo()


def test_experiment_trains_and_scores(runs):
    exp, ckpts = runs["full"]
    hist = exp.logger.history
    assert hist["test/InceptionScore"] == [2.0, 1.0, 3.0]
    assert len(hist["test/FID"]) == 3 and all(np.isfinite(hist["test/FID"]))
    assert len(hist["train/Loss_D"]) == 3 and all(np.isfinite(hist["train/Loss"]))
    assert [s["train_steps"] for s in exp.epoch_stats] == [2, 2, 2]
    assert all(s["eval_images"] == 80 for s in exp.epoch_stats)
    assert all(s["checkpoint"]["snapshot_s"] >= 0 and s["checkpoint"]["write_s"] >= 0
               and s["checkpoint"]["join_s"] >= 0 for s in exp.epoch_stats)
    assert all(s["host_enqueue"]["items_per_s"] > 0 for s in exp.epoch_stats)
    assert exp.loaders["train"].staged()[0].dtype == torch.uint8


def test_best_copied_only_on_improvement(runs):
    for name in ("full", "split"):
        assert [(e, b) for e, b, _ in runs[name][1]] in ([(1, True), (2, False), (3, True)],
                                                         [(3, True)])
    assert [(e, b) for e, b, _ in runs["split_first"][1]] == [(1, True), (2, False)]
    cfg = _cfg(runs["dirs"]["full"])
    tag = runs["full"][0].tag
    assert load_checkpoint(cfg, tag, "best")["epoch"] == 4
    assert load_checkpoint(cfg, tag, "checkpoint")["epoch"] == 4
    assert runs["best_at_2"] == 2  # epoch 1's: epoch 2 did not improve
    assert load_checkpoint(_cfg(runs["dirs"]["split"]), tag, "best")["epoch"] == 4


def test_resume_equals_uninterrupted(runs):
    """Mode 1 from the epoch-2 checkpoint, and from the checkpoint inside
    epoch 3: parameters, buffers, optimizer moments and logger history equal
    an uninterrupted run's bit for bit."""
    full = runs["full"][0]
    for name in ("split", "mid"):
        exp = runs[name][0]
        _assert_same_state(_state(full), _state(exp))
        assert dict(exp.logger.history) == dict(full.logger.history), name
    assert [s["epoch"] for s in runs["split"][0].epoch_stats] == [3]
    mid_ckpts = [c for c in runs["mid_first"][1] if c[2]]
    assert mid_ckpts[-1] == (3, False, 1)
    assert runs["mid"][0].epoch_stats[0]["train_steps"] == 1


def _assert_same_tree(a, b, path="") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, Logger):
        assert dict(a.history) == dict(b.history), path
    else:
        assert a == b, path


def test_resume_records_what_it_loaded(runs):
    """Mode 1 records its epoch and the state it loaded, in the layout of
    ``Experiment.state_dict``: equal to the state the first run ended with."""
    rec = runs["split"][0].resumed
    assert rec["epoch"] == 3 and rec["mid_epoch_step"] == 0
    _assert_same_tree(runs["split_payload_at_2"], rec["state"])
    assert runs["mid"][0].resumed["epoch"] == 3
    assert runs["mid"][0].resumed["mid_epoch_step"] == 1
    assert runs["full"][0].resumed is None


def test_async_checkpoint_snapshot_is_a_copy(tmp_path, monkeypatch):
    """The file holds the state as it was at ``submit``: CPU tensors updated
    in place while the writer thread waits (parameters, Adam's moments and
    its step count) do not reach it."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.Adam([p], lr=0.1)
    p.grad = torch.full((4,), 0.5)
    opt.step()
    want_p, want_opt = p.detach().clone(), copy.deepcopy(opt.state_dict())
    release = threading.Event()
    real_save = pcheckpoint.save_checkpoint

    def blocked(*args, **kwargs):
        assert release.wait(30)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(pcheckpoint, "save_checkpoint", blocked)
    cfg = {"output_dir": str(tmp_path)}
    writer = pcheckpoint.AsyncCheckpointer()
    rec = writer.submit(cfg, "t", {"model_dict": {"w": p},
                                   "optimizer_dict": opt.state_dict()})
    p.grad.mul_(-3)
    opt.step()
    release.set()
    writer.wait()
    assert rec["write_s"] >= 0 and rec["join_s"] >= 0
    got = load_checkpoint(cfg, "t")
    assert np.array_equal(got["model_dict"]["w"], want_p.numpy())
    assert not np.array_equal(got["model_dict"]["w"], p.detach().numpy())
    st = got["optimizer_dict"]["state"][0]
    assert set(st) == set(want_opt["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}
    for name, t in want_opt["state"][0].items():
        assert np.array_equal(st[name], t.numpy()), name


def test_resume_loads_what_was_saved(runs, tmp_path):
    """The epoch-2 checkpoint holds the state the run had then, and mode 1
    loads it back: parameters and buffers, optimizer moments and counts,
    schedulers, the z generator, the logger history and the pivot."""
    ckpt = runs["ckpt_at_2"]
    assert ckpt["epoch"] == 3 and "mid_epoch_step" not in ckpt
    cfg = _cfg(str(tmp_path), resume_mode=1)
    exp = ploop.Experiment(cfg)
    path = ckpt_path(cfg, exp.tag, "checkpoint")
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as f:
        pickle.dump(ckpt, f)
    exp.setup()
    assert exp._resume() == (3, 2.0)
    _assert_same_state(runs["split_state_at_2"], _state(exp))
    assert dict(exp.logger.history) == runs["history_at_2"]
    assert not exp.logger.mean
    for k in ("generator", "discriminator"):
        assert exp.scheduler[k].state_dict() == ckpt["scheduler_dict"][k]
    assert torch.equal(exp.ts.rng.get_state(), torch.from_numpy(ckpt["torch_rng"]))


def test_port_checkpoint_read_by_jax(runs):
    """The JAX package's own reader takes the port's checkpoint, and its
    ``model_dict`` has the JAX MCGAN's variable tree and shapes."""
    cfg = _cfg(runs["dirs"]["full"])
    exp = runs["full"][0]
    ckpt = jax_load_checkpoint(cfg, exp.tag, "best")
    jcfg = dict(exp.cfg)
    img = np.zeros((2, 32, 32, 3), np.float32)
    lab = np.zeros(2, np.int32)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(1)},
        {"img": img, "label": lab}, train=True))
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), np.dtype(s.dtype)), shapes)
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), ckpt["model_dict"])
    assert got == want
    assert set(ckpt) >= {"cfg", "epoch", "model_dict", "optimizer_dict", "scheduler_dict",
                         "logger"}


def test_to_jax_gan_variables_round_trip():
    model = MCGAN(**dict(data_shape=(32, 32, 3), latent_size=16,
                         generator_hidden_size=(16,) * 4,
                         discriminator_hidden_size=(16,) * 4, num_mode=4), seed=3)
    v = to_jax_gan_variables(model)
    back = from_jax_variables(v)
    sd = model.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    filled = randomize_variables(v, 0)
    other = MCGAN(**dict(data_shape=(32, 32, 3), latent_size=16,
                         generator_hidden_size=(16,) * 4,
                         discriminator_hidden_size=(16,) * 4, num_mode=4), seed=4)
    other.load_state_dict(from_jax_variables(filled))
    again = to_jax_gan_variables(other)
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(filled)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(again),
                                                    jax.tree_util.tree_leaves(filled)))


def test_warm_start_mode_2(runs):
    """Mode 2 takes the weights, and neither the optimizers, the epoch nor
    the logger."""
    cfg = _cfg(runs["dirs"]["full"], resume_mode=2)
    exp = ploop.Experiment(cfg)
    exp.setup()
    assert exp._resume() == (1, None)
    assert not exp.logger.history and exp.ts.g_opt.state_dict()["state"] == {}
    _assert_same_state((_state(runs["full"][0])[0], []), (_state(exp)[0], []))


def test_mid_epoch_resume_refuses_another_batch_size(runs):
    cfg = _cfg(runs["dirs"]["mid"], resume_mode=1)
    exp = ploop.Experiment(cfg)
    exp.setup()
    ckpt = load_checkpoint(cfg, exp.tag, "checkpoint")
    ckpt["mid_epoch_step"], ckpt["epoch"] = 1, 3
    with open(ckpt_path(cfg, exp.tag, "checkpoint"), "wb") as f:
        pickle.dump(ckpt, f)
    exp.cfg["batch_size"] = {"train": 4, "test": 40}
    with pytest.raises(ValueError, match="batch_size changed"):
        exp._resume()


def test_sigterm_stops_at_a_checkpoint_and_resumes_bit_equal(runs):
    """SIGTERM stops the run at the step checkpoint it writes at once (with
    ``save_every_steps``) or after the epoch's checkpoint (without), puts
    the previous handler back, and ``resume_mode=1`` ends where the
    uninterrupted run ends, bit for bit."""
    exp, ckpts = runs["term_step_first"]
    assert ckpts[-1] == (3, False, 1)
    assert [s["train_steps"] for s in exp.epoch_stats] == [2, 2, 1]
    assert exp.logger.history["test/InceptionScore"] == [2.0, 1.0]
    exp, ckpts = runs["term_epoch_first"]
    assert ckpts == [(1, True, None), (2, False, None)]
    assert [s["train_steps"] for s in exp.epoch_stats] == [2, 2]
    assert runs["term_epoch"][0].resumed["epoch"] == 3
    assert runs["term_step"][0].resumed["mid_epoch_step"] == 1
    full = runs["full"][0]
    for name in ("term_step", "term_epoch"):
        _assert_same_state(_state(full), _state(runs[name][0]))
        assert dict(runs[name][0].logger.history) == dict(full.logger.history), name
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_trainer_takes_fuse_g_pass_and_remat(runs, tmp_path, monkeypatch):
    """``cli.train`` with the GAN step's ``fuse_g_pass`` and ``remat``: the
    first epoch equals the plain run's (the same math; ``rtol=1e-5``)."""
    _write_classifier(str(tmp_path))
    monkeypatch.setattr(ploop, "inception_score", _IS([2.0]))
    cfg = _cfg(str(tmp_path), fuse_g_pass=True, remat=True)
    argv = ["--data_name", "Synthetic", "--device", "cpu", "--output_dir", str(tmp_path)]
    (exp,) = cli_train.main(argv + ["--num_epochs", "1"],
                            **{k: v for k, v in cfg.items() if k not in ("data_name", "device",
                                                                         "output_dir")})
    assert exp.cfg["fuse_g_pass"] and exp.cfg["remat"]
    full = runs["full"][0].logger.history
    for key in ("train/Loss_D", "train/Loss_G", "test/FID"):
        np.testing.assert_allclose(exp.logger.history[key][0], full[key][0], rtol=1e-5,
                                   err_msg=key)


SINGLE = {
    "mcvae": {"vae": {"hidden_size": [8, 16], "latent_size": 8, "num_res_block": 1}},
    "vqvae": {"vqvae": {"hidden_size": [8, 8], "num_res_block": 1, "embedding_size": 8,
                        "num_embedding": 16, "vq_commit": 0.25}},
    "mcpixelcnn": {"pixelcnn": {"num_layer": 3, "hidden_size": 8, "num_embedding": 16}},
    "classifier": {"classifier": {"hidden_size": [4, 8, 8, 8]}},
}


@pytest.mark.parametrize("name", list(SINGLE))
def test_remat_step_equals_the_plain_step(name, monkeypatch):
    """The generic step with ``remat`` against without, two steps from one
    state: losses, parameters and every buffer equal, the VAE's noise
    generator left in the same state, the forward run twice a step (the
    recompute) and the VQ EMA moved once a step (one ``vq_ema`` call, which
    writes the buffers behind their version counters, as the kernel does)."""
    from mcgm_tpu_torch.models import build_model
    from mcgm_tpu_torch.ops import vq as pvq
    from mcgm_tpu_torch.train import optim as popt
    from mcgm_tpu_torch.train import state as pstate

    cfg = dict(pconfig.process_control(dict(pconfig.load_config(), data_name="CIFAR10",
                                            model_name=name, derive_model_params=False,
                                            **SINGLE[name])), classes_size=4)
    ema = [0]
    real_ema = pvq.vq_ema

    def counted_ema(flat, code, w, *buffers):
        # as the kernel does: the buffers written where no version counter sees it
        ema[0] += 1
        return real_ema(flat, code, w, *(b.data if torch.is_tensor(b) else b for b in buffers))

    monkeypatch.setattr(pvq, "vq_ema", counted_ema)
    g = torch.Generator().manual_seed(1)
    img = (torch.randint(0, 16, (4, 8, 8), generator=g) if "pixelcnn" in name
           else torch.rand((4, 32, 32, 3), generator=g) * 2 - 1)
    batch = {"img": img, "label": torch.arange(4) % 4}
    res = []
    for remat in (False, True):
        model = build_model(cfg, "cpu")
        rng = torch.Generator().manual_seed(0) if name == "mcvae" else None
        ts = pstate.TrainState(model, popt.make_optimizer(
            model.parameters(), {"optimizer_name": "Adam", "lr": 1e-3}, grad_clip=1.0), rng=rng)
        calls = [0]
        first = next(m for m in model.modules() if len(list(m.parameters(recurse=False))))
        first.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
        ema[0] = 0
        step = pstate.make_train_step(remat=remat)
        losses = [step(ts, batch)["loss"] for _ in range(2)]
        res.append((losses, model.state_dict(), rng, calls[0], ema[0]))
    (la, sa, ra, ca, ea), (lb, sb, rb, cb, eb) = res
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert ra is None or torch.equal(ra.get_state(), rb.get_state())
    assert (ca, cb) == (2, 4)
    assert (ea, eb) == ((2, 2) if name == "vqvae" else (0, 0))


def test_entry_points_need_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ploop.Experiment(_cfg(str(tmp_path), device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--data_name", "Synthetic", "--output_dir", str(tmp_path)],
                       derive_model_params=False, gan=GAN)
