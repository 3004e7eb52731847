"""CPU parity of the PyTorch port's offline scoring and reports against the
JAX package: ``cli.make_stats``, ``cli.test_generated`` (generated and
created), ``data.stats``, ``report.process`` (``process``, ``make_vis``),
``report.learning_curve`` and ``report.summary``.

One tiny MNIST-shaped processed set (300 + 100 images, 10 classes) and one
narrow classifier ``_best`` in the JAX layout (the port's classifier exported with
``to_jax_classifier``) serve both packages, which read the same files; the
dumps (``generated_`` 200 images, ``created_`` the 10 x 1,000 class sweep)
hold NaN rows. Everything comes from ``np.random.default_rng``. No JAX
generative model is compiled: the JAX classifier's forward is, and the
variable trees for the parameter tables come from ``jax.eval_shape``.

Tolerances, and why:

- IS (10 splits): the same float64 formula over f32 class probabilities
  from two libraries' convolutions: ``rtol=1e-4``;
- FID: ``rtol=1e-4`` against the JAX scorer run under ``jax.enable_x64``
  (its eigendecompositions in float64, as the port's; 1e-7 to 2e-7 apart
  here). As it runs by default, it takes them in f32, and its FID here lies
  1.0e-4 to 1.1e-4 below: ``rtol=1e-3`` against it. The raw split's FID is
  0 up to rounding: within ``1e-4`` of ``tr(S_real) + tr(S_dump)`` of 0 and
  of the float64 JAX value (the f32 one is -1.73 there, on terms of 5,933);
- DBI: float64 numpy on both sides: ``rtol=1e-9``;
- ``make_stats``: ``mu`` / ``sigma`` within ``1e-5 * max``: the JAX package
  keeps ``mu`` in f32 and sums the covariance in another order; the ``dump``
  bit-equal;
- ``processed_result.json``, ``vis.sh``'s cells and seeds, the curves, the
  parameter tables: equal.
"""

import ast
import json
import os
import pathlib
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcgm_tpu.cli import make_stats as jmake_stats
from mcgm_tpu.cli import test_generated as jtest_generated
from mcgm_tpu.config import load_config as jload_config
from mcgm_tpu.config import process_control as jprocess_control
from mcgm_tpu.data import stats as jstats
from mcgm_tpu.data.datasets import fetch_dataset as jfetch
from mcgm_tpu.models import build_model as jbuild_model
from mcgm_tpu.report import learning_curve as jcurve
from mcgm_tpu.report import process as jprocess
from mcgm_tpu.report import summary as jsummary
from mcgm_tpu.report.logger import Logger as JLogger
from mcgm_tpu.train.loop import RNG_STREAMS, FAMILY
from mcgm_tpu.train.loop import apply_family_overrides as japply
from mcgm_tpu_torch.cli import make_stats as pmake_stats
from mcgm_tpu_torch.cli import summary as psummary_cli
from mcgm_tpu_torch.cli import test_generated as ptest_generated
from mcgm_tpu_torch.data import stats as pstats
from mcgm_tpu_torch.data.datasets import _save_processed
from mcgm_tpu_torch.data.datasets import fetch_dataset as pfetch
from mcgm_tpu_torch.io.checkpoint import save_checkpoint
from mcgm_tpu_torch.io.jax_import import to_jax_classifier
from mcgm_tpu_torch.models.classifier import Classifier
from mcgm_tpu_torch.report import learning_curve as pcurve
from mcgm_tpu_torch.report import process as pprocess
from mcgm_tpu_torch.report import summary as psummary
from mcgm_tpu_torch.report.logger import Logger as PLogger
from mcgm_tpu_torch.utils import save

TAG = "0_MNIST_label_mcgan_0.5"
ARGS = ["--data_name", "MNIST", "--model_name", "mcgan", "--control_name", "0.5"]
# a narrow classifier (8 channels a stage: 128 features), so that the
# scorers' float64 eigendecompositions stay small beside other workers
CLS = dict(derive_model_params=False, classifier={"hidden_size": [8, 8, 8, 8]})
N_TRAIN = 300  # more real images than feature dimensions
PORT_ROOT = pathlib.Path(__file__).resolve().parent.parent / "mcgm_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    """``data/MNIST/processed`` (64 train, 32 test, 10 classes), the
    classifier ``_best`` (JAX layout) and the two dumps, under one root."""
    root = tmp_path_factory.mktemp("scoring")
    rng = np.random.default_rng(0)
    labels = np.arange(N_TRAIN + 100) % 10
    img = np.clip(rng.normal(40 + 18 * labels[:, None, None, None], 40, (len(labels), 32, 32, 1)),
                  0, 255).astype(np.uint8)
    classes = [str(i) for i in range(10)]
    for split, sl in (("train", slice(0, N_TRAIN)), ("test", slice(N_TRAIN, None))):
        _save_processed(str(root / "data" / "MNIST"), split, "label", img[sl], labels[sl],
                        classes)
    model = Classifier((32, 32, 1), (8, 8, 8, 8), 10, seed=3)
    with torch.no_grad():
        for name, b in model.named_buffers():  # running statistics away from their init
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.normal(0, 0.1, b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, b.shape)))
        # features x100, so that FID's eigenvalue floor (1e-10) lies far below
        # its terms; logits centred on the train split and spread, so that the
        # class probabilities differ from image to image
        model.BatchNorm_3.weight.mul_(100.0)
        model.BatchNorm_3.bias.mul_(100.0)
        f = model(torch.from_numpy(img[:N_TRAIN]).float() / 127.5 - 1, feature_only=True)
        logits = model.classifier(f - f.mean(0))
        model.classifier.weight.mul_(3.0 / logits.std())
        model.classifier.bias.copy_(-model.classifier.weight @ f.mean(0))
    out = root / "output"
    save_checkpoint({"output_dir": str(out)}, "0_MNIST_label_classifier",
                    {"cfg": {}, "epoch": 1, "model_dict": to_jax_classifier(model)}, "best")
    gen = rng.uniform(0, 255, (200, 1, 32, 32)).astype(np.float32)
    gen[[3, 50, 199], 0, 5, 7] = np.nan
    centre = 30.0 + 20 * (np.arange(10_000) % 10)  # the sweep's class of each row
    created = np.clip(rng.normal(centre[:, None, None, None], 60, (10_000, 1, 32, 32)), 0,
                      255).astype(np.float32)
    created[[0, 17, 9_999]] = np.nan
    os.makedirs(out / "npy")
    np.save(out / "npy" / f"generated_{TAG}.npy", gen)
    np.save(out / "npy" / f"created_{TAG}.npy", created)
    return root


@pytest.fixture(scope="module")
def fid_stats(digits, tmp_path_factory):
    """The port's ``make_stats`` file of the train split, made once, and the
    scale of FID's terms, ``tr(S_real) + tr(S_dump)`` with the dump the
    train split itself (``--raw``)."""
    out = tmp_path_factory.mktemp("fid_stats")
    shutil.copytree(digits / "output", out, dirs_exist_ok=True)
    path = pmake_stats.main("stats", ARGS + ["--data_dir", str(digits / "data"), "--output_dir",
                                             str(out), "--device", "cpu"], **CLS)
    with np.load(path) as z:
        return path, 2 * np.trace(z["sigma"])


def _copy_out(digits, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(digits / "output", dst)
    return dst


def _result(out, name):
    return float(np.load(out / "result" / f"{name}_{TAG}.npy"))


@pytest.mark.parametrize("route", ["fresh", "stats", "raw"])
def test_generated_matches_jax(digits, fid_stats, tmp_path, route):
    """IS (10 splits) and FID of the dump (NaN rows dropped) against the JAX
    ``score_generated``, as it runs (FID's eigendecompositions in f32) and
    under ``jax.enable_x64`` (in float64, as the port's): the real side
    swept afresh, read from the ``make_stats`` file, or the train split
    itself scored (``--raw``, whose FID is 0 up to rounding: held within its
    terms' scale, ``tr(S_real) + tr(S_dump)``, times the tolerance)."""
    outs = {pkg: _copy_out(digits, tmp_path, pkg) for pkg in ("jax", "jax64", "port")}
    data = ["--data_dir", str(digits / "data")]
    path, fid_scale = fid_stats
    if route == "stats":
        for out in outs.values():
            os.makedirs(out / "fid_stats")
            shutil.copy(path, out / "fid_stats")
    extra = ["--raw", "true"] if route == "raw" else []
    jtest_generated.main("generated", ARGS + data + extra + ["--output_dir", str(outs["jax"])],
                         **CLS)
    with jax.enable_x64(True):
        jtest_generated.main("generated", ARGS + data + extra + [
            "--output_dir", str(outs["jax64"])], **CLS)
    (got,) = ptest_generated.main("generated", ARGS + data + extra + [
        "--output_dir", str(outs["port"]), "--device", "cpu"], **CLS)
    assert got["images"] == (N_TRAIN if route == "raw" else 197)
    assert got["InceptionScore"] > 1.2  # the probabilities differ from image to image
    for key, name in (("InceptionScore", "is_generated"), ("FID", "fid_generated")):
        assert _result(outs["port"], name) == got[key] and np.isfinite(got[key])
        print(f"{route} {key}: port {got[key]!r}, JAX f32 {_result(outs['jax'], name)!r}, "
              f"JAX x64 {_result(outs['jax64'], name)!r}, FID's terms {fid_scale!r}")
        if route == "raw" and key == "FID":
            # the f32 FID of the JAX scorer is its eigendecompositions' noise
            # here (-1.73 of 5,933): held to the float64 one only
            assert abs(got[key]) <= 1e-4 * fid_scale
            assert abs(got[key] - _result(outs["jax64"], name)) <= 1e-4 * fid_scale
            continue
        # the JAX scorer's f32 FID sits 1.0e-4 to 1.1e-4 below the float64 one here
        for pkg, rtol in (("jax64", 1e-4), ("jax", 1e-4 if key == "InceptionScore" else 1e-3)):
            np.testing.assert_allclose(got[key], _result(outs[pkg], name), rtol=rtol, atol=0,
                                       err_msg=pkg)


def test_created_matches_jax(digits, tmp_path):
    """DBI of the class sweep's dump, NaN rows masked, against the JAX
    ``score_created``."""
    outs = {pkg: _copy_out(digits, tmp_path, pkg) for pkg in ("jax", "port")}
    data = ["--data_dir", str(digits / "data")]
    jtest_generated.main("created", ARGS + data + ["--output_dir", str(outs["jax"])], **CLS)
    (got,) = ptest_generated.main("created", ARGS + data + ["--output_dir", str(outs["port"])],
                                  **CLS)
    assert got["images"] == 9_997 and _result(outs["port"], "dbi_created") == got["DBI"]
    np.testing.assert_allclose(got["DBI"], _result(outs["jax"], "dbi_created"), rtol=1e-9,
                               atol=0)


def test_make_stats_matches_jax(digits, fid_stats, tmp_path):
    """``dump`` bit-equal to the JAX package's; the FID stats file's
    ``mu`` / ``sigma`` within ``1e-5 * max``."""
    outs = {pkg: _copy_out(digits, tmp_path, pkg) for pkg in ("jax", "port")}
    data = ["--data_dir", str(digits / "data")]
    jmake_stats.main("dump", ARGS + data + ["--output_dir", str(outs["jax"])])
    jmake_stats.main("stats", ARGS + data + ["--output_dir", str(outs["jax"])], **CLS)
    dump = pmake_stats.main("dump", ARGS + data + ["--output_dir", str(outs["port"])])
    stats = fid_stats[0]
    want = np.load(outs["jax"] / "npy" / "generated_0_MNIST.npy")
    got = np.load(dump)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (N_TRAIN, 1, 32, 32)
    want = np.load(outs["jax"] / "fid_stats" / "fid_stats_MNIST_train.npz")
    with np.load(stats) as got:
        for k in ("mu", "sigma"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-5 * np.abs(want[k]).max())


def test_channel_stats_match_jax(digits, tmp_path):
    """``data.stats``'s Welford merge (float64, chunks of 24) against the JAX
    package's; each package reads the other's cache."""
    pds = pfetch("MNIST", data_dir=str(digits / "data"), verbose=False)["train"]
    jds = jfetch("MNIST", data_dir=str(digits / "data"), verbose=False)["train"]
    got = pstats.make_stats(pds, str(tmp_path / "p"), chunk=24)
    want = jstats.make_stats(jds, str(tmp_path / "j"), chunk=24)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-12)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-12)
    assert got.count == want.count == N_TRAIN * 32 * 32
    back = pstats.make_stats(pds, str(tmp_path / "j"))  # the JAX package's cache
    assert isinstance(back, pstats.Stats) and np.array_equal(back.m2, want.m2)
    assert np.array_equal(jstats.make_stats(jds, str(tmp_path / "p")).mean, got.mean)


def _jax_logger(history):
    lg = JLogger(None)
    for name, values in history.items():
        lg.history[name] = list(values)
    return lg


def _port_logger(history):
    lg = PLogger(None)
    for name, values in history.items():
        lg.history[name] = list(values)
    return lg


def _write_results(out):
    """Three cells: MCGAN on two seeds (one from each package's
    ``cli.test_model``) with scores, CGAN whose seed 1 diverged, and a VAE
    cell whose every seed diverged."""
    rdir = out / "result"
    os.makedirs(rdir)
    runs = [("0", "MNIST_label_mcgan_0.5", _jax_logger, {"test/Loss": [2.0, 1.5],
                                                         "test/info": ["x"]}),
            ("1", "MNIST_label_mcgan_0.5", _port_logger, {"test/Loss": [1.0, 1.25]}),
            ("0", "MNIST_label_cgan", _port_logger, {"test/Loss": [0.5]}),
            ("1", "MNIST_label_cgan", _jax_logger, {"test/Loss": [np.nan]}),
            ("0", "MNIST_label_mcvae_0.5", _jax_logger, {"test/BCE": [np.inf]})]
    for seed, cell, make, hist in runs:
        with open(rdir / f"{seed}_{cell}.pkl", "wb") as f:
            pickle.dump({"cfg": {}, "epoch": 2, "logger": make(hist)}, f)
    scores = {("0", "MNIST_label_mcgan_0.5"): (3.5, 40.0, 2.5),
              ("1", "MNIST_label_mcgan_0.5"): (4.25, 52.0, 2.0),
              ("0", "MNIST_label_cgan"): (5.0, 30.0, 1.75),
              ("1", "MNIST_label_cgan"): (np.nan, np.nan, 1.5)}
    for (seed, cell), (is_, fid, dbi) in scores.items():
        for name, v in (("is_generated", is_), ("fid_generated", fid), ("dbi_created", dbi)):
            save(np.float64(v), str(rdir / f"{name}_{seed}_{cell}.npy"), mode="numpy")
    (rdir / "notes.txt").write_text("ignored")


def test_process_matches_jax(tmp_path):
    """``processed_result.json`` byte-equal to the JAX package's, from result
    pickles of both packages, diverged seeds listed and not averaged."""
    for pkg in ("jax", "port"):
        _write_results(tmp_path / pkg)
    want = jprocess.process(str(tmp_path / "jax"))
    got = pprocess.process(str(tmp_path / "port"))
    assert got == want
    assert (tmp_path / "port" / "processed_result.json").read_text() == \
        (tmp_path / "jax" / "processed_result.json").read_text()
    cgan = got["MNIST_label_cgan"]["generated/InceptionScore"]
    assert cgan["n_diverged"] == 1 and cgan["diverged_seeds"] == ["1"] and cgan["mean"] == 5.0
    assert got["MNIST_label_mcvae_0.5"]["test/BCE"]["mean"] is None
    assert got["MNIST_label_mcgan_0.5"]["test/Loss"]["argmin"] == "1"


def _vis_rows(path, prefix):
    rows = []
    for line in open(path).read().splitlines()[1:]:
        head, _, args = line.partition(" --")
        rows.append((head[len(prefix):].replace(".py", "").strip(), "--" + args))
    return rows


@pytest.mark.parametrize("pivot", ["generated/InceptionScore", "generated/FID",
                                   "created/DBI"])
def test_make_vis_matches_jax(tmp_path, pivot):
    """The same cells and best seeds (in the pivot's direction) as the JAX
    ``make_vis``, through this package's ``cli.sample``."""
    _write_results(tmp_path)
    summary = pprocess.process(str(tmp_path))
    want = _vis_rows(jprocess.make_vis(summary, str(tmp_path / "j"), pivot), "python ")
    got = _vis_rows(pprocess.make_vis(summary, str(tmp_path / "p"), pivot),
                    "python -m mcgm_tpu_torch.cli.sample ")
    assert got == want and len(got) == 6
    best = {"generated/InceptionScore": "1", "generated/FID": "0", "created/DBI": "1"}[pivot]
    mcgan = [args for _, args in got if "--model_name mcgan " in args]
    assert len(mcgan) == 3 and mcgan[0].endswith(f"--control_name 0.5 --init_seed {best}")


def test_curves_match_jax(tmp_path, monkeypatch):
    """Curves from both packages' checkpoints equal to the JAX
    ``collect_curves``; the JSON's mean / std by epoch; a PNG only when
    asked, and then without matplotlib an ``ImportError`` naming it."""
    mdir = tmp_path / "model"
    os.makedirs(mdir)
    for seed, make, fid in (("0", _jax_logger, [60.0, 50.0, 45.0]),
                            ("1", _port_logger, [70.0, 40.0])):
        with open(mdir / f"{seed}_MNIST_label_mcgan_0.5_checkpoint.pkl", "wb") as f:
            pickle.dump({"model_dict": {}, "logger": make({"test/FID": fid})}, f)
    (mdir / "0_MNIST_label_mcgan_0.5_best.pkl").write_bytes(b"not read")
    for metric in ("test/FID", "test/InceptionScore"):
        assert dict(pcurve.collect_curves(str(tmp_path), metric)) == \
            dict(jcurve.collect_curves(str(tmp_path), metric))
    written = pcurve.plot_curves(str(tmp_path))
    assert [os.path.basename(p) for p in written] == ["test_FID.json"]
    stats = json.load(open(written[0]))["MNIST_label_mcgan_0.5"]
    assert stats == {"seeds": 2, "epochs": 2, "mean": [65.0, 45.0], "std": [5.0, 5.0]}
    drawn = pcurve.plot_curves(str(tmp_path), ("test/FID",), png=True)
    assert drawn[1].endswith("test_FID.png") and os.path.getsize(drawn[1]) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        pcurve.plot_curves(str(tmp_path), png=True)


SMALL = {
    "mcgan": {"gan": {"latent_size": 8, "generator_hidden_size": [16, 8, 8, 8],
                      "discriminator_hidden_size": [8, 8, 8, 16], "embedding_size": 4}},
    "vqvae": {"vqvae": {"hidden_size": [8, 8], "num_res_block": 1, "embedding_size": 4,
                        "num_embedding": 16, "vq_commit": 0.25}},
    "mcglow": {"glow": {"hidden_size": 8, "K": 2, "L": 2, "affine": True, "conv_lu": True,
                        "scan_flows": True}},
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_param_table_matches_jax(tmp_path, name):
    """``summary.md``'s table of a small model, built by ``cli.summary`` on
    the CPU, equal line for line to the JAX ``summarize_model`` of the same
    configuration's variables (``jax.eval_shape`` of its init: shapes only)."""
    cfg = dict(jload_config(), model_name=name, data_name="MNIST", derive_model_params=False,
               control={"controller_rate": "0.5"}, control_name="0.5", **SMALL[name])
    cfg = japply(jprocess_control(cfg))
    cfg["classes_size"] = 10
    batch = {"img": jnp.zeros((2, *cfg["data_shape"])), "label": jnp.zeros((2,), jnp.int32)}
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "z": key, **{s: key for s in RNG_STREAMS.get(FAMILY[name], ())}}
    model = jbuild_model(cfg)
    variables = jax.eval_shape(lambda: model.init(rngs, batch, train=True))
    want = jsummary.summarize_model(model, variables, name)
    texts = psummary_cli.main(["--model_name", name, "--data_name", "MNIST", "--output_dir",
                               str(tmp_path), "--device", "cpu"], derive_model_params=False,
                              **SMALL[name])
    assert texts[name] == want
    assert (tmp_path / "summary.md").read_text() == want + "\n\n"
    rows, totals = psummary.param_table(variables)
    assert sum(totals.values()) == sum(n for _, _, n in rows) > 0


def _imports(tree):
    """``(module, enclosing function or None)`` of every import in ``tree``."""
    out = []

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef,
                                                     ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Import):
                out.extend((a.name, fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and not child.level:
                out.append((child.module, fn))
            walk(child, inner)

    walk(tree, None)
    return out


def test_no_pil_and_matplotlib_only_when_drawing():
    """No module of the port imports PIL (the card's machine has none), and
    matplotlib is imported only inside ``plot_curves``."""
    seen = []
    for path in sorted(PORT_ROOT.rglob("*.py")):
        for module, fn in _imports(ast.parse(path.read_text())):
            top = module.split(".")[0]
            if top == "PIL" or (top == "matplotlib" and fn != "plot_curves"):
                seen.append((str(path.relative_to(PORT_ROOT)), module, fn))
            if top == "matplotlib":
                assert path.name == "learning_curve.py"
    assert not seen
