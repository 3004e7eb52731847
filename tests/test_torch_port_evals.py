"""CPU parity of the PyTorch port's GAN eval against the JAX package:
IS / FID / DBI, the 299 resize, InceptionV3 at full width, the classifier
feature model and the eval sweep's centred moments.

JAX models are built once per module from ``jax.eval_shape`` plus numpy
values, and the full-width InceptionV3 is compiled once at a low XLA
optimisation level; inputs come from ``np.random.default_rng``.

Tolerances, and why:

- IS, FID, DBI: float64 on both sides (the JAX FID under ``jax.enable_x64``),
  the same formulas in other libraries' summation orders: ``rtol=1e-6``;
- the bilinear resize: f32 weights computed two ways: ``atol=1e-6`` on
  values in [-1, 1];
- InceptionV3 (2x75x75x3, the smallest input both take) and the classifier:
  f32, other conv algorithms through 94 (or 4) convolutions:
  ``rtol=1e-4`` and ``atol = 1e-5 * max|ref|``;
- the sweep's moments: f32 sums of centred features against float64 numpy:
  ``rtol=1e-5``, ``atol = 1e-5 * max|ref|``;
- the per-batch metrics and the ``Metric`` registry: f32 means in other
  orders: ``rtol=1e-5``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fixture_utils import make_random_inception, randomize_variables
from mcgm_tpu.evals import metrics as jmetrics
from mcgm_tpu.evals.inception import bilinear_resize_299 as jax_resize
from mcgm_tpu.models.classifier import Classifier as JaxClassifier
from mcgm_tpu_torch.evals import metrics as pmetrics
from mcgm_tpu_torch.evals.features import classifier_feature_fn, extract_real_features
from mcgm_tpu_torch.evals.inception import InceptionV3, bilinear_resize_299
from mcgm_tpu_torch.io.jax_import import (from_jax_classifier, from_jax_inception,
                                          to_jax_inception)
from mcgm_tpu_torch.models.classifier import Classifier
from mcgm_tpu_torch.train.loop import Experiment

F64 = dict(rtol=1e-6, atol=0)
NET_RTOL, NET_ATOL = 1e-4, 1e-5
LOW_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, rtol=NET_RTOL, atol=NET_ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max())


# ---------------------------------------------------------------- metrics
@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    real = rng.normal(0.5, 1.0, (300, 16))
    gen = 0.8 * real[:200] + rng.normal(0.2, 0.5, (200, 16))
    logits = rng.normal(0, 2, (120, 10))
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return real, gen, probs


@pytest.mark.parametrize("splits", [1, 3])
def test_inception_score_matches_jax(feats, splits):
    probs = feats[2]
    np.testing.assert_allclose(pmetrics.inception_score(probs, splits),
                               jmetrics.inception_score(probs, splits), **F64)


@pytest.mark.parametrize("method", ["eigh", "scipy"])
def test_frechet_distance_matches_jax(feats, method):
    """The port's FID (eigh only) against each of the JAX package's two
    ways to take ``trace(sqrtm(S1 S2))``."""
    real, gen, _ = feats
    stats = [real.mean(0), np.cov(real, rowvar=False), gen.mean(0), np.cov(gen, rowvar=False)]
    with jax.enable_x64(True):
        want = jmetrics.frechet_distance(*stats, method=method)
        want_fid = jmetrics.fid_from_features(real, gen)
    np.testing.assert_allclose(pmetrics.frechet_distance(*stats), want, **F64)
    np.testing.assert_allclose(pmetrics.fid_from_features(real, gen), want_fid, **F64)
    assert want > 0


def test_dbi_matches_jax():
    rng = np.random.default_rng(1)
    label = rng.integers(0, 5, 200)
    img = rng.normal(label[:, None, None, None] * 0.3, 1.0, (200, 4, 4, 3))
    np.testing.assert_allclose(pmetrics.dbi(img, label), jmetrics.dbi(img, label), **F64)


def test_device_metrics_match_jax():
    """Per-batch metrics on tensors, with and without a padding mask."""
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (6, 4, 4, 3)).astype(np.float32)
    out = np.tanh(img + rng.normal(0, 0.3, img.shape)).astype(np.float32)
    logits = rng.normal(0, 1, (6, 10)).astype(np.float32)
    label = rng.integers(0, 10, 6)
    names = ["MSE", "BCE", "PSNR", "Accuracy"]
    for w in (None, np.array([1, 1, 1, 1, 0, 0], np.float32)):
        jb = {"img": jnp.asarray(img), "label": jnp.asarray(label)}
        pb = {"img": torch.tensor(img), "label": torch.tensor(label)}
        if w is not None:
            jb["w"], pb["w"] = jnp.asarray(w), torch.tensor(w)
        want = jmetrics.make_device_metrics(names)(
            jb, {"img": jnp.asarray(out), "label": jnp.asarray(logits)})
        got = pmetrics.make_device_metrics(names)(
            pb, {"img": torch.tensor(out), "label": torch.tensor(logits)})
        for k in names:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


# -------------------------------------------------------------- inception
def test_resize_299_matches_jax():
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    got = bilinear_resize_299(torch.tensor(x)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.jit(jax_resize)(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def inception():
    """The JAX InceptionV3 with seeded weights, its outputs on 2x75x75x3,
    and the port's network with the same weights."""
    model, variables, x = make_random_inception(seed=5)
    fn = jax.jit(lambda v, x: model.apply(v, x)).lower(variables, x).compile(
        compiler_options=LOW_OPT)
    feats, logits = fn(variables, x)
    port = InceptionV3()
    port.load_state_dict(from_jax_inception(variables))
    return variables, np.asarray(x), np.asarray(feats), np.asarray(logits), port.eval()


def test_inception_matches_jax(inception):
    _, x, feats, logits, port = inception
    assert sum(p.numel() for p in port.parameters()) == 23_834_568
    with torch.no_grad():
        got_f, got_l = port(torch.tensor(x).permute(0, 3, 1, 2))
    assert got_f.shape == (2, 2048) and got_l.shape == (2, 1000)
    _close(got_f.numpy(), feats)
    _close(got_l.numpy(), logits)


def test_inception_weights_round_trip(inception):
    variables, *_, port = inception
    back = to_jax_inception(port.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert a.dtype == np.float32 and np.array_equal(a, np.asarray(b))
    again = from_jax_inception(back)
    sd = port.state_dict()
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


# ------------------------------------------------------------- classifier
@pytest.fixture(scope="module")
def classifier():
    rng = np.random.default_rng(4)
    jm = JaxClassifier((32, 32, 3), (4, 8, 8, 8), 10)
    img = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    v = randomize_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img)), 4)
    logits = jax.jit(lambda v, x: jm.apply(v, x)["label"]).lower(v, img).compile(
        compiler_options=LOW_OPT)(v, img)
    feats = jax.jit(lambda v, x: jm.apply(v, x, feature_only=True)).lower(v, img).compile(
        compiler_options=LOW_OPT)(v, img)
    return v, img, np.asarray(feats), np.asarray(logits)


def test_classifier_matches_jax(classifier):
    v, img, feats, logits = classifier
    port = Classifier((32, 32, 3), (4, 8, 8, 8), 10)
    port.load_state_dict(from_jax_classifier(v))
    port.eval()
    with torch.no_grad():
        _close(port(torch.tensor(img), feature_only=True).numpy(), feats)
        _close(port(torch.tensor(img)).numpy(), logits)
    fn = classifier_feature_fn({"data_shape": [32, 32, 3], "classifier": {"hidden_size": [4, 8, 8, 8]},
                                "classes_size": 10}, v, "cpu")
    f, p = fn(torch.tensor(img))
    _close(f.numpy(), feats)
    want_p = np.asarray(jax.nn.softmax(logits, -1))
    _close(p.numpy(), want_p)


# --------------------------------------------------------- eval moments
def test_eval_moments_match_numpy(classifier):
    """The sweep's centred f32 accumulation on the device (here the CPU)
    against ``np.mean`` / ``np.cov`` of the same features in float64,
    centred on another image set's feature mean (as the sweep centres on
    the real split's) and on zero."""
    v = classifier[0]
    cfg = {"data_shape": [32, 32, 3], "classifier": {"hidden_size": [4, 8, 8, 8]},
           "classes_size": 10}
    fn = classifier_feature_fn(cfg, v, "cpu")
    rng = np.random.default_rng(6)
    imgs = torch.tensor(rng.uniform(-1, 1, (70, 32, 32, 3)).astype(np.float32))
    model = SimpleNamespace(generate=lambda C, z: imgs[z[:, 0].long()])
    C = np.arange(70) % 10
    z = torch.arange(70, dtype=torch.float32)[:, None]
    all_feats = fn(imgs)[0].double().numpy()
    want_mu, want_sigma = all_feats.mean(0), np.cov(all_feats, rowvar=False)
    other = torch.tensor(rng.uniform(-1, 1, (70, 32, 32, 3)).astype(np.float32))
    for centre in (None, fn(other)[0].double().mean(0).numpy()):
        exp = SimpleNamespace(model=model, feature_fn=fn, fixed_z=z, device=torch.device("cpu"),
                              real_stats=None if centre is None else (centre, None))
        probs, mu, sigma = Experiment.gan_eval_moments(exp, C, 32)
        assert probs.shape == (70, 10)
        np.testing.assert_allclose(mu, want_mu, rtol=1e-5, atol=1e-5 * np.abs(want_mu).max())
        np.testing.assert_allclose(sigma, want_sigma, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_sigma).max())
    real = extract_real_features(fn, (imgs.numpy() * 127.5 + 127.5).astype(np.uint8), 32)
    assert real.shape == (70, all_feats.shape[1]) and real.dtype == torch.float32


def test_metric_registry_matches_jax():
    """``Metric.evaluate`` over every name it takes, with a linear feature
    model (the same weights on both sides), against the JAX ``Metric``."""
    rng = np.random.default_rng(7)
    img = rng.uniform(-1, 1, (40, 4, 4, 3)).astype(np.float32)
    out = np.tanh(img + rng.normal(0, 0.3, img.shape)).astype(np.float32)
    label = rng.integers(0, 4, 40)
    logits = rng.normal(0, 1, (40, 4)).astype(np.float32)
    pix = rng.integers(0, 8, (40, 4, 4))
    pix_logits = rng.normal(0, 1, (40, 4, 4, 8)).astype(np.float32)
    w = rng.normal(0, 0.2, (48, 6)).astype(np.float32)
    real = rng.normal(0, 1, (64, 6))

    def jfn(x):
        f = x.reshape(len(x), -1) @ w
        return f, jax.nn.softmax(f[:, :4], -1)

    def pfn(x):
        f = x.reshape(len(x), -1) @ torch.tensor(w)
        return f, torch.softmax(f[:, :4], -1)

    # (names, input, output): the output's "label" is logits for Accuracy,
    # cluster ids for DBI
    groups = [
        (["Loss", "InceptionScore", "FID", "Accuracy", "MSE", "BCE", "PSNR"],
         {"img": img, "label": label}, {"loss": np.float32(0.5), "img": out, "label": logits}),
        (["DBI"], {}, {"img": out, "label": label}),
        (["NLL"], {"img": pix}, {"logits": pix_logits}),
    ]
    for names, inp, outp in groups:
        with jax.enable_x64(True):
            want = jmetrics.Metric({}, jfn, real_features=real).evaluate(
                names, {k: jnp.asarray(v) for k, v in inp.items()},
                {k: jnp.asarray(v) for k, v in outp.items()})
        got = pmetrics.Metric({}, pfn, real_features=real).evaluate(
            names, {k: torch.tensor(v) for k, v in inp.items()},
            {k: torch.tensor(v) for k, v in outp.items()})
        for k in names:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
