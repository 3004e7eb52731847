"""CPU parity of the port's mode manipulation, image grids and generate /
transit / create workflows against the JAX package, and the sample CLI.

- ``create`` (both streams) and ``transit`` act on the port's MCGAN and
  CGAN state; the JAX functions act on the same variables (the port model's
  tree, which ``tests/test_torch_port_loop.py`` and
  ``tests/test_torch_port_cgan.py`` hold to the JAX models'). The MCGAN has
  12 D blocks, so that ``_MCDisResBlock_10`` sorts before
  ``_MCDisResBlock_2``, as ``jax.tree_util`` visits them. Codebooks must be
  equal bit for bit; mixed or interpolated embeddings within ``1e-6``
  (f32 matmuls in two libraries).
- The workflows run on tiny models in both packages with the same z (both
  samplers' ``sample_z`` draw from one numpy stream, call by call, since
  ``jax.random`` and torch streams differ), in chunks of 16 images (of 1000
  outside the tests): ``.npy`` dumps within
  ``1e-5 * 255``; the images of each grid within ``1e-5`` of the JAX
  workflow's; and each PNG, decoded with PIL, equal byte for byte to the
  JAX package's ``make_grid`` of the images the port wrote into it (a pixel
  of the two packages' PNGs may round the other way where their images
  differ in the last bits).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from mcgm_tpu.io import images as jimages
from mcgm_tpu.models import manipulate as jmanip
from mcgm_tpu.models.gan import CGAN as JaxCGAN
from mcgm_tpu.models.gan import MCGAN as JaxMCGAN
from mcgm_tpu.workflows.create import create_workflow as jax_create_workflow
from mcgm_tpu.workflows.generate import generate as jax_generate
from mcgm_tpu.workflows.transit import transit_workflow as jax_transit_workflow
from mcgm_tpu.workflows.sampling import Sampler as JaxSampler
from mcgm_tpu_torch.cli import sample as cli_sample
from mcgm_tpu_torch.io import images as pimages
from mcgm_tpu_torch.io.checkpoint import save_checkpoint
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_gan_variables
from mcgm_tpu_torch.models import manipulate as pmanip
from mcgm_tpu_torch.models.gan import CGAN, MCGAN
from mcgm_tpu_torch.workflows import sampling as psampling
from mcgm_tpu_torch.workflows.create import create_workflow
from mcgm_tpu_torch.workflows.generate import generate
from mcgm_tpu_torch.workflows.transit import transit_workflow
from test_torch_port_gan import _fill

K = 10
EMB_TOL = 1e-6
DUMP_TOL = 1e-5 * 255
# manipulation only: no forward runs, so 12 D blocks need no valid resolution
WIDE = {"mcgan": lambda: MCGAN((32, 32, 3), 8, (8, 8, 8), (8,) * 12, K, seed=1),
        "cgan": lambda: CGAN((32, 32, 3), 8, (8, 8, 8), (8, 8, 8, 8), K, 6, seed=1)}
# the workflows: one G block, the least to compile in JAX
TINY = {"mcgan": dict(data_shape=(32, 32, 1), latent_size=8, generator_hidden_size=(8, 8),
                      discriminator_hidden_size=(8, 8, 8), num_mode=K, controller_rate=0.5),
        "cgan": dict(data_shape=(32, 32, 1), latent_size=8, generator_hidden_size=(8, 8),
                     discriminator_hidden_size=(8, 8, 8), num_mode=K, embedding_size=6)}
# the samplers' chunk in the tests: the sweeps cross chunk boundaries, and
# no chunk is padded to the default 1000 images
CHUNK = 16
GAN_CFG = {"latent_size": 8, "generator_hidden_size": [8, 8],
           "discriminator_hidden_size": [8, 8, 8], "embedding_size": 6}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One torch thread: every image of a chunk goes through the same code
    path in one fixed order. With two, about one process in ten (measured
    with XLA held to one thread, which crowds the main thread) computed the
    first half of the first chunk on another path of the CPU convolutions,
    4.97e-5 off on the [-1, 1] image, against 4.5e-7 everywhere else; the
    JAX side came out bit-equal in every setting."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_state(variables) -> dict:
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))


def _assert_state_matches(got: dict, want: dict, model) -> None:
    """Codebooks bit-equal, embeddings within EMB_TOL, the rest untouched."""
    assert set(got) == set(want)
    old = model.state_dict()
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("codebook"):
            assert torch.equal(g, w), k
        elif ".embedding.weight" in k:
            assert (g - w).abs().max() <= EMB_TOL, k
        else:
            assert torch.equal(g, w) and torch.equal(g, old[k]), k


# --------------------------------------------------------- manipulation
def test_create_visits_leaves_in_jax_order():
    order = [path for _, path, _, _ in pmanip._matched(WIDE["mcgan"]())]
    blocks = [p[2] for p in order if p[1] == "discriminator" and "ResBlock" in p[2]]
    assert blocks.index("_MCDisResBlock_10") < blocks.index("_MCDisResBlock_2")
    assert order == sorted(order) and order[0][0] == "codebook"


@pytest.mark.parametrize("modes", [K, 50])
@pytest.mark.parametrize("torch_compat", [False, True])
@pytest.mark.parametrize("name", ["mcgan", "cgan"])
def test_create_matches_jax(name, torch_compat, modes):
    model = WIDE[name]()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = pmanip.create(model, modes, rng_seed=7, torch_compat=torch_compat, model_name=name)
    want = jmanip.create(to_jax_gan_variables(model), modes, rng_seed=7,
                         torch_compat=torch_compat, model_name=name)
    _assert_state_matches(got, _jax_state(want), model)
    assert all(torch.equal(t, before[k]) for k, t in model.state_dict().items())
    if name == "cgan":
        d_emb = got["discriminator.embedding.weight"]
        if torch_compat:  # the reference's dead draw: D's embedding kept as trained
            assert torch.equal(d_emb, before["discriminator.embedding.weight"])
        else:
            assert d_emb.shape == (6, modes)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.6875, 1.0])  # 0.6875: (1 - a) * 8 = 2.5
@pytest.mark.parametrize("name", ["mcgan", "cgan"])
def test_transit_matches_jax(name, alpha):
    model = WIDE[name]()
    got = pmanip.transit(model, 0, alpha)
    want = jmanip.transit(to_jax_gan_variables(model), 0, alpha)
    _assert_state_matches(got, _jax_state(want), model)
    cb = [k for k in got if k.endswith("codebook")]
    assert all(torch.equal(got[k][0], model.state_dict()[k][0]) for k in cb)


# ---------------------------------------------------------------- images
def test_png_and_grid_match_the_jax_writer(tmp_path):
    """The same images: the port's PNG decodes (PIL) to the JAX writer's
    pixels, gray and RGB, and the port's decoder reads both files."""
    rng = np.random.default_rng(0)
    for c in (1, 3):
        img = rng.uniform(-1, 1, (23, 5, 7, c)).astype(np.float32)
        p, j = str(tmp_path / f"p{c}.png"), str(tmp_path / f"j{c}.png")
        pimages.save_image_grid(img, p, nrow=6)
        jimages.save_image_grid(img, j, nrow=6)
        want = np.asarray(Image.open(j))
        assert np.array_equal(np.asarray(Image.open(p)), want)
        assert np.array_equal(pimages.read_png(p)[..., 0] if c == 1 else pimages.read_png(p),
                              want)
        assert np.array_equal(pimages.read_png(j).reshape(want.shape), want)
        u8 = jimages.to_uint8(img)
        assert np.array_equal(pimages.make_grid(u8, 6), jimages.make_grid(u8, 6))


# ------------------------------------------------------------- workflows
class _Z:
    """One numpy stream of latents, drawn call by call."""

    def __init__(self):
        self.rng = np.random.default_rng(123)

    def __call__(self, n, latent):
        return self.rng.standard_normal((n, latent)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """Each tiny model's port module, JAX module, variables and JAX compile
    cache, shared by the workflow tests (each compile costs a second)."""
    out = {}
    for name in TINY:
        port = (MCGAN if name == "mcgan" else CGAN)(**TINY[name])
        v = _fill(to_jax_gan_variables(port), np.random.default_rng(4))
        port.load_state_dict(from_jax_variables(v))
        jm = (JaxMCGAN if name == "mcgan" else JaxCGAN)(**TINY[name])
        out[name] = (port.eval(), jm, jax.tree_util.tree_map(jnp.asarray, v), {})
    return out


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages' samplers draw in chunks of ``CHUNK`` images."""
    for cls in (psampling.Sampler, JaxSampler):
        monkeypatch.setattr(cls, "sample_chunked",
                            functools.partialmethod(cls.sample_chunked, chunk=CHUNK))


@pytest.fixture
def pair(models, tmp_path, monkeypatch, small_chunks):
    """``make(name, **cfg)`` -> (port Sampler, JAX Sampler) over one tiny
    model's variables, with z from one stream per package. Each sampler's
    ``grids`` records what its workflows wrote: file -> (images, nrow)."""
    pz, jz = _Z(), _Z()
    grids = {"port": {}, "jax": {}}
    for side, real in (("port", pimages.save_image_grid), ("jax", jimages.save_image_grid)):
        def record(img, path, nrow=10, real=real, side=side):
            grids[side][os.path.basename(path)] = (np.asarray(img), nrow)
            real(img, path, nrow=nrow)

        pkg = "mcgm_tpu_torch" if side == "port" else "mcgm_tpu"
        for m in ("generate", "transit", "create"):
            # by module object: the JAX package's ``workflows.generate`` names a function
            monkeypatch.setattr(sys.modules[f"{pkg}.workflows.{m}"], "save_image_grid", record)
    monkeypatch.setattr(psampling.Sampler, "sample_z",
                        lambda self, n, gen: torch.from_numpy(pz(n, self.model.latent_size)))
    monkeypatch.setattr(JaxSampler, "sample_z",
                        lambda self, n, rng: jnp.asarray(jz(n, self.model.latent_size)))

    def make(name, **over):
        model, jm, v, jit_cache = models[name]
        cfg = dict(dict(model_name=name, data_name="MNIST", classes_size=K,
                        generate_per_mode=3, save_per_mode=2, save_format="png",
                        save_npy=False, save_img=True, gan=GAN_CFG, controller_rate=0.5,
                        data_shape=[32, 32, 1], output_dir=str(tmp_path / "port")), **over)
        port = psampling.Sampler(cfg, model)
        jsam = JaxSampler(dict(cfg, output_dir=str(tmp_path / "jax")), jm, v)
        jsam._jit_cache = jit_cache
        port.grids, jsam.grids = grids["port"], grids["jax"]
        return port, jsam

    return make


def _pngs(sampler) -> dict:
    vis = os.path.join(sampler.cfg["output_dir"], "vis")
    return {f: np.asarray(Image.open(os.path.join(vis, f))) for f in sorted(os.listdir(vis))}


def _assert_same_pngs(port, jax_sampler) -> None:
    pngs = _pngs(port)
    assert pngs.keys() == port.grids.keys() == jax_sampler.grids.keys() and pngs
    for f, (img, nrow) in port.grids.items():
        want_img, want_nrow = jax_sampler.grids[f]
        assert nrow == want_nrow and img.shape == want_img.shape, f
        assert np.abs(img - want_img).max() <= 1e-5, f
        grid = jimages.make_grid(jimages.to_uint8(img), nrow)
        assert np.array_equal(pngs[f], grid[..., 0] if grid.shape[-1] == 1 else grid), f


def test_generate_workflow_matches_jax(pair):
    port, jsam = pair("cgan", save_npy=True)
    out = generate(port, "0_tiny", torch.Generator())
    want = jax_generate(jsam, "0_tiny", jax.random.PRNGKey(0))
    assert out.shape == want.shape == (K * 3, 1, 32, 32)
    assert np.abs(out - np.asarray(want)).max() <= DUMP_TOL
    _assert_same_pngs(port, jsam)
    port.cfg["save_npy"] = jsam.cfg["save_npy"] = False  # the grid path: 10 modes
    generate(port, "0_tiny", torch.Generator())
    jax_generate(jsam, "0_tiny", jax.random.PRNGKey(0))
    _assert_same_pngs(port, jsam)


def test_transit_workflow_matches_jax(pair):
    """``save_per_mode + 1`` alphas of one z per mode, from the trained state."""
    port, jsam = pair("mcgan")
    got = transit_workflow(port, "0_tiny", torch.Generator())
    want = jax_transit_workflow(jsam, "0_tiny", jax.random.PRNGKey(0))
    assert got.keys() == want.keys() == {10}
    assert got[10].shape == (3 * 10, 32, 32, 1)
    assert np.abs(got[10] - np.asarray(want[10])).max() <= 1e-5
    _assert_same_pngs(port, jsam)


def test_create_workflow_matches_jax(pair):
    """``save_npy`` at the trained mode count, then the grids at 10, 50 and
    100 created modes (models rebuilt with that many), in the reference's
    torch stream, which keeps CGAN's D embedding at the trained mode count
    (both streams' draws are held to the JAX package's above)."""
    port, jsam = pair("cgan", save_npy=True, torch_compat=True)
    out = create_workflow(port, "0_tiny", torch.Generator())
    want = jax_create_workflow(jsam, "0_tiny", jax.random.PRNGKey(0))
    assert np.abs(out - np.asarray(want)).max() <= DUMP_TOL
    port.cfg["save_npy"] = jsam.cfg["save_npy"] = False
    create_workflow(port, "0_tiny", torch.Generator())
    jax_create_workflow(jsam, "0_tiny", jax.random.PRNGKey(0))
    _assert_same_pngs(port, jsam)
    assert {f for f in _pngs(port)} >= {f"created_0_tiny_{m}.png" for m in (10, 50, 100)}


def test_create_refuses_glow(pair):
    port, _ = pair("cgan")
    with pytest.raises(NotImplementedError, match="Glow"):
        create_workflow(psampling.Sampler(dict(port.cfg, model_name="cglow"), port.model),
                        "0_tiny")


# ------------------------------------------------------------------- CLI
def _checkpoint(tmp_path) -> list:
    """A tiny CGAN ``_best`` for ``Synthetic``; returns the CLI's arguments."""
    cfg = {"output_dir": str(tmp_path)}
    model = CGAN((32, 32, 3), 8, (8, 8), (8, 8, 8), K, 6, cifar_style=False)
    save_checkpoint(cfg, "0_Synthetic_label_cgan_0.5", {"model_dict": to_jax_gan_variables(model),
                                                        "epoch": 2}, kind="best")
    return ["--data_name", "Synthetic", "--model_name", "cgan", "--output_dir", str(tmp_path),
            "--save_per_mode", "2"]


@pytest.mark.parametrize("workflow", ["generate", "transit", "create"])
def test_sample_cli_on_the_cpu(tmp_path, workflow, small_chunks):
    argv = _checkpoint(tmp_path) + ["--device", "cpu"]
    (out,) = cli_sample.main(workflow, argv, derive_model_params=False, gan=GAN_CFG)
    vis = sorted(os.listdir(tmp_path / "vis"))
    prefix = {"generate": "generated", "transit": "transited", "create": "created"}[workflow]
    assert vis and all(f.startswith(prefix) for f in vis)
    for f in vis:
        assert pimages.read_png(str(tmp_path / "vis" / f)).shape[-1] == 3


def test_sample_cli_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_sample.main("generate", _checkpoint(tmp_path), derive_model_params=False,
                        gan=GAN_CFG)
