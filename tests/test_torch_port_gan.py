"""CPU parity of the PyTorch port's MCGAN slice against the JAX package.

One tiny 5-stage MCGAN with the 128px structure (4 generator blocks, a start
resolution of ``res >> 4``), at a 32x32 data shape, is built once per module;
its variables are carried into the port with ``from_jax_variables``. Inputs
come from ``np.random.default_rng``; both run f32 on the CPU. Tolerance: ``rtol=1e-4, atol=1e-5`` for images and
intermediates (f32, summation order only), ``rtol=1e-4, atol=1e-4`` for the
discriminator logits, which sum a whole feature map.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from mcgm_tpu.io.checkpoint import save_checkpoint
from mcgm_tpu.models.gan import MCGAN as JaxMCGAN
from mcgm_tpu.report.logger import Logger
from mcgm_tpu_torch.config import process_control
from mcgm_tpu_torch.io.checkpoint import load_model_dict
from mcgm_tpu_torch.io.images import read_png
from mcgm_tpu_torch.io.jax_import import from_jax_variables
from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.models.gan import MCGAN
from mcgm_tpu_torch.workflows.generate import class_sweep, generate
from mcgm_tpu_torch.workflows.sampling import Sampler, load_sampler

TOL = dict(rtol=1e-4, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = pathlib.Path(__file__).resolve().parents[1]
K = 5  # modes
ARCH = dict(data_shape=(32, 32, 3), latent_size=16,
            generator_hidden_size=(32, 16, 16, 8, 8),
            discriminator_hidden_size=(8, 8, 16, 16, 32),
            num_mode=K, controller_rate=0.5, cifar_style=False)
GAN_CFG = {"latent_size": 16, "generator_hidden_size": [32, 16, 16, 8, 8],
           "discriminator_hidden_size": [8, 8, 16, 16, 32], "embedding_size": 8}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _fill(tree, rng):
    """Values for the variable tree of the JAX model, from ``rng``: kernels
    ~ N(0, 1/fan_in), binary codebooks, unit ``u``, and non-trivial
    BatchNorm scales and running statistics (so eval BatchNorm is tested)."""
    out = {}
    for k, s in tree.items():
        if hasattr(s, "items"):
            out[k] = _fill(s, rng)
            continue
        if k == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif k == "codebook":
            a = rng.random(s.shape) < 0.5
        elif k == "u":
            a = rng.standard_normal(s.shape)
            a /= np.linalg.norm(a)
        elif k == "scale":
            a = 1 + 0.1 * rng.standard_normal(s.shape)
        elif k == "var":
            a = rng.uniform(0.5, 2.0, s.shape)
        else:  # bias, mean
            a = 0.1 * rng.standard_normal(s.shape)
        out[k] = np.asarray(a, np.float32)
    return out


@pytest.fixture(scope="module")
def case():
    """The JAX model's variables, the inputs, and the JAX outputs. The
    variable tree is the JAX model's own (``jax.eval_shape`` of its init);
    the values come from numpy, which skips the init's compile."""
    jmodel = JaxMCGAN(**ARCH)
    batch = {"img": jnp.zeros((2, 32, 32, 3)), "label": jnp.zeros((2,), jnp.int32)}
    rngs = {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(1)}
    tree = jax.eval_shape(lambda: jmodel.init(rngs, batch, train=False))
    rng = np.random.default_rng(11)
    v = _fill(tree, rng)
    C = np.array([0, 3, 1, 4, 2, 3], np.int32)
    z = rng.standard_normal((len(C), 16)).astype(np.float32)
    x = rng.uniform(-1, 1, (len(C), 32, 32, 3)).astype(np.float32)

    @jax.jit
    def run(v, C, z, x):
        img = jmodel.apply(v, C, z, method="generate")
        return (img, jmodel.apply(v, x, C, method="discriminate"),
                jmodel.apply(v, img, C, method="discriminate"))

    img, logit_x, chain = (np.asarray(a) for a in run(v, C, z, x))
    return dict(v=v, C=C, z=z, x=x, img=img, logit_x=logit_x, chain=chain)


def _port(v) -> MCGAN:
    model = MCGAN(**ARCH).eval()
    model.load_state_dict(from_jax_variables(v), strict=True)
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


def test_generate_matches_jax(case):
    with torch.no_grad():
        got = _port(case["v"]).generate(_t(case["C"]), _t(case["z"]))
    assert got.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), case["img"], **TOL)


def test_discriminate_matches_jax(case):
    with torch.no_grad():
        got = _port(case["v"]).discriminate(_t(case["x"]), _t(case["C"]))
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), case["logit_x"], **LOGIT_TOL)


def test_chain_matches_jax(case):
    """forward(C, z) is the G -> D chain; on the CPU the first D-block runs
    the kernel's plain version and launches nothing."""
    before = fd.first_dblock.launches
    with torch.no_grad():
        got = _port(case["v"])(_t(case["C"]), _t(case["z"]))
    np.testing.assert_allclose(got.numpy(), case["chain"], **LOGIT_TOL)
    assert fd.first_dblock.launches == before


def test_plain_kernels_switch_keeps_the_function(case):
    model = _port(case["v"])
    with torch.no_grad():
        a = model.discriminate(_t(case["x"]), _t(case["C"]))
        b = model.use_plain_kernels().discriminate(_t(case["x"]), _t(case["C"]))
    assert all(m.plain for m in model.modules() if hasattr(m, "plain"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_forwards_leave_buffers_unchanged(case):
    model = _port(case["v"])
    before = {k: b.clone() for k, b in model.named_buffers()}
    assert any(k.endswith(".u") for k in before)
    assert any(k.endswith("running_var") for k in before)
    with torch.no_grad():
        model.generate(_t(case["C"]), _t(case["z"]))
        model.discriminate(_t(case["x"]), _t(case["C"]))
        model(_t(case["C"]), _t(case["z"]))
    for k, b in model.named_buffers():
        assert torch.equal(b, before[k]), k


# ------------------------------------------------------------ traps to pin
def test_dense_reshape_is_nhwc_at_the_derived_start_resolution(case):
    """The Dense output is reshaped NHWC (``[B, s, s, h0]``), and the start
    resolution is ``res >> (len(hs) - 1)``: 32 >> 4 = 2 here."""
    model = _port(case["v"])
    seen = {}
    block = model.generator.blocks["_MCGenResBlock_0"]
    hook = block.register_forward_pre_hook(lambda m, args: seen.update(x=args[0]))
    with torch.no_grad():
        model.generate(_t(case["C"]), _t(case["z"]))
    hook.remove()
    d = case["v"]["params"]["generator"]["Dense_0"]
    want = (case["z"] @ d["kernel"] + d["bias"]).reshape(6, 2, 2, 32)
    assert model.generator.start == 2
    np.testing.assert_allclose(seen["x"].permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_dead_generator_biases_are_absent(case):
    keys = set(_port(case["v"]).state_dict())
    assert keys == set(from_jax_variables(case["v"]))
    for i in range(4):
        assert f"generator.blocks._MCGenResBlock_{i}.Conv_0.bias" not in keys
    assert "generator.blocks._MCGenResBlock_3.Conv_1.bias" not in keys
    assert "generator.blocks._MCGenResBlock_3.Conv_2.bias" not in keys
    assert "generator.blocks._MCGenResBlock_2.Conv_1.bias" in keys
    assert "generator.blocks._MCGenResBlock_2.Conv_2.bias" in keys


def test_start_resolution_at_128px():
    model = MCGAN((128, 128, 3), 8, (16, 8, 8, 8, 8), (8, 8, 8, 8, 8), num_mode=3)
    assert model.generator.start == 128 >> 4 == 8
    assert model.generator.Dense_0.weight.shape == (16 * 8 * 8, 8)


# ------------------------------------------------------------ config, model
def test_process_control_128px_mcgan():
    cfg = process_control({"data_name": "CelebA-HQ", "model_name": "mcgan",
                           "control": {"controller_rate": "0.5"}})
    assert cfg["data_shape"] == [128, 128, 3] and cfg["generate_per_mode"] == 20
    assert cfg["batch_size"] == {"train": 32, "test": 128}
    assert cfg["controller_rate"] == 0.5
    assert cfg["gan"]["generator_hidden_size"] == [1024, 512, 256, 128, 64]
    assert cfg["gan"]["discriminator_hidden_size"] == [64, 128, 256, 512, 1024]
    assert cfg["gan"]["latent_size"] == 128
    with pytest.raises(NotImplementedError, match="Queue A"):
        process_control({"data_name": "CIFAR10", "model_name": "mcglow"})


def test_build_model_defaults_to_cuda():
    cfg = process_control({"data_name": "CIFAR10", "model_name": "mcgan",
                           "derive_model_params": False})
    cfg.update(classes_size=K, gan=GAN_CFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert model.compute_dtype == torch.float32 and not model.training
    strides = [b.stride for n, b in model.discriminator.blocks.items() if n != "_MCFirstDisResBlock_0"]
    assert strides == [2, 2, 1, 1]  # CIFAR10 keeps two stride-1 tail blocks


# ------------------------------------------------------- sampling, generate
def _cfg(tmp_path):
    cfg = process_control({"data_name": "Synthetic", "model_name": "mcgan",
                           "derive_model_params": False})
    cfg.update(classes_size=K, gan=GAN_CFG, output_dir=str(tmp_path),
               save_npy=True, save_img=False)
    return cfg


def test_sampler_matches_jax_and_chunks(case, tmp_path):
    sampler = load_sampler(_cfg(tmp_path), "0_tiny", variables=case["v"], device="cpu")
    got = sampler.sample_with_z(case["C"], _t(case["z"]))
    np.testing.assert_allclose(got.numpy(), case["img"], **TOL)
    # a class sweep of 12 in chunks of 5: two full chunks and a padded tail
    C = class_sweep(K, 3)[:12]
    imgs = sampler.sample_chunked(C, torch.Generator().manual_seed(0), chunk=5)
    again = sampler.sample_chunked(C, torch.Generator().manual_seed(0), chunk=5)
    assert imgs.shape == (12, 32, 32, 3) and torch.equal(imgs, again)
    assert torch.isfinite(imgs).all() and imgs.abs().max() <= 1


def test_generate_workflow_save_npy(case, tmp_path):
    cfg = _cfg(tmp_path)
    cfg["generate_per_mode"] = 2
    sampler = load_sampler(cfg, "0_tiny", variables=case["v"], device="cpu")
    out = generate(sampler, "0_tiny")
    path = tmp_path / "npy" / "generated_0_tiny.npy"
    np.testing.assert_array_equal(np.load(path), out)
    assert out.shape == (2 * K, 3, 32, 32) and out.min() >= 0 and out.max() <= 255
    # with save_img, the sweep's first save_per_mode rounds as a grid too
    again = generate(Sampler(dict(cfg, save_img=True, save_per_mode=2, save_format="png"),
                             sampler.model), "0_tiny")
    np.testing.assert_array_equal(again, out)
    grid = read_png(str(tmp_path / "vis" / "generated_0_tiny.png"))
    assert grid.shape == (2 * 34 + 2, K * 34 + 2, 3)


# ------------------------------------------------------------- checkpoint
_CHILD = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "flax", "optax", "mcgm_tpu"):
        sys.modules[name] = None  # any import of these now raises
    import json, numpy as np, torch
    from mcgm_tpu_torch.workflows.sampling import load_sampler
    cfg = json.loads(sys.argv[1])
    sampler = load_sampler(cfg, "0_tiny", device="cpu")
    C, z = np.load(sys.argv[2]), torch.from_numpy(np.load(sys.argv[3]))
    np.save(sys.argv[4], sampler.sample_with_z(C, z).numpy())
    banned = [m for m, v in sys.modules.items()
              if v is not None and m.split(".")[0] in
              ("jax", "jaxlib", "flax", "optax", "mcgm_tpu")]
    assert not banned, banned
""")


def test_jax_checkpoint_serves_without_jax(case, tmp_path):
    """A checkpoint the JAX package wrote (a real Logger and optax state in
    the payload) loads and serves in a process where jax, optax and
    mcgm_tpu cannot be imported, and gives the JAX package's images."""
    import json

    cfg = _cfg(tmp_path)
    v = case["v"]
    logger = Logger()
    logger.append({"Loss_D": 1.5}, "train")
    opt = optax.adam(2e-4, b1=0.5)
    payload = {"cfg": cfg, "epoch": 3, "model_dict": v,
               "optimizer_dict": {"generator": opt.init(v["params"]["generator"]),
                                  "discriminator": opt.init(v["params"]["discriminator"])},
               "scheduler_dict": {}, "logger": logger, "rng": np.zeros(2, np.uint32)}
    path = save_checkpoint(cfg, "0_tiny", payload, kind="best")
    np.testing.assert_array_equal(
        load_model_dict(path)["params"]["generator"]["Dense_0"]["kernel"],
        v["params"]["generator"]["Dense_0"]["kernel"])
    files = [str(tmp_path / n) for n in ("C.npy", "z.npy", "out.npy")]
    np.save(files[0], case["C"])
    np.save(files[1], case["z"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg), *files],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(np.load(files[2]), case["img"], **TOL)
