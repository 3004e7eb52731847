"""The port's import of reference (PyTorch) checkpoints against the JAX
package's, and the reference's codebook stream.

For each of the ten models a synthetic reference ``state_dict``
(``reference_state_dicts.py``: the key paths the converters read, each
tensor shaped as the same layer of the port's tiny model) goes through both
packages' imports. The port's ``io.torch_import.load_reference`` must equal
``mcgm_tpu.io.torch_import.convert`` followed by the port's
``from_jax_variables`` tensor for tensor, and load into the port's model
with every key. A key no converter reads raises. The torch-stream
codebooks equal the reference's own, ``tests/fixtures/torch_codebooks.npz``.
"""

import os

import numpy as np
import pytest
import torch

from mcgm_tpu.io import torch_import as jti
from mcgm_tpu_torch import config as pconfig
from mcgm_tpu_torch.cli import import_reference as cli_import
from mcgm_tpu_torch.io import torch_import as pti
from mcgm_tpu_torch.io.checkpoint import load_checkpoint
from mcgm_tpu_torch.io.jax_import import from_jax_variables
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.ops.controller import make_codebook
from reference_state_dicts import reference_state_dict

M = 4
ARCH = {
    "mcvae": {"vae": {"hidden_size": [8, 16], "latent_size": 8, "num_res_block": 1}},
    "cvae": {"vae": {"hidden_size": [8, 16], "latent_size": 8, "num_res_block": 1,
                     "embedding_size": 8}},
    "vqvae": {"vqvae": {"hidden_size": [8, 8], "num_res_block": 1, "embedding_size": 8,
                        "num_embedding": 16, "vq_commit": 0.25}},
    "classifier": {"classifier": {"hidden_size": [4, 8, 8, 8]}},
    "mcgan": {"gan": {"latent_size": 16, "generator_hidden_size": [16, 16, 16],
                      "discriminator_hidden_size": [8, 16, 16, 16]}},
    "cgan": {"gan": {"latent_size": 16, "generator_hidden_size": [16, 16, 16],
                     "discriminator_hidden_size": [8, 16, 16, 16], "embedding_size": 8}},
    "mcpixelcnn": {"pixelcnn": {"num_layer": 2, "hidden_size": 8, "num_embedding": 16}},
    "cpixelcnn": {"pixelcnn": {"num_layer": 2, "hidden_size": 8, "num_embedding": 16}},
    "mcglow": {"glow": {"hidden_size": 8, "K": 2, "L": 2, "affine": True, "conv_lu": True,
                        "scan_flows": True}},
    "cglow": {"glow": {"hidden_size": 8, "K": 2, "L": 2, "affine": True, "conv_lu": True,
                       "scan_flows": True}},
}


def _arch(name):
    return next(iter(ARCH[name].values()))


def _cfg(name):
    cfg = pconfig.process_control(dict(pconfig.load_config(), data_name="CIFAR10",
                                       model_name=name, derive_model_params=False,
                                       **ARCH[name]))
    return dict(cfg, classes_size=M)


@pytest.mark.parametrize("name", list(ARCH))
def test_reference_import_matches_jax(name):
    """Tensor for tensor the JAX package's conversion followed by the
    port's JAX import; the port's model loads it with every key."""
    cfg = _cfg(name)
    model = build_model(cfg, "cpu")
    sd = reference_state_dict(name, model, _arch(name), seed=len(name))
    dims = pti.reference_dims(cfg)
    got = pti.load_reference(name, sd, **dims)
    want = from_jax_variables(jti.convert(name, sd, **dims))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ["mcgan", "cglow"])
def test_reference_import_refuses_an_unused_key(name):
    model = build_model(_cfg(name), "cpu")
    sd = reference_state_dict(name, model, _arch(name))
    sd["generator.extra.weight" if name == "mcgan" else "blocks.0.extra"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unmapped reference keys"):
        pti.load_reference(name, sd, **pti.reference_dims(_cfg(name)))


def test_dead_generator_biases_fold_into_the_batchnorm_mean():
    """A reference G conv bias the port drops moves the next BatchNorm's
    running mean by minus itself (eval-exact); the last block's two carry
    into the head BatchNorm."""
    name = "mcgan"
    cfg = _cfg(name)
    model = build_model(cfg, "cpu")
    sd = reference_state_dict(name, model, _arch(name))
    got = pti.load_reference(name, sd, **pti.reference_dims(cfg))
    b = "generator.blocks"
    np.testing.assert_allclose(
        got[f"{b}._MCGenResBlock_0.BatchNorm_1.running_mean"].numpy(),
        (sd[f"{b}.0.conv.5.module.running_mean"] - sd[f"{b}.0.conv.4.module.bias"]).numpy(),
        rtol=1e-6)
    np.testing.assert_allclose(
        got["generator.BatchNorm_0.running_mean"].numpy(),
        (sd[f"{b}.2.module.running_mean"] - sd[f"{b}.1.conv.8.module.bias"]
         - sd[f"{b}.1.shortcut.2.module.bias"]).numpy(), rtol=1e-5, atol=1e-6)


def test_import_cli_writes_a_best_the_port_loads(tmp_path):
    """``cli.import_reference`` on a reference checkpoint pickle: its
    ``_best`` (the scanned Glow layout) loads to the converted weights."""
    name = "mcglow"
    cfg = _cfg(name)
    sd = reference_state_dict(name, build_model(cfg, "cpu"), _arch(name), seed=3)
    path = str(tmp_path / "ref.pt")
    torch.save({"model_dict": sd, "epoch": 12}, path)
    out = cli_import.main([path, "--data_name", "CIFAR10", "--model_name", name,
                           "--control_name", "0.5", "--device", "cpu", "--output_dir",
                           str(tmp_path)], derive_model_params=False, classes_size=M,
                          **ARCH[name])
    assert os.path.exists(out)
    ckpt = load_checkpoint({"output_dir": str(tmp_path)},
                           os.path.basename(out)[:-len("_best.pkl")], "best")
    assert ckpt["epoch"] == 12 and "flows" in ckpt["model_dict"]["params"]["block_0"]
    want = pti.load_reference(name, sd, **pti.reference_dims(cfg))
    got = from_jax_variables(ckpt["model_dict"])
    assert all(torch.equal(got[k], w) for k, w in want.items())


def test_torch_compat_codebooks_match_the_reference_fixture():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "torch_codebooks.npz")
    goldens = np.load(path)
    assert len(goldens.files) == 15
    state = torch.random.get_rng_state()
    for key in goldens.files:
        seed, m, f, r = key[1:].split("_")
        got = make_codebook(int(seed), int(m[1:]), int(f[1:]), float(r[1:]), torch_compat=True)
        assert got.dtype == np.float32 and np.array_equal(got, goldens[key]), key
    assert torch.equal(torch.random.get_rng_state(), state)  # the global generator untouched
