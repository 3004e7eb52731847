"""CPU parity of the PyTorch port's CGAN against the JAX package.

Two tiny CGANs, one per tail and image depth (32x32x3 with ``cifar_style``,
32x32x1 without), take their variables from numpy (the variable tree plus
seeded values, so no init is compiled); G and D run in train and in
eval mode in both packages, in f32. (The CGAN train step against the JAX
step, and a CGAN checkpoint read by the JAX package, are in
``tests/test_torch_port_train.py``, beside the MCGAN step's.)

Tolerance: forwards, train and eval, and the state they move (BatchNorm
statistics, spectral ``u``): ``max|port - JAX| <= 1e-5 * max|JAX|`` (f32,
summation order only).
"""

import numpy as np
import pytest
import torch
import jax

from mcgm_tpu.models.gan import CGAN as JaxCGAN
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_gan_variables
from mcgm_tpu_torch.models.gan import CGAN
from mcgm_tpu_torch.ops.controller import MultimodalController
from test_torch_port_gan import _fill

K, EMB = 5, 8
FWD_TOL = 1e-5
SHAPES = {"rgb_cifar_style": ((32, 32, 3), True), "gray": ((32, 32, 1), False)}
# XLA at a low optimisation level: the compile, not the run, is what costs here
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _arch(shape, cifar_style, latent=16):
    return dict(data_shape=shape, latent_size=latent, generator_hidden_size=(16, 8, 8),
                discriminator_hidden_size=(8, 8, 16, 16), num_mode=K, embedding_size=EMB,
                cifar_style=cifar_style)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _variables(arch, rng):
    """Values from ``rng`` for the variable tree of the port's CGAN, which
    is the JAX CGAN's (``test_torch_port_train.py::
    test_cgan_checkpoint_read_by_jax`` holds it to ``jax.eval_shape`` of the
    JAX init; tracing that init costs a second)."""
    return _fill(to_jax_gan_variables(CGAN(**arch)), rng)


def _port(arch, v) -> CGAN:
    model = CGAN(**arch).eval()
    model.load_state_dict(from_jax_variables(v), strict=True)
    return model


def _jax_forward(shape, cifar_style):
    """Inputs, variables and the JAX model's outputs in eval and train mode,
    with the collections train mode moved; compiled once, at ``O0``."""
    arch = _arch(shape, cifar_style)
    jm = JaxCGAN(**arch)
    rng = np.random.default_rng(3)
    v = _variables(arch, rng)
    C = np.array([0, 3, 1, 4, 2, 3], np.int32)
    z = rng.standard_normal((len(C), 16)).astype(np.float32)
    x = rng.uniform(-1, 1, (len(C), *shape)).astype(np.float32)

    def run(v, C, z, x):
        g_eval = jm.apply(v, C, z, method="generate")
        g_train, g_mut = jm.apply(v, C, z, True, method="generate", mutable=["batch_stats"])
        d_eval = jm.apply(v, x, C, method="discriminate")
        d_train, d_mut = jm.apply(v, x, C, True, method="discriminate", mutable=["spectral"])
        return g_eval, g_train, g_mut, d_eval, d_train, d_mut

    compiled = jax.jit(run).lower(v, C, z, x).compile(compiler_options=O0)
    g_eval, g_train, g_mut, d_eval, d_train, d_mut = jax.device_get(compiled(v, C, z, x))
    want = {"generate_eval": g_eval, "generate_train": g_train,
            "discriminate_eval": d_eval, "discriminate_train": d_train}
    moved = from_jax_variables({"batch_stats": g_mut["batch_stats"],
                                "spectral": d_mut["spectral"]})
    return dict(arch=arch, v=v, C=C, z=z, x=x, want=want, moved=moved, shape=shape)


@pytest.fixture(scope="module", params=list(SHAPES))
def fwd(request):
    """G and D of one tiny CGAN in both packages, in eval and train mode,
    with the state each train-mode call moved."""
    case = _jax_forward(*SHAPES[request.param])
    port = _port(case["arch"], case["v"])
    before = {k: t.clone() for k, t in port.state_dict().items()}
    Ct, zt, xt = (torch.from_numpy(case[k]) for k in ("C", "z", "x"))
    with torch.no_grad():
        got = {"generate_eval": port.generate(Ct, zt),
               "discriminate_eval": port.discriminate(xt, Ct)}
        unmoved = all(torch.equal(t, before[k]) for k, t in port.state_dict().items())
        got["generate_train"] = port.generate(Ct, zt, train=True)
        got["discriminate_train"] = port.discriminate(xt, Ct, train=True)
    return dict(case, got=got, port=port, before=before, eval_unmoved=unmoved)


@pytest.mark.parametrize("name", ["generate_eval", "generate_train", "discriminate_eval",
                                  "discriminate_train"])
def test_cgan_forward_matches_jax(fwd, name):
    want, got = fwd["want"][name], fwd["got"][name].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max(), name


def test_cgan_train_mode_moves_state_as_jax(fwd):
    """Train mode moves G's BatchNorm statistics and every ``u`` of D (the
    embedding's too) as the JAX model's mutated collections hold them; eval
    mode moves nothing."""
    assert fwd["eval_unmoved"]
    after = fwd["port"].state_dict()
    assert any(k.startswith("discriminator.embedding.u") for k in fwd["moved"])
    for k, want in fwd["moved"].items():
        want = want.numpy()
        assert np.abs(after[k].numpy() - want).max() <= FWD_TOL * np.abs(want).max(), k
        if after[k].numel() > 1:
            assert not torch.equal(after[k], fwd["before"][k]), k


def test_cgan_structure(fwd):
    """Dead biases absent (G's Conv_0, and the last block's Conv_1 / Conv_2),
    G's start resolution from the data shape, D's embedding tiled after the
    image channels, and no controller anywhere."""
    model, arch = fwd["port"], fwd["arch"]
    g = model.generator
    blocks = list(g.blocks.values())
    assert all(b.Conv_0.bias is None for b in blocks)
    assert all(b.Conv_1.bias is not None and b.Conv_2.bias is not None for b in blocks[:-1])
    assert blocks[-1].Conv_1.bias is None and blocks[-1].Conv_2.bias is None
    hs = arch["generator_hidden_size"]
    start = fwd["shape"][0] >> (len(hs) - 1)
    assert g.Dense_0.weight.shape == (hs[0] * start * start, 16 + EMB)
    assert g.embedding.bias is None and model.discriminator.embedding.bias is None
    first = model.discriminator.blocks["_CFirstDisResBlock_0"]
    assert first.SNConv_0.weight.shape[1] == fwd["shape"][-1] + EMB
    assert not any(isinstance(m, MultimodalController) for m in model.modules())
    strides = [b.stride for n, b in model.discriminator.blocks.items() if "First" not in n]
    assert strides == ([2, 1, 1] if arch["cifar_style"] else [2, 2, 1])
