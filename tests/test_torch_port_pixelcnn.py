"""CPU parity of the port's PixelCNN family (MCPixelCNN, CPixelCNN) and of
the plain version of its kernel, ``mc_gated_matmul``, against the JAX
package; the samplers, the VQ-VAE's ``encode``, the trainer, the checkpoint,
mode manipulation and the sample CLI on the CPU.

Each JAX model is the JAX tests' own size (``input_size=16, hidden_size=8,
num_layer=3, num_mode=4``, grids 6x6). Its variables are numpy values on
its tree (``jax.eval_shape`` of its init), carried to the port by
``io.jax_import.from_jax_variables``; the port's tree must be that tree. One
JAX function per model runs the eval and train forwards, MCPixelCNN's two
train steps and the JAX incremental sampler, compiled once at a low XLA
optimisation level. Both packages compute in f32. Tolerances:

- the plain ``mc_gated_matmul`` against ``mc_gate(x @ w, ind, cb)`` (the
  Pallas kernel's reference in ``tests/test_pallas.py`` at 0303c43) and the
  same expression with the affine / ReLU epilogue, its gradient against
  ``jax.vjp``, the masked ``Conv`` against the JAX ``Conv(kernel_mask=...)``
  and the models' forwards (loss, logits, the BatchNorm statistics a train
  forward moves): ``rtol=1e-5``, ``atol=1e-5 * max|ref|`` (f32 sums in
  another order; the eval path's BatchNorm runs in the product's epilogue);
- the samplers: equal codes from one generator, and logits within
  ``1e-4 * max|ref|`` of a full forward on the sampled codes (16 layers of
  f32 sums in two orders);
- two clipped Adam steps: losses ``rtol=1e-4``, first-step gradients
  ``rtol=1e-4`` / ``atol=1e-4 * max|grad|`` (but the dead biases before a
  BatchNorm, rounding noise in both), parameters within ``4 lr`` everywhere
  and ``lr / 50`` where the first gradient is clear of noise;
- ``create`` / ``transit``: codebooks bit-equal, embeddings within ``1e-6``.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcgm_tpu import config as jconfig
from mcgm_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from mcgm_tpu.models import manipulate as jmanip
from mcgm_tpu.models.pixelcnn import CPixelCNN as JaxCPixelCNN
from mcgm_tpu.models.pixelcnn import MCPixelCNN as JaxMCPixelCNN
from mcgm_tpu.models.pixelcnn import _horiz_mask, _vert_mask
from mcgm_tpu.models.pixelcnn import sample_codes_incremental as jax_sample_incremental
from mcgm_tpu.models.vqvae import VQVAE as JaxVQVAE
from mcgm_tpu.ops.controller import mc_gate as jax_mc_gate
from mcgm_tpu.ops.layers import Conv as JaxConv
from mcgm_tpu.train import loop as jloop
from mcgm_tpu.train import optim as jopt
from mcgm_tpu.train import state as jstate
from mcgm_tpu_torch import config as pconfig
from mcgm_tpu_torch.cli import sample as cli_sample
from mcgm_tpu_torch.cli import test_model as cli_test_model
from mcgm_tpu_torch.cli import train as cli_train
from mcgm_tpu_torch.data import datasets as pdatasets
from mcgm_tpu_torch.data.datasets import _make_synthetic
from mcgm_tpu_torch.io.checkpoint import to_numpy
from mcgm_tpu_torch.io.images import read_png
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_gan_variables
from mcgm_tpu_torch.kernels import mc_gate as kmc
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.models import manipulate as pmanip
from mcgm_tpu_torch.models.pixelcnn import CPixelCNN, MCPixelCNN, sample_codes
from mcgm_tpu_torch.models.pixelcnn import sample_codes_incremental
from mcgm_tpu_torch.models.vqvae import VQVAE
from mcgm_tpu_torch.ops.layers import Conv
from mcgm_tpu_torch.train import loop as ploop
from mcgm_tpu_torch.train import optim as popt
from mcgm_tpu_torch.train import state as pstate
from test_torch_port_gan import _fill
from test_torch_port_train import _recording, _tree_keys

B, M, G = 6, 4, 6  # batch, modes, grid side
ARCH = dict(input_size=16, hidden_size=8, num_layer=3, num_mode=M)
MODELS = {"mcpixelcnn": (MCPixelCNN, JaxMCPixelCNN), "cpixelcnn": (CPixelCNN, JaxCPixelCNN)}
LR, CLIP = 3e-4, 1.0
OPT = {"optimizer_name": "Adam", "lr": LR, "weight_decay": 0}
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
PX_CFG = {"num_layer": 3, "hidden_size": 8, "num_embedding": 16}
VQ_CFG = {"hidden_size": [8, 8], "num_res_block": 1, "embedding_size": 8, "num_embedding": 16,
          "vq_commit": 0.25}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """One torch thread: with two, the CPU's backward of layer 0's masked
    convolutions summed the embedding's gradient in another order from run
    to run (1e-9 apart), which a bit-equal resume would see."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, rtol=1e-5, atol=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30), err_msg=msg)


# ------------------------------------------------------------ the kernel
def _mc_inputs(rng, Bn=12, K=16, N=24, modes=4, P=None):
    x = rng.standard_normal((Bn, K) if P is None else (Bn, P, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    ind = np.eye(modes, dtype=np.float32)[np.arange(Bn) % modes]
    cb = (rng.random((modes, N)) < 0.5).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, N).astype(np.float32)
    beta = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return x, w, ind, cb, alpha, beta


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))  # a writable, contiguous copy


@pytest.mark.parametrize("relu,affine,P,Bn,K,N", [
    (False, False, None, 12, 16, 24), (True, True, None, 12, 16, 24),
    (False, True, 5, 12, 16, 24),
    # the shapes the card's kernels split on: P = 64 (one product per
    # sample), K 64 with a ragged N, more samples than a batch of codes
    (True, True, 64, 3, 64, 200), (False, True, 64, 19, 16, 24),
    (True, True, None, 70, 64, 100), (False, False, 16, 5, 96, 40),
    # the PixelCNN's own widths: the head (K 128 -> 512) at one position and
    # M = 1, a residual (128 -> 128) over 8 x 8 positions
    (True, True, None, 9, 128, 512), (True, True, None, 1, 128, 512),
    (False, True, 64, 2, 128, 128),
])
def test_mc_gated_matmul_plain_matches_jax(relu, affine, P, Bn, K, N):
    """The Pallas form ``mc_gate(x @ w, ind, cb)``, and the same product
    with the eval BatchNorm's affine (and ReLU) before the gate; with P
    positions per sample the port reads NCHW ``[B, K, P]`` where the JAX
    expression is channels-last ``[B, P, K]``."""
    x, w, ind, cb, alpha, beta = _mc_inputs(np.random.default_rng(1), Bn, K, N, P=P)

    def f(x, w, ind, cb):
        z = x @ w
        if affine:
            z = z * alpha + beta
        return jax_mc_gate(jax.nn.relu(z) if relu else z, ind, cb)

    want = np.asarray(_jax_run(f, x, w, ind, cb))
    xp = _t(x if P is None else x.transpose(0, 2, 1))
    got = kmc.mc_gated_matmul(xp, _t(w.T), _t(alpha) if affine else None,
                              _t(beta) if affine else None, _t(ind), _t(cb), relu).numpy()
    _close(got if P is None else got.transpose(0, 2, 1), want)
    assert kmc.mc_gated_matmul.launches == 0  # CPU tensors: the plain version


def test_mc_gated_matmul_without_gate():
    """``indicator=None``: the affine product alone (CPixelCNN's 1x1s)."""
    x, w, _, _, alpha, beta = _mc_inputs(np.random.default_rng(2))
    got = kmc.mc_gated_matmul(_t(x), _t(w.T), _t(alpha), _t(beta), relu=True).numpy()
    _close(got, np.maximum(x @ w * alpha + beta, 0))


@pytest.mark.parametrize("relu", [False, True])
def test_mc_gated_matmul_gradient_matches_jax_vjp(relu):
    """The autograd Function's backward against ``jax.vjp`` of the same
    expression (the TPU kernel's custom VJP, ``relu=False`` without the
    affine): the mask carries no gradient."""
    x, w, ind, cb, alpha, beta = _mc_inputs(np.random.default_rng(3))
    g = np.random.default_rng(4).standard_normal((x.shape[0], w.shape[1])).astype(np.float32)
    a, b = (alpha, beta) if relu else (None, None)

    def f(x, w):
        z = x @ w
        if relu:
            z = jax.nn.relu(z * alpha + beta)
        return jax_mc_gate(z, jnp.asarray(ind), jnp.asarray(cb))

    jdx, jdw = (np.asarray(v) for v in _jax_run(
        lambda x, w, g: jax.vjp(f, x, w)[1](g), x, w, g))
    xt, wt = _t(x).requires_grad_(), _t(w.T).requires_grad_()
    out = kmc.mc_gated_matmul(xt, wt, None if a is None else _t(a),
                              None if b is None else _t(b), _t(ind), _t(cb), relu)
    out.backward(_t(g))
    _close(xt.grad.numpy(), jdx)
    _close(wt.grad.numpy().T, jdw)


def test_mc_gated_matmul_refuses_what_it_does_not_take():
    x, w, ind, cb, _, _ = _mc_inputs(np.random.default_rng(5))
    with pytest.raises(ValueError, match="want both f32 or bf16"):
        kmc.mc_gated_matmul(_t(x), _t(w.T).double(), indicator=_t(ind), codebook=_t(cb))
    with pytest.raises(ValueError, match="go together"):
        kmc.mc_gated_matmul(_t(x), _t(w.T), indicator=_t(ind))
    with pytest.raises(ValueError, match="contiguous"):
        kmc.mc_gated_matmul(_t(x).t().contiguous().t(), _t(w.T))


@pytest.mark.parametrize("mask_type,vertical", [("A", True), ("A", False), ("B", True)])
def test_masked_conv_matches_jax(mask_type, vertical):
    """The causal convs with their asymmetric padding against the JAX
    ``Conv(kernel_mask=...)``; the stored weight is the unmasked kernel."""
    k = 7 if mask_type == "A" else 3
    rng = np.random.default_rng(6)
    if vertical:
        shape, pad, mask = (k // 2 + 1, k), [(k // 2, 0), (k // 2, k // 2)], _vert_mask(k, mask_type)
    else:
        shape, pad, mask = (1, k // 2 + 1), [(0, 0), (k // 2, 0)], _horiz_mask(k, mask_type)
    x = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)
    kern = rng.standard_normal(shape + (3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    jm = JaxConv(4, shape, 1, padding=pad, kernel_mask=mask)
    want = np.asarray(jm.apply({"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x)))
    conv = Conv(3, 4, shape, padding=tuple(pad), kernel_mask=mask)
    conv.load_state_dict(from_jax_variables({"params": {"kernel": kern, "bias": bias}}))
    got = conv(_t(x.transpose(0, 3, 1, 2))).detach().numpy().transpose(0, 2, 3, 1)
    _close(got, want)
    assert set(conv.state_dict()) == {"weight", "bias"}


# ------------------------------------------------------------- the models
def _jax_run(fn, *args):
    """``fn(*args)`` compiled once at a low XLA optimisation level (the
    compile, not the run, is what costs here)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)(*args)


def _batch(rng):
    return {"img": rng.integers(0, ARCH["input_size"], (B, G, G)).astype(np.int32),
            "label": (np.arange(B) % M).astype(np.int32)}


@pytest.fixture(scope="module")
def built():
    """Per model: the variables, the port model holding them, and the JAX
    outputs (eval and train forwards, the incremental sampler's codes and
    logits, and for MCPixelCNN two train steps) from one compiled call."""
    out = {}
    for i, (name, (pcls, jcls)) in enumerate(MODELS.items()):
        rng = np.random.default_rng(20 + i)
        jm = jcls(**ARCH)
        example = {"img": jnp.zeros((1, G, G), jnp.int32), "label": jnp.zeros((1,), jnp.int32)}
        tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), example, train=True))
        v = _fill(tree, rng)
        port = pcls(**ARCH)
        port.load_state_dict(from_jax_variables(v), strict=True)
        batch = _batch(rng)
        C = np.arange(M, dtype=np.int32)
        def run(v, batch, C):
            ev = jm.apply(v, batch, False)
            codes, logits = jax_sample_incremental(jm, v, C, jax.random.PRNGKey(7), (G, G),
                                                   return_logits=True)
            tr = None if stepping else jm.apply(v, batch, True, mutable=["batch_stats"])
            return ev, tr, (codes, logits)

        stepping = name == "mcpixelcnn"  # its train forward is the step's
        res = dict(zip(("eval", "train", "sampler"), _jax_run(run, v, batch, C)))
        if stepping:
            opt = _recording(jopt.make_optimizer(OPT, grad_clip=CLIP))
            params, state = jstate.split_variables(v)
            ts = jstate.TrainState(params=params, state=state, opt_state=opt.init(params),
                                   rng=jax.random.PRNGKey(0))
            step = jax.jit(jstate.make_train_step(jm, opt)).lower(ts, batch).compile(
                compiler_options=O0)
            ts, aux = step(ts, batch)
            res["train"] = (aux["output"], {"batch_stats": ts.state["batch_stats"]})
            ts, aux2 = step(ts, batch)
            res["steps"] = jax.tree_util.tree_map(np.asarray, (ts, [aux["loss"], aux2["loss"]]))
        out[name] = dict(v=v, port=port, batch=batch,
                         jax=jax.tree_util.tree_map(np.asarray, res))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_tree_is_the_jax_models(built, name):
    """The port's variable tree is the JAX model's, both ways: import then
    export gives the variables back (the causal masks are not variables)."""
    v = built[name]["v"]
    back = to_jax_gan_variables(built[name]["port"])
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, v))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(built, name, train):
    """Loss and logits in eval mode (the gated 1x1s through the kernel's
    plain version with BatchNorm in the epilogue) and in train mode (batch
    statistics), and the running statistics the train forward moves."""
    s = built[name]
    port = s["port"]
    before = {k: t.clone() for k, t in port.state_dict().items()}
    tb = {k: _t(a) for k, a in s["batch"].items()}
    with torch.no_grad():
        got = port(tb, train=train)
    want = s["jax"]["train"][0] if train else s["jax"]["eval"]
    _close(got["logits"].numpy(), want["logits"], msg="logits")
    _close(float(got["loss"]), want["loss"], msg="loss")
    if train:
        stats = from_jax_variables(s["jax"]["train"][1])
        for k, t in stats.items():
            _close(port.state_dict()[k].numpy(), t.numpy(), msg=k)
        port.load_state_dict(before)
    else:
        assert all(torch.equal(t, before[k]) for k, t in port.state_dict().items())


@pytest.mark.parametrize("name", list(MODELS))
def test_causality(built, name):
    """Logits at raster position (i, j) do not see the input at (i, j) or
    after it (``tests/test_pixelcnn.py``'s check), and do see earlier ones."""
    port = built[name]["port"]
    rng = np.random.default_rng(8)
    base = torch.from_numpy(rng.integers(0, 16, (1, G, G)))
    lbl = torch.tensor([1])

    def logits(img):
        with torch.no_grad():
            return port({"img": img, "label": lbl})["logits"][0].numpy()

    ref = logits(base)
    for i, j in [(2, 3), (4, 0), (3, 3)]:
        mod = base.clone()
        mod[0, i, j] = (mod[0, i, j] + 7) % 16
        out = logits(mod)
        for a in range(G):
            for b in range(G):
                if a < i or (a == i and b <= j):
                    np.testing.assert_allclose(out[a, b], ref[a, b], atol=1e-5, err_msg=(a, b))
    mod = base.clone()
    mod[0, 0, 0] = (mod[0, 0, 0] + 7) % 16
    out = logits(mod)
    assert np.abs(out[1, 1] - ref[1, 1]).max() > 1e-9
    assert np.abs(out[G - 1, G - 1] - ref[G - 1, G - 1]).max() > 0


@pytest.mark.parametrize("name", list(MODELS))
def test_incremental_sampler_matches_full_forward(built, name):
    """The port's two samplers draw the same codes from one generator; the
    incremental one's logits are a full forward's on those codes; and the
    port's full forward on the JAX sampler's codes gives the logits the JAX
    sampler returned."""
    port = built[name]["port"]
    C = [0, 1, 2, 3, 1]
    full = sample_codes(port, C, torch.Generator().manual_seed(5), (G, G))
    inc, logits = sample_codes_incremental(port, C, torch.Generator().manual_seed(5), (G, G),
                                           return_logits=True)
    assert inc.dtype == torch.int32 and inc.shape == (5, G, G)
    assert torch.equal(full, inc)
    assert len(torch.unique(inc)) > 3  # the draws are not degenerate
    with torch.no_grad():
        ref = port({"img": inc, "label": torch.tensor(C)})["logits"]
    _close(logits.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    jcodes, jlogits = built[name]["jax"]["sampler"]
    with torch.no_grad():
        ref = port({"img": _t(jcodes), "label": torch.arange(M)})["logits"]
    _close(ref.numpy(), jlogits, rtol=1e-4, atol=1e-4)


def test_train_steps_match_jax(built):
    """Two clipped Adam steps of MCPixelCNN through the generic step: the
    losses, the first step's gradients and the parameters after both (the
    statistics a train forward moves: ``test_forward_matches_jax``)."""
    s = built["mcpixelcnn"]
    port = MCPixelCNN(**ARCH)
    port.load_state_dict(from_jax_variables(s["v"]))
    ts = pstate.TrainState(port, popt.make_optimizer(port.parameters(), OPT, grad_clip=CLIP))
    first = []  # the last layer's gate_v is unused: no gradient (zero in JAX)
    ts.opt.register_step_pre_hook(lambda *_: first.append(
        {n: torch.zeros_like(q) if q.grad is None else q.grad.clone()
         for n, q in port.named_parameters()}) if not first else None)
    tb = {k: _t(a) for k, a in s["batch"].items()}
    step = pstate.make_train_step()
    losses = [float(step(ts, tb)["loss"]) for _ in range(2)]
    jts, jlosses = s["jax"]["steps"]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    jgrads = _tree_keys("x", jts.opt_state[1])
    after = from_jax_variables({"params": jts.params, **jts.state})
    top = max(np.abs(g.numpy()).max() for g in jgrads.values())
    dead = []
    for k, q in port.named_parameters():
        w, g = jgrads[f"x.{k}"].numpy(), first[0][k].numpy()
        diff = np.abs(q.detach().numpy() - after[k].numpy())
        assert diff.max() <= 4 * LR, (k, diff.max() / LR)
        if np.abs(w).max() <= 1e-4 * top:
            assert np.abs(g).max() <= 1e-4 * top, k
            dead.append(k)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
        clear = np.abs(w) > 1e-3 * np.abs(w).max()
        assert diff[clear].max() <= LR / 50, (k, diff[clear].max() / LR)
    last = f"layer_{ARCH['num_layer'] - 1}.gate_v."  # its output feeds nothing
    assert all(k.endswith(".bias") or k.startswith(last) for k in dead), dead


def test_vqvae_encode_matches_jax():
    """The frozen encoder of the PixelCNN's batches: codes equal to the JAX
    ``VQVAE.encode``'s, in eval mode."""
    arch = dict(data_shape=(32, 32, 3), hidden_size=(8, 8), embedding_size=8,
                num_embedding=16, num_res_block=1)
    port = VQVAE(**arch)
    rng = np.random.default_rng(9)
    v = _fill(to_jax_gan_variables(port), rng)
    v["vq_stats"]["quantizer"]["embedding"] = rng.standard_normal((8, 16)).astype(np.float32)
    port.load_state_dict(from_jax_variables(v))
    img = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    _, _, want = _jax_run(lambda v, img: JaxVQVAE(**arch).apply(v, img, method="encode"),
                          v, img)
    with torch.no_grad():
        q, _, code = port.encode(_t(img))
    assert code.dtype == torch.int32 and q.shape == (3, 8, 8, 8)
    np.testing.assert_array_equal(code.numpy(), np.asarray(want))


# ---------------------------------------------------------- manipulation
@functools.lru_cache
def _manipulated(name):
    """A port model with 11 layers (``layer_10`` sorts before ``layer_2``,
    as ``jax.tree_util`` visits them) and its variables."""
    model = MODELS[name][0](**dict(ARCH, num_layer=11), seed=1)
    return model, to_jax_gan_variables(model)


@pytest.mark.parametrize("torch_compat", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_create_and_transit_match_jax(built, name, torch_compat):
    """``create`` in both streams (the reference's torch stream visits the
    layers in order, then the head) and ``transit``, on the port model's
    state and on the same variables in the JAX package: codebooks and
    CPixelCNN's ``class_cond_embedding`` tables."""
    model, variables = _manipulated(name)

    def check(got, want):
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, want))
        assert set(got) == set(want)
        changed = 0
        for k, w in want.items():
            if k.endswith("codebook"):
                assert torch.equal(got[k], w), k
                changed += 1
            elif k.endswith("class_cond_embedding.weight"):
                assert got[k].shape == w.shape and (got[k] - w).abs().max() <= 1e-6, k
                changed += 1
            else:
                assert torch.equal(got[k], w) and torch.equal(got[k], model.state_dict()[k]), k
        assert changed == (11 * 3 + 1 if name == "mcpixelcnn" else 11)

    check(pmanip.create(model, 7, rng_seed=5, torch_compat=torch_compat, model_name=name),
          jmanip.create(variables, 7, rng_seed=5, torch_compat=torch_compat, model_name=name))
    alpha = 0.375 if torch_compat else 0.8
    check(pmanip.transit(model, 1, alpha), jmanip.transit(variables, 1, alpha))


# ---------------------------------------------------------------- trainer
@pytest.mark.parametrize("name", list(MODELS))
def test_config_matches_jax(name):
    """``process_control`` and the trainer's overrides (Adam 3e-4, clip 1,
    ReduceLROnPlateau on NLL, min) equal the JAX package's; the factory
    builds the model, on the card unless asked for the CPU."""
    base = dict(jconfig.load_config(), data_name="CIFAR10", model_name=name)
    ctrl = "0.5" if name == "mcpixelcnn" else "None"
    p = ploop.apply_family_overrides(pconfig.process_control(
        pconfig.apply_control_name(base, ctrl)))
    j = jloop.apply_family_overrides(jconfig.process_control(
        jconfig.apply_control_name(base, ctrl)))
    assert p == j
    assert p["pixelcnn"] == {"num_layer": 15, "hidden_size": 128, "num_embedding": 512}
    assert (p["pivot_metric"], p["scheduler_name"], p["lr"], p["grad_clip"]) == (
        "NLL", "ReduceLROnPlateau", 3e-4, 1.0)
    p["classes_size"] = 10
    assert isinstance(build_model(p, "cpu"), MODELS[name][0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(p)


def _argv(tmp, name, *extra):
    return ["--data_name", "Synthetic", "--model_name", name, "--control_name",
            "0.5" if name == "mcpixelcnn" else "None", "--device", "cpu",
            "--output_dir", str(tmp), *extra]


COMMON = dict(derive_model_params=False, pixelcnn=PX_CFG, vqvae=VQ_CFG,
              derive_batch_size=False, batch_size={"train": 64, "test": 64},
              limit_train_batches=2, log_interval=1.0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Without a VQ-VAE the PixelCNN trainer raises. Then a tiny VQ-VAE (1
    epoch, its checkpoints copied to a second folder) and MCPixelCNN: 2
    epochs of 2 steps through
    ``cli.train``; 1 epoch, then ``resume_mode=1`` to epoch 2 (another
    folder); ``cli.test_model`` on the first run's ``_best``."""
    tmp = tmp_path_factory.mktemp("pixelcnn")
    with pytest.MonkeyPatch.context() as mp:  # one draw of the synthetic data
        mp.setattr(pdatasets, "_make_synthetic", functools.lru_cache(_make_synthetic))
        with pytest.raises(FileNotFoundError, match="0_Synthetic_label_vqvae_best"):
            cli_train.main(_argv(tmp / "full", "mcpixelcnn", "--num_epochs", "1"), **COMMON)
        cli_train.main(_argv(tmp / "full", "vqvae", "--num_epochs", "1"), **COMMON)
        shutil.copytree(tmp / "full" / "model", tmp / "split" / "model")
        (full,) = cli_train.main(_argv(tmp / "full", "mcpixelcnn", "--num_epochs", "2"),
                                 **COMMON)
        cli_train.main(_argv(tmp / "split", "mcpixelcnn", "--num_epochs", "1"), **COMMON)
        (split,) = cli_train.main(_argv(tmp / "split", "mcpixelcnn", "--num_epochs", "2",
                                        "--resume_mode", "1"), **COMMON)
        (tested,) = cli_test_model.main(_argv(tmp / "full", "mcpixelcnn"), **COMMON)
    return dict(tmp=tmp, full=full, split=split, tested=tested)


def test_resume_is_bit_equal(runs):
    """Mode 1 from the epoch-1 checkpoint ends where the uninterrupted run
    ends: weights, BatchNorm statistics, Adam's state, the scheduler and
    the logger's history; NLL each epoch, re-evaluated by ``cli.test_model``."""
    full, split = runs["full"], runs["split"]
    assert split.resumed["epoch"] == 2 and [s["epoch"] for s in split.epoch_stats] == [2]
    a, b = to_numpy(full.state_dict()), to_numpy(split.state_dict())
    for k in ("model_dict", "optimizer_dict", "scheduler_dict"):
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, a[k], b[k])), k
    hist = full.logger.history
    assert dict(hist) == dict(split.logger.history)
    assert all(len(hist[f"{s}/NLL"]) == 2 and np.isfinite(hist[f"{s}/NLL"]).all()
               for s in ("train", "test"))
    assert full.epoch_stats[-1]["eval_images"] == 1024  # the whole train split
    np.testing.assert_allclose(runs["tested"].history["test/NLL"],
                               min(hist["test/NLL"]), rtol=1e-6)


def test_checkpoint_read_by_jax(runs, built):
    """The JAX package's ``load_checkpoint`` reads the port's PixelCNN
    checkpoint: the JAX model's variable tree (``built`` holds the port's
    tree to the JAX model's own)."""
    exp = runs["full"]
    ckpt = jax_load_checkpoint(exp.cfg, exp.tag, "best")
    want = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), to_jax_gan_variables(exp.model))
    got = jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), ckpt["model_dict"])
    assert got == want
    assert set(ckpt["model_dict"]) == {"params", "batch_stats", "codebook"}
    assert ckpt["epoch"] == 3


@pytest.mark.parametrize("workflow", ["generate", "transit"])
def test_sample_cli_on_the_cpu(runs, workflow):
    """``cli.sample`` from the trained MCPixelCNN's ``_best`` and its
    VQ-VAE's: codes drawn by the incremental sampler, decoded; every PNG
    read back (10 modes x 2 rows; transit 3 alphas x 10 modes)."""
    out = runs["tmp"] / "full"
    prefix = {"generate": "generated", "transit": "transited"}[workflow]
    cli_sample.main(workflow, _argv(out, "mcpixelcnn", "--save_per_mode", "2"), **COMMON)
    vis = [f for f in sorted(os.listdir(out / "vis")) if f.startswith(prefix)]
    assert vis == [f"{prefix}_0_Synthetic_label_mcpixelcnn_0.5_10.png"]
    rows = 2 if workflow == "generate" else 3
    assert read_png(str(out / "vis" / vis[0])).shape == (2 + rows * 34, 2 + 10 * 34, 3)
