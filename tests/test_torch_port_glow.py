"""CPU parity of the port's Glow family (MCGlow, CGlow) against the JAX
package, and its trainer, checkpoints, mode manipulation, workflows and
CLIs on the CPU.

Each tiny model (16x16x3, hidden 16, K 2, L 2, 4 modes, the scanned
layout) takes its variables from numpy values on the port model's tree,
imported from the JAX layout, so both packages compute from the same
weights in f32. Per model one function is compiled at a low XLA
optimisation level: the flow-0 modules, the eval forward, ``reverse`` of
its z, ``generate`` from given z, the DDI forward and two clipped Adam
steps with the 16-step warmup (``noise`` drawn inside: the dequantisation
uniform is one numpy draw, handed to the port as ``noise`` and to the JAX
model in place of its ``jax.random.uniform``), and ``jax.grad`` of the
coupling net's conv1x1 -> ActNorm -> ReLU -> MC. Tolerances, and why:

- forward losses ``rtol=1e-4``; z, logdets, log-likelihoods, the modules'
  outputs, ``generate`` and the reconstruction ``rtol=1e-4``, ``atol=1e-5
  * max|ref|`` (f32, summation order only; the invconv's inverse in f32);
- ``reverse(forward(x))`` against ``x`` within ``1e-4`` (four f32 flows
  and their f32 inverses; the JAX package's own invconv round trip is held
  to ``1e-4``);
- DDI parameters ``rtol=1e-4`` (a std over 8x8 positions);
- the steps' first gradients ``rtol=1e-4``, ``atol=1e-4 * max|grad|``
  per tensor; parameters after two steps within ``lr`` everywhere and
  within ``lr / 100`` where the gradient exceeds ``1e-4`` of its tensor's
  largest; the gated 1x1's ``dx``, ``dw``, ``dalpha`` / ``dbeta`` (through
  ActNorm's scale and loc and the conv's bias) ``rtol=1e-4``, ``atol=1e-5 *
  max``;
- import / export and the checkpoints: bit-equal; ``create`` and
  ``transit``: codebooks bit-equal, the mixed embedding within ``1e-6``;
- the trainer's resume: bit-equal.
"""

import concurrent.futures
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
from mcgm_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from mcgm_tpu.models import glow as jglow
from mcgm_tpu.models import manipulate as jmanip
from mcgm_tpu.train import loop as jloop
from mcgm_tpu.train import optim as jopt
from mcgm_tpu.train import state as jstate
from mcgm_tpu_torch import config as pconfig
from mcgm_tpu_torch.cli import sample as cli_sample
from mcgm_tpu_torch.cli import test_model as cli_test_model
from mcgm_tpu_torch.cli import train as cli_train
from mcgm_tpu_torch.data import datasets as pdatasets
from mcgm_tpu_torch.data.datasets import _make_synthetic
from mcgm_tpu_torch.io.checkpoint import load_model_dict, save_checkpoint, to_numpy
from mcgm_tpu_torch.io.images import read_png
from mcgm_tpu_torch.io.jax_import import (detect_glow_scan_chunk, from_jax_variables,
                                          rechunk_glow_flows, to_jax_gan_variables)
from mcgm_tpu_torch.kernels.mc_gate import mc_gated_matmul
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.models import glow as pglow
from mcgm_tpu_torch.models import manipulate as pmanip
from mcgm_tpu_torch.train import loop as ploop
from mcgm_tpu_torch.train import optim as popt
from mcgm_tpu_torch.train import state as pstate
from mcgm_tpu_torch.utils import ckpt_path
from mcgm_tpu_torch.workflows.create import keep_finite_per_mode
from test_torch_port_train import _recording

B, M, SHAPE, HID, K, L = 6, 4, (16, 16, 3), 16, 2, 2
LR, CLIP, WARMUP = 3e-4, 1.0, 16
OPT = {"optimizer_name": "Adam", "lr": LR, "weight_decay": 0, "lr_warmup_steps": WARMUP}
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
MODELS = {"mcglow": (pglow.MCGlow, jglow.MCGlow, {"controller_rate": 0.5}),
          "cglow": (pglow.CGlow, jglow.CGlow, {})}
DDI_B = 12  # the DDI batch (the trainer concatenates 8 train batches)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30), err_msg=msg)


def _port(name, **kw):
    pcls, _, extra = MODELS[name]
    return pcls(SHAPE, HID, K, L, num_mode=M, **extra, **kw)


def _jax(name, **kw):
    """The JAX model, scanned as the JAX package's factory builds it."""
    _, jcls, extra = MODELS[name]
    return jcls(SHAPE, HID, K, L, True, True, M, **extra, **{"scan_flows": True, **kw})


def _fill(tree, rng, path=()):
    """Values for a Glow's variable tree: every weight nonzero (the zero
    convs too, so the coupling nets reach the output), ActNorm scales in
    [0.5, 1.5]; codebooks and the invconv's constants as the port drew them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng, path + (k,))
            continue
        if path[0] in ("codebook", "glow_const"):
            out[k] = v
            continue
        if k == "kernel":
            a = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[-4:-1]))
        elif k == "scale" and (path[-1].startswith("ActNorm") or path[-1] == "actnorm"):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:  # bias, loc, w_l, w_s, w_u, a zero conv's scale
            a = 0.1 * rng.standard_normal(v.shape)
        out[k] = np.asarray(a, np.float32)
    return out


@contextlib.contextmanager
def _jax_uniform_is(draws: dict):
    """While the JAX function is traced, ``jax.random.uniform`` of a shape
    in ``draws`` (the dequantisation noise) returns that array."""
    real = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, *args, **kwargs):
        if tuple(shape) in draws:
            return jnp.asarray(draws[tuple(shape)], dtype)
        return real(key, shape, dtype, *args, **kwargs)

    jax.random.uniform = uniform
    try:
        yield
    finally:
        jax.random.uniform = real


def _flow0(tree):
    """Block 0's first flow, out of the scanned tree."""
    return {coll: jax.tree_util.tree_map(lambda a: a[0], t["block_0"]["flows"]["flow"])
            for coll, t in tree.items()}


def _jax_parts(m, img, label, noise):
    """The JAX forward's pieces: per-sample logdet and log p, and z."""
    ind = jax.nn.one_hot(label, M)
    x = img * 0.5 + noise / 256.0
    logdet, log_p, zs = jnp.zeros(()), jnp.zeros((img.shape[0],)), []
    for block in m.blocks:
        x, det, lp, z = block(x, ind)
        logdet, log_p = logdet + det, log_p + lp
        zs.append(z)
    return logdet, log_p, zs


def _inputs(rng) -> dict:
    """The numpy inputs both models see."""
    return dict(
        img=rng.uniform(-1, 1, (B, *SHAPE)).astype(np.float32),
        label=(np.arange(B) % M).astype(np.int32),
        noise=rng.uniform(0, 1, (B, *SHAPE)).astype(np.float32),
        big=rng.uniform(-1, 1, (DDI_B, *SHAPE)).astype(np.float32),
        big_label=(np.arange(DDI_B) % M).astype(np.int32),
        big_noise=rng.uniform(0, 1, (DDI_B, *SHAPE)).astype(np.float32),
        z=[0.1 * rng.standard_normal((B, *s)).astype(np.float32)  # tempered: a random
           for s in _port("cglow").make_z_shapes()],              # Glow blows up
        fx=rng.standard_normal((B, 8, 8, 12)).astype(np.float32),  # flow 0's input
        h=rng.uniform(0, 1, (B, 8, 8, HID)).astype(np.float32),  # the 1x1's input
        r=rng.standard_normal((B, 8, 8, HID)).astype(np.float32))


def _jax_run(name, v):
    """The JAX side of every parity case of one model: traceable functions
    of its variables and the inputs, each returning part of the results."""
    mc = name == "mcglow"
    jm = _jax(name, remat_flows=False)  # the same math, a smaller program
    opt = _recording(jopt.make_optimizer(OPT, grad_clip=CLIP))
    step = jstate.make_train_step(jm, opt, rng_streams=("noise",), skip_nonfinite=True)
    f0 = _flow0(v)
    flow = jglow.Flow(12, HID, True, True, M if mc else None, 0.5 if mc else None)
    netv = {c: t["coupling"]["net"] for c, t in f0.items() if "coupling" in t}

    jrev = _jax(name, reversible_flows=True)

    def steps(v, d):  # DDI, the steps and the reversible gradient: MCGlow's
        params, state = jstate.split_variables(v)
        batch = {"img": d["img"], "label": d["label"]}
        rev = jax.grad(lambda p: jrev.apply({**state, "params": p}, batch, train=True,
                                            rngs={"noise": jax.random.PRNGKey(3)})["loss"])(params)
        _, mut = jm.apply(v, {"img": d["big"], "label": d["big_label"]}, train=True,
                          ddi=True, rngs={"noise": jax.random.PRNGKey(1)}, mutable=["params"])
        ts = jstate.TrainState(params=params, state=state, opt_state=opt.init(params),
                               rng=jax.random.PRNGKey(2))
        ts, aux = jax.lax.scan(lambda t, _: step(t, {"img": d["img"], "label": d["label"]}),
                               ts, None, length=2)
        return {"ddi": mut["params"], "steps": (aux["loss"], ts.params, ts.opt_state[1]),
                "rev_grad": rev}

    def run(v, d):
        ind = jax.nn.one_hot(d["label"], M)
        fx = d["fx"]
        logdet, log_p, zs = jm.apply(v, d["img"], d["label"], d["noise"], method=_jax_parts)
        res = {"loss": jm.apply(v, log_p, logdet, False, method="loss_fn"), "z": zs,
               "logdet": logdet, "log_p": log_p}
        res["recon"] = jm.apply(v, zs, d["label"], True, method="reverse")
        res["gen"] = jm.apply(v, d["label"], d["z"], method="generate")
        res["squeeze"] = jglow.squeeze2(fx)
        res["mods"] = {
            "actnorm": flow.apply(f0, fx, method=lambda m, x: m.actnorm(x)),
            "actnorm_ddi": flow.apply(f0, fx, method=lambda m, x: m.actnorm(x, ddi=True),
                                      mutable=["params"]),
            "invconv": flow.apply(f0, fx, method=lambda m, x: m.invconv(x)),
            "invconv_rev": flow.apply(f0, fx, method=lambda m, x: m.invconv(x, reverse=True)),
            "zeroconv": jglow.ZeroConv2d(12).apply({"params": netv["params"]["ZeroConv2d_0"]},
                                                   d["h"]),
            "net": jglow._CouplingNet(12, HID, M if mc else None, 0.5 if mc else None)
            .apply(netv, fx[..., :6], ind),
            "flow": flow.apply(f0, fx, ind),
            "flow_rev": flow.apply(f0, fx, ind, method="reverse"),
        }

        def gated(kernel, bias, loc, scale, h):  # conv1x1 -> ActNorm -> ReLU -> MC
            y = jnp.maximum(scale * (h @ kernel[0, 0] + bias + loc), 0.0)
            if mc:
                code = ind @ netv["codebook"]["MultimodalController_1"]["codebook"]
                y = y * code[:, None, None, :]
            return jnp.sum(y * d["r"])

        p1 = netv["params"]
        res["grad"] = jax.grad(gated, argnums=(0, 1, 2, 3, 4))(
            p1["Conv_1"]["kernel"], p1["Conv_1"]["bias"], p1["ActNorm_1"]["loc"],
            p1["ActNorm_1"]["scale"], d["h"])
        return res

    return [steps, run] if mc else [run]


@pytest.fixture(scope="module")
def parity():
    """Per model: the port model and the JAX results from the same
    variables and inputs. Each program compiles on a thread while the next
    one is traced."""
    d = _inputs(np.random.default_rng(30))
    ports, vs, res, jobs = {}, {}, {}, []
    with concurrent.futures.ThreadPoolExecutor(2) as pool, _jax_uniform_is(
            {(B, *SHAPE): d["noise"], (DDI_B, *SHAPE): d["big_noise"]}):
        for i, name in enumerate(MODELS):
            ports[name] = _port(name, seed=i)
            vs[name] = _fill(to_jax_gan_variables(ports[name]), np.random.default_rng(40 + i))
            ports[name].load_state_dict(from_jax_variables(vs[name]), strict=True)
            for fn in _jax_run(name, vs[name]):
                lowered = jax.jit(fn).lower(vs[name], d)
                jobs.append((name, pool.submit(lowered.compile, compiler_options=O0)))
        for name, job in jobs:
            res.setdefault(name, {}).update(jax.tree_util.tree_map(
                np.asarray, job.result()(vs[name], d)))
    return {name: dict(port=ports[name], v=vs[name], d=d, jax=res[name]) for name in MODELS}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ---------------------------------------------------------------- modules
def test_squeeze_keeps_the_jax_channel_order(parity):
    x = parity["cglow"]["d"]["fx"]
    sq = pglow.squeeze2(_nchw(x))
    np.testing.assert_array_equal(_nhwc(sq), parity["cglow"]["jax"]["squeeze"])
    np.testing.assert_array_equal(pglow.unsqueeze2(sq).numpy(), _nchw(x).numpy())


@pytest.mark.parametrize("name", list(MODELS))
def test_flow_modules_match_jax(parity, name):
    """Block 0's first flow, piece by piece: ActNorm and its DDI (loc, scale,
    output, logdet), the LU invconv forward, logdet and reverse, a zero
    conv, the coupling net (MC or C) and the whole flow both ways."""
    s = parity[name]
    flow, x, mods = s["port"].block_0.flow_0, _nchw(s["d"]["fx"]), s["jax"]["mods"]
    ind = torch.nn.functional.one_hot(_t(s["d"]["label"]).long(), M).float()
    with torch.no_grad():
        out, det = flow.actnorm(x)
        _close(_nhwc(out), mods["actnorm"][0])
        _close(det, mods["actnorm"][1])
        out, det = flow.invconv(x)
        _close(_nhwc(out), mods["invconv"][0])
        _close(det, mods["invconv"][1])
        _close(_nhwc(flow.invconv.reverse(x)), mods["invconv_rev"])
        zc = flow.coupling.net.ZeroConv2d_0(_nchw(s["d"]["h"]), torch.float32)
        _close(_nhwc(zc), mods["zeroconv"])
        net = flow.coupling.net(x[:, :6], ind, torch.float32)
        _close(_nhwc(net), mods["net"])
        out, det = flow(x, ind, torch.float32)
        _close(_nhwc(out), mods["flow"][0])
        _close(det, mods["flow"][1])
        _close(_nhwc(flow.reverse(x, ind, torch.float32)), mods["flow_rev"])
        an = pglow.ActNorm(12)
        out, det = an(x, ddi=True)
        (jout, jdet), jmut = mods["actnorm_ddi"]
        _close(_nhwc(out), jout)
        _close(det, jdet)
        _close(an.loc, jmut["params"]["actnorm"]["loc"])
        _close(an.scale, jmut["params"]["actnorm"]["scale"])


@pytest.mark.parametrize("name", list(MODELS))
def test_gated_1x1_backward_matches_jax_grad(parity, name):
    """The widened ``mc_gated_matmul`` backward: ``dx``, ``dw`` and, through
    ``alpha = scale`` and ``beta = scale * (bias + loc)``, ActNorm's and the
    conv's gradients, against ``jax.grad`` of conv1x1 -> ActNorm -> ReLU ->
    MC."""
    s = parity[name]
    net = s["port"].block_0.flow_0.coupling.net
    conv, an = net.Conv_1, net.ActNorm_1
    w = conv.weight.detach().reshape(HID, HID).clone().requires_grad_()
    bias, loc, scale = (t.detach().clone().requires_grad_() for t in (conv.bias, an.loc,
                                                                       an.scale))
    h = _nchw(s["d"]["h"]).contiguous().reshape(B, HID, 64).requires_grad_()
    ind = torch.nn.functional.one_hot(_t(s["d"]["label"]).long(), M).float()
    cb = net.MultimodalController_1.codebook if name == "mcglow" else None
    out = mc_gated_matmul(h, w, scale, scale * (bias + loc), ind if cb is not None else None,
                          cb, True)
    (out * _nchw(s["d"]["r"]).reshape(B, HID, 64)).sum().backward()
    dk, db, dloc, dscale, dh = s["jax"]["grad"]
    _close(w.grad.T, dk[0, 0], msg="dw")
    _close(bias.grad, db, msg="dbias")
    _close(loc.grad, dloc, msg="dloc")
    _close(scale.grad, dscale, msg="dscale")
    _close(h.grad.reshape(B, HID, 8, 8).permute(0, 2, 3, 1), dh, msg="dx")


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(parity, name):
    """The eval loss (bits/dim), the per-level z, and each sample's logdet
    and log p."""
    s = parity[name]
    d, j = s["d"], s["jax"]
    batch = {"img": _t(d["img"]), "label": _t(d["label"])}
    with torch.no_grad():
        out = s["port"](batch, noise=_t(d["noise"]))
    np.testing.assert_allclose(float(out["loss"]), float(j["loss"]), rtol=1e-4)
    for got, want in zip(out["z"], j["z"], strict=True):
        _close(got, want)
    x = _nchw(d["img"] * 0.5 + d["noise"] / 256.0)
    ind = torch.nn.functional.one_hot(_t(d["label"]).long(), M).float()
    logdet, log_p = 0.0, 0.0
    with torch.no_grad():
        for block in s["port"].blocks():
            x, det, lp, _ = block(x, ind, torch.float32)
            logdet, log_p = logdet + det, log_p + lp
    _close(logdet, j["logdet"])
    _close(log_p, j["log_p"])


@pytest.mark.parametrize("name", list(MODELS))
def test_reverse_and_generate_match_jax(parity, name):
    """``reverse(forward(x), reconstruct=True)`` gives ``x`` back (both
    packages), and ``generate`` from the same z."""
    s = parity[name]
    d, j, port = s["d"], s["jax"], s["port"]
    with torch.no_grad():
        z = port({"img": _t(d["img"]), "label": _t(d["label"])}, noise=_t(d["noise"]))["z"]
        recon = port.reverse(z, _t(d["label"]), reconstruct=True)
    x = np.clip(d["img"] * 0.5 + d["noise"] / 256.0, -0.5, 0.5) * 2.0
    assert np.abs(recon.numpy() - x).max() <= 1e-4
    assert np.abs(j["recon"] - x).max() <= 1e-4
    gen = port.generate(_t(d["label"]), [_t(a) for a in d["z"]])
    assert gen.shape == (B, *SHAPE)
    _close(gen, j["gen"])


@pytest.mark.parametrize("affine,conv_lu", [(True, False), (False, True)])
def test_other_flow_options_invert(affine, conv_lu):
    """``conv_lu=False`` (the plain invconv, its logdet by ``slogdet``) and
    ``affine=False`` (the additive coupling): ``reverse(forward(x))`` gives
    x back within ``1e-4``; the plain invconv's forward, logdet and reverse
    match the JAX module's on the same weight."""
    port = pglow.MCGlow(SHAPE, 8, K, L, affine, conv_lu, M, 0.5, seed=3)
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (B, *SHAPE)).astype(np.float32)
    noise = rng.uniform(0, 1, (B, *SHAPE)).astype(np.float32)
    label = _t((np.arange(B) % M).astype(np.int64))
    with torch.no_grad():
        z = port({"img": _t(img), "label": label}, noise=_t(noise))["z"]
        recon = port.reverse(z, label, reconstruct=True)
    x = np.clip(img * 0.5 + noise / 256.0, -0.5, 0.5) * 2.0
    assert np.abs(recon.numpy() - x).max() <= 1e-4
    if conv_lu:
        return
    ic = port.block_0.flow_0.invconv
    fx = rng.standard_normal((B, 8, 8, 12)).astype(np.float32)
    v = {"params": {"weight": ic.weight.detach().numpy()}}
    jout, jdet = jglow.InvConv2d(12).apply(v, fx)
    with torch.no_grad():
        out, det = ic(_nchw(fx))
        _close(_nhwc(out), jout)
        _close(det, jdet)
        _close(_nhwc(ic.reverse(_nchw(fx))), jglow.InvConv2d(12).apply(v, fx, reverse=True))


def test_loss_rules():
    """Non-finite rows: zeroed in the train mean, dropped in eval and with
    the padding mask; all of them dropped gives NaN."""
    model = _port("cglow")
    n = float(np.prod(SHAPE))
    lp = torch.tensor([-3000.0, float("nan"), -2000.0, float("inf")])
    logdet = torch.zeros(4)
    per = (-(-np.log(256.0) * n + lp) / (np.log(2.0) * n)).numpy()
    ok = per[[0, 2]]
    np.testing.assert_allclose(float(model.loss_fn(lp, logdet, True)), ok.sum() / 4, rtol=1e-6)
    np.testing.assert_allclose(float(model.loss_fn(lp, logdet, False)), ok.mean(), rtol=1e-6)
    w = torch.tensor([1.0, 1.0, 0.0, 1.0])
    np.testing.assert_allclose(float(model.loss_fn(lp, logdet, True, w)), ok[0], rtol=1e-6)
    assert np.isnan(float(model.loss_fn(torch.full((3,), float("nan")), torch.zeros(3), False)))
    assert np.isnan(float(model.loss_fn(lp, logdet, False, torch.zeros(4))))


def test_ddi_matches_jax(parity):
    """The data-dependent init sets every ActNorm (the flows' and the
    coupling nets') as the JAX ``ddi`` forward does (MCGlow; CGlow's
    ActNorms are the same modules)."""
    name = "mcglow"
    s = parity[name]
    port = _port(name)
    port.load_state_dict(s["port"].state_dict())
    d = s["d"]
    with torch.no_grad():
        port({"img": _t(d["big"]), "label": _t(d["big_label"])}, train=True, ddi=True,
             noise=_t(d["big_noise"]))
    want = from_jax_variables({"params": s["jax"]["ddi"]})
    moved = [k for k in want if k.endswith((".loc", ".scale")) and "ActNorm" in k or
             ".actnorm." in k]
    assert len(moved) == 2 * L * K * 3
    state = port.state_dict()
    for k in moved:
        _close(state[k], want[k], msg=k)


def test_two_steps_match_jax(parity):
    """Two clipped Adam steps of MCGlow with the 16-step warmup (train
    forward with ``remat_flows``, the coupling nets' 1x1 through
    ``mc_gated_matmul``'s autograd): the losses, the first gradients, every
    parameter after."""
    name = "mcglow"
    s = parity[name]
    port = _port(name)
    port.load_state_dict(s["port"].state_dict())
    d, (losses, params, grads) = s["d"], s["jax"]["steps"]
    ts = pstate.TrainState(port, popt.make_optimizer(port.parameters(), OPT, grad_clip=CLIP))
    first = []
    ts.opt.register_step_pre_hook(lambda *_: first.append(
        {n: q.grad.clone() for n, q in port.named_parameters()}))
    step = pstate.make_train_step(skip_nonfinite=True)
    batch = {"img": _t(d["img"]), "label": _t(d["label"])}
    aux = [step(ts, batch, noise=_t(d["noise"])) for _ in range(2)]
    np.testing.assert_allclose([float(a["loss"]) for a in aux], losses, rtol=1e-4)
    assert [float(a["skipped"]) for a in aux] == [0.0, 0.0]
    jgrads = from_jax_variables({"params": grads})
    after = from_jax_variables({"params": params})
    for k, p in port.named_parameters():
        w, g = jgrads[k].numpy(), first[0][k].numpy()
        if not np.abs(w).any():  # the last prior's kernel: a conv of zeros
            assert not np.abs(g).any(), k
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
        diff = np.abs(p.detach().numpy() - after[k].numpy())
        assert diff.max() <= LR, (k, diff.max() / LR)
        clear = np.abs(w) > 1e-4 * np.abs(w).max()
        assert diff[clear].max() <= LR / 100, (k, diff[clear].max() / LR)


def test_reversible_gradients_match_jax(parity):
    """MCGlow's train loss through the reversible backward (every flow's
    input rebuilt from its output; the gated 1x1's ``alpha`` / ``beta``
    through ``mc_gated_matmul``'s own backward) against ``jax.grad``
    through the JAX Glow with ``reversible_flows=True``: every gradient at
    f32 tolerance, ``rtol=1e-4``, ``atol=1e-4 * max|grad|``."""
    s = parity["mcglow"]
    port = _port("mcglow", reversible_flows=True)
    port.load_state_dict(s["port"].state_dict())
    d = s["d"]
    out = port({"img": _t(d["img"]), "label": _t(d["label"])}, train=True,
               noise=_t(d["noise"]))
    out["loss"].backward()
    want = from_jax_variables({"params": s["jax"]["rev_grad"]})
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == set(want)
    for k, p in port.named_parameters():
        w = want[k].numpy()
        if not np.abs(w).any():  # the last prior's kernel: a conv of zeros
            assert not p.grad.abs().any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)


def _nonzero_glow(name, seed, **kw):
    """A tiny Glow whose zero convs hold small random weights, so that every
    coupling net reaches the loss."""
    model = pglow.MCGlow(SHAPE, 8, K, L, num_mode=M, seed=seed, **kw) if name == "mcglow" \
        else pglow.CGlow(SHAPE, 8, K, L, num_mode=M, seed=seed, **kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "ZeroConv2d" in n or "prior" in n or "embedding" in n:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return model


@pytest.mark.parametrize("affine,conv_lu", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("name", list(MODELS))
def test_reversible_equals_remat_flows(name, affine, conv_lu):
    """Port against port: the reversible backward gives the ``remat_flows``
    step's loss and gradients (f32, ``rtol=1e-4``, ``atol=1e-5 * max``), for
    the affine and additive couplings and both invconvs; ``RECONSTRUCTED``
    holds each flow's rebuilt input, equal to the one the forward saw."""
    from mcgm_tpu_torch.ops import reversible as prev

    rng = np.random.default_rng(8)
    batch = {"img": _t(rng.uniform(-1, 1, (B, *SHAPE)).astype(np.float32)),
             "label": _t((np.arange(B) % M).astype(np.int64))}
    noise = _t(rng.uniform(0, 1, (B, *SHAPE)).astype(np.float32))
    res = []
    for rev in (False, True):
        model = _nonzero_glow(name, 5, affine=affine, conv_lu=conv_lu, reversible_flows=rev,
                              remat_flows=not rev)
        seen = []
        if rev:
            hooks = [f.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach().clone()))
                     for f in model.block_0.flows()]
            prev.RECONSTRUCTED = []
        try:
            out = model(batch, train=True, noise=noise)
            out["loss"].backward()
            rebuilt = prev.RECONSTRUCTED
        finally:
            prev.RECONSTRUCTED = None
        if rev:
            for h in hooks:
                h.remove()
            block0 = [x for k, x in rebuilt[-K:]]  # block 0 runs its backward last
            for x_in, x_re in zip(seen[:K], block0[::-1]):
                assert (x_in - x_re).abs().max() <= 1e-4 * x_in.abs().max()
        res.append((out["loss"].detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = res
    np.testing.assert_allclose(float(lb), float(la), rtol=1e-6)
    assert set(ga) == set(gb)
    for k, w in ga.items():
        _close(gb[k], w.numpy(), rtol=1e-4, atol=1e-5, msg=k)


def test_reversible_flows_keeps_the_jax_errors():
    """``reversible_flows`` needs the scanned layout with ``scan_chunk=1``
    and no pipeline axis, as in the JAX package (``ValueError``s)."""
    with pytest.raises(ValueError, match="scan_flows=True with scan_chunk=1"):
        _port("mcglow", reversible_flows=True, scan_flows=False)
    with pytest.raises(ValueError, match="scan_flows=True with scan_chunk=1"):
        _port("mcglow", reversible_flows=True, scan_chunk=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port("cglow", reversible_flows=True, pipe_axis="pipe")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ploop.Experiment(dict(pconfig.load_config(), data_name="Synthetic", model_name="mcglow",
                              device="cpu", reversible_flows=True, pipe_size=2))


# --------------------------------------------------------- import, export
def _shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(a.shape)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("layout", [{"scan_flows": True}, {"scan_flows": False},
                                    {"scan_flows": True, "scan_chunk": 2}])
def test_export_layouts_match_jax(layout):
    """The port's export in each layout has the JAX model's tree (the
    scanned one's from ``jax.eval_shape`` of its init; the unscanned and
    chunked ones from the JAX package's own repacking where it has one),
    and importing any layout gives the model back exactly."""
    port = _port("mcglow", seed=3, **layout)
    tree = to_jax_gan_variables(port)
    if layout.get("scan_chunk", 1) > 1:
        want = jglow.rechunk_glow_flows(to_jax_gan_variables(_port("mcglow", seed=3)), 2)
    else:
        jm = _jax("mcglow", **layout)
        batch = {"img": jnp.zeros((1, *SHAPE)), "label": jnp.zeros((1,), jnp.int32)}
        want = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                               "noise": jax.random.PRNGKey(1)}, batch))
    assert _shapes(tree) == _shapes(want)
    assert detect_glow_scan_chunk(tree) == layout.get("scan_chunk", 1)
    if layout.get("scan_chunk", 1) > 1:
        np.testing.assert_equal(tree, jax.tree_util.tree_map(np.asarray, want))
    for other in (tree, rechunk_glow_flows(tree, 1), rechunk_glow_flows(tree, 2)):
        back = _port("mcglow", seed=4)
        back.load_state_dict(from_jax_variables(other), strict=True)
        assert all(torch.equal(t, back.state_dict()[k]) for k, t in port.state_dict().items())


def test_checkpoints_cross_packages(tmp_path):
    """A JAX-written checkpoint in the chunked layout is read by the port,
    and the port's (scanned) by the JAX package's ``load_checkpoint``."""
    cfg = {"output_dir": str(tmp_path)}
    port = _port("mcglow", seed=5)
    v = to_jax_gan_variables(port)
    jax_save_checkpoint(cfg, "0_jax", {"model_dict": jglow.rechunk_glow_flows(v, 2),
                                       "epoch": 1})
    back = _port("mcglow", seed=6)
    back.load_state_dict(from_jax_variables(load_model_dict(ckpt_path(cfg, "0_jax",
                                                                      "checkpoint"))))
    assert all(torch.equal(t, back.state_dict()[k]) for k, t in port.state_dict().items())
    save_checkpoint(cfg, "0_port", {"model_dict": v, "epoch": 1})
    got = jax_load_checkpoint(cfg, "0_port")["model_dict"]
    np.testing.assert_equal(jax.tree_util.tree_map(np.asarray, got), v)
    assert jglow.detect_glow_scan_chunk(got) == 1


# ---------------------------------------------------------- manipulation
@pytest.mark.parametrize("torch_compat", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_create_and_transit_match_jax(name, torch_compat):
    """``create`` in both streams (the JAX one over the scanned ``[K,
    modes, C]`` codebooks; the reference's flow by flow, ``MC_0`` before
    ``MC_1``) and ``transit``, against the JAX package on the same
    variables."""
    model = _port(name, seed=7)
    variables = to_jax_gan_variables(model)

    def check(got, want):
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, want))
        assert set(got) == set(want)
        for k, w in want.items():
            if k.endswith("embedding.conv.weight"):
                assert got[k].shape == w.shape and (got[k] - w).abs().max() <= 1e-6, k
            else:
                assert torch.equal(got[k], w), k

    check(pmanip.create(model, 7, rng_seed=5, torch_compat=torch_compat, model_name=name),
          jmanip.create(variables, 7, rng_seed=5, torch_compat=torch_compat, model_name=name))
    check(pmanip.transit(model, 1, 0.375), jmanip.transit(variables, 1, 0.375))


def test_create_filter_keeps_the_first_finite_per_mode():
    """Per mode the first ``per_mode`` finite images of the sweep, padded
    with its non-finite ones; rows of the grid mode-major as the sweep."""
    modes, n, per = 3, 5, 2
    img = np.arange(modes * n, dtype=np.float32)[:, None, None, None] * np.ones((1, 2, 2, 1),
                                                                                np.float32)
    img[0, 0, 0, 0] = np.nan          # mode 0: draws 0, 3, ... -> keeps 3, 6
    img[[1, 4, 7, 10, 13], 1, 1, 0] = np.inf  # mode 1: none finite -> its first two
    grid = keep_finite_per_mode(img, modes, per)
    assert grid.shape == (modes * per, 2, 2, 1)
    np.testing.assert_array_equal(grid[:, 0, 0, 0], [3, 1, 2, 6, 4, 5])
    assert not np.isfinite(grid[[1, 4]]).all()


# ---------------------------------------------------------------- trainer
GLOW_CFG = {"hidden_size": 8, "K": 2, "L": 2, "affine": True, "conv_lu": True,
            "scan_flows": True}
COMMON = dict(derive_model_params=False, glow=GLOW_CFG, derive_batch_size=False,
              batch_size={"train": 16, "test": 16}, limit_train_batches=2,
              limit_eval_batches=2, log_interval=1.0, save_per_mode=1)


def _argv(tmp, name, *extra):
    return ["--data_name", "Synthetic", "--model_name", name, "--control_name",
            "0.5" if name == "mcglow" else "None", "--device", "cpu", "--output_dir", str(tmp),
            *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """MCGlow: 2 epochs of 2 steps through ``cli.train`` (DDI first), each
    evaluated on 2 batches; 1 epoch, then ``resume_mode=1`` to epoch 2 in
    another folder; ``cli.test_model`` on the first run's ``_best``."""
    tmp = tmp_path_factory.mktemp("glow")
    ddi = []
    real = ploop.Experiment._run_ddi
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdatasets, "_make_synthetic", functools.lru_cache(_make_synthetic))
        mp.setattr(ploop.Experiment, "_run_ddi",
                   lambda self: (ddi.append(self.cfg["output_dir"]), real(self))[1])
        (full,) = cli_train.main(_argv(tmp / "full", "mcglow", "--num_epochs", "2"), **COMMON)
        cli_train.main(_argv(tmp / "split", "mcglow", "--num_epochs", "1"), **COMMON)
        (split,) = cli_train.main(_argv(tmp / "split", "mcglow", "--num_epochs", "2",
                                        "--resume_mode", "1"), **COMMON)
        (tested,) = cli_test_model.main(_argv(tmp / "full", "mcglow"), **COMMON)
    with pytest.MonkeyPatch.context() as mp:  # one epoch with the reversible backward
        mp.setattr(pdatasets, "_make_synthetic", functools.lru_cache(_make_synthetic))
        (rev,) = cli_train.main(_argv(tmp / "rev", "mcglow", "--num_epochs", "1"),
                                **dict(COMMON, reversible_flows=True, remat=True))
    return dict(tmp=tmp, full=full, split=split, tested=tested, ddi=ddi, rev=rev)


def test_trainer_resume_is_bit_equal_and_skips_ddi(runs):
    """DDI ran in each fresh run, not in the resumed one; mode 1 from the
    epoch-1 checkpoint ends where the uninterrupted run ends (weights,
    Adam's state, the scheduler, the noise generator, the logger)."""
    full, split = runs["full"], runs["split"]
    assert runs["ddi"] == [str(runs["tmp"] / "full"), str(runs["tmp"] / "split")]
    assert split.resumed["epoch"] == 2 and [s["epoch"] for s in split.epoch_stats] == [2]
    a, b = to_numpy(full.state_dict()), to_numpy(split.state_dict())
    for k in ("model_dict", "optimizer_dict", "scheduler_dict", "torch_rng"):
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, a[k], b[k])), k
    assert dict(full.logger.history) == dict(split.logger.history)


def test_trainer_logs_bits_per_dim(runs):
    """The Glow trainer's settings (the JAX package's), the bits/dim per
    epoch, and ``cli.test_model`` scoring ``_best``'s epoch (the eval noise
    drawn from a generator seeded as the run's)."""
    full = runs["full"]
    cfg = full.cfg
    assert (cfg["pivot_metric"], cfg["lr_warmup_steps"], cfg["num_init_batches"],
            cfg["grad_clip"]) == ("Loss", 16, 8, 1.0)
    assert full._skip_nonfinite()
    hist = full.logger.history
    assert len(hist["test/Loss"]) == 2 and np.isfinite(hist["test/Loss"]).all()
    assert all(v > 0 for v in hist["train/Loss"] + hist["test/Loss"])
    assert full.epoch_stats[-1]["eval_images"] == 32
    assert np.isfinite(runs["tested"].history["test/Loss"]).all()
    ckpt = jax_load_checkpoint(cfg, full.tag, "best")
    assert jglow.detect_glow_scan_chunk(ckpt["model_dict"]) == 1


def test_trainer_takes_reversible_flows_and_remat(runs):
    """``cli.train`` with ``reversible_flows`` and the step's ``remat``: the
    model runs the reversible backward, and its first epoch's bits/dim
    equal the ``remat_flows`` run's (the same math, ``rtol=1e-4``)."""
    rev, full = runs["rev"], runs["full"]
    assert rev.model.reversible_flows and rev.cfg["glow"]["reversible_flows"]
    for key in ("train/Loss", "test/Loss"):
        np.testing.assert_allclose(rev.logger.history[key][0], full.logger.history[key][0],
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("workflow", ["generate", "transit", "create"])
def test_sample_cli_on_the_cpu(runs, workflow):
    """The three workflows from the trained MCGlow's ``_best``; every PNG
    read back."""
    out = runs["tmp"] / "full"
    prefix = {"generate": "generated", "transit": "transited", "create": "created"}[workflow]
    cli_sample.main(workflow, _argv(out, "mcglow"), **COMMON)
    vis = [f for f in sorted(os.listdir(out / "vis")) if f.startswith(prefix)]
    assert vis
    for f in vis:
        assert read_png(str(out / "vis" / f)).shape[-1] == 3


@pytest.mark.parametrize("name", ["mcglow", "cglow"])
def test_config_matches_jax(name):
    """``process_control`` and the Glow trainer's overrides equal the JAX
    package's; the factory builds the model in the config's layout."""
    base = dict(jconfig.load_config(), data_name="CIFAR10", model_name=name)
    ctrl = "0.5" if name == "mcglow" else "None"
    p = ploop.apply_family_overrides(pconfig.process_control(
        pconfig.apply_control_name(base, ctrl)))
    j = jloop.apply_family_overrides(jconfig.process_control(
        jconfig.apply_control_name(base, ctrl)))
    assert p == j
    assert p["glow"] == {"hidden_size": 512, "K": 16, "L": 3, "affine": True,
                         "conv_lu": True, "scan_flows": True}
    small = dict(p, classes_size=10, glow=dict(GLOW_CFG, scan_chunk=2))
    model = build_model(small, "cpu")
    assert isinstance(model, MODELS[name][0]) and model.scan_chunk == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(small)


@pytest.mark.parametrize("key,value", [("pipe_size", 2)])
def test_unported_glow_options_are_refused(tmp_path, key, value):
    with pytest.raises(NotImplementedError, match=key):
        cli_train.main(_argv(tmp_path, "mcglow"), **dict(COMMON, **{key: value}))
    cfg = dict(pconfig.process_control({"data_name": "CIFAR10", "model_name": "cglow"}),
               classes_size=10, **{key: value})
    with pytest.raises(NotImplementedError, match="Queue A"):
        build_model(dict(cfg, glow=dict(GLOW_CFG)), "cpu")
