"""CPU parity of the port's int8 serving path and serving artifacts.

The int8 math is held to the JAX package's: each quantizable layer under
``int8_serving`` (dynamic and static) against ``_int8_apply`` at atol 1e-6
(f32, the integer sums exact on both sides), ``ConvS2D`` left full
precision, the calibration's ``act_amax`` against the JAX ``quant_stats``
at rtol 1e-6, and whole ``generate`` of tiny MCGAN, CGAN, MCVAE and CVAE
against the JAX live int8 apply within the JAX package's own artifact bound
(mean |d| < 2e-3, max < 0.05: its CPU int8 convs run through float, so an
activation a float ulp apart may round to another level). The JAX side is
five programs (the layers; per model its calibration and both int8
``generate`` calls), each compiled once at a low XLA optimisation level on a
thread while the next is traced, no ``jax.export``; the port takes their
variables, quant stats included, through ``io.jax_import``.

The artifacts (``torch.export``) are held to the live port sampler at atol
1e-6 for the four families, with a symbolic batch, a file round trip,
per-example int8 scales against a 100x co-batched outlier, the static
artifact's exact batch invariance, created modes, the refusals, the int8
flag restored, the CLI's flags, and a CUDA artifact refused without a card.
"""

import ast
import concurrent.futures
import io
import pathlib
import zipfile

import numpy as np
import pytest
import torch
import jax

from mcgm_tpu.models.gan import CGAN as JaxCGAN
from mcgm_tpu.models.gan import MCGAN as JaxMCGAN
from mcgm_tpu.models.vae import CVAE as JaxCVAE
from mcgm_tpu.models.vae import MCVAE as JaxMCVAE
from mcgm_tpu.ops import layers as jlayers
from mcgm_tpu_torch.cli import export as cli_export
from mcgm_tpu_torch.config import load_config
from mcgm_tpu_torch.io import export as pexport
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_gan_variables
from mcgm_tpu_torch.models import build_model
from mcgm_tpu_torch.models.gan import CGAN, MCGAN
from mcgm_tpu_torch.models.pixelcnn import draw_uniforms
from mcgm_tpu_torch.models.vae import CVAE, MCVAE
from mcgm_tpu_torch.ops import layers as players
from mcgm_tpu_torch.ops import quant
from mcgm_tpu_torch.workflows.create import created_sampler
from mcgm_tpu_torch.workflows.sampling import Sampler
from test_torch_port_gan import _fill

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, LATENT = 5, 16
ARCH = {
    "mcgan": (MCGAN, JaxMCGAN, dict(data_shape=(32, 32, 3), latent_size=LATENT,
                                    generator_hidden_size=(16, 16, 16, 16),
                                    discriminator_hidden_size=(8, 8, 8, 8), num_mode=M,
                                    controller_rate=0.5)),
    "cgan": (CGAN, JaxCGAN, dict(data_shape=(32, 32, 1), latent_size=LATENT,
                                 generator_hidden_size=(16, 16, 16, 16),
                                 discriminator_hidden_size=(8, 8, 8, 8), num_mode=M,
                                 embedding_size=8)),
    "mcvae": (MCVAE, JaxMCVAE, dict(data_shape=(32, 32, 3), hidden_size=(8, 16),
                                    latent_size=LATENT, num_res_block=1, num_mode=M,
                                    controller_rate=0.5)),
    "cvae": (CVAE, JaxCVAE, dict(data_shape=(32, 32, 1), hidden_size=(8, 16),
                                 latent_size=LATENT, num_res_block=1, num_mode=M,
                                 embedding_size=4)),
}
MODES = ("dynamic", "static")
B = 6
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
GAN_CFG = {"latent_size": LATENT, "generator_hidden_size": [16, 16, 16, 16],
           "discriminator_hidden_size": [8, 8, 8, 8], "embedding_size": 8}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfg(name: str, **extra) -> dict:
    return dict(load_config(), model_name=name, classes_size=M, **extra)


def _jax_run(jmodel):
    """The JAX side for one model, as one program: the calibration over the
    batches (``calibrate_int8``'s loop), then ``generate`` of the request
    in dynamic and in static mode (the modes are read at trace time)."""
    def run(v, batches, C, z):
        qs = {}
        for Cb, zb in batches:
            with jlayers.int8_serving("calibrate"):
                _, muts = jmodel.apply({**v, "quant_stats": qs}, Cb, zb, method="generate",
                                       mutable=["quant_stats"])
            qs = muts["quant_stats"]
        with jlayers.int8_serving("dynamic"):
            dyn = jmodel.apply(v, C, z, method="generate")
        with jlayers.int8_serving("static"):
            stat = jmodel.apply({**v, "quant_stats": qs}, C, z, method="generate")
        return qs, dyn, stat

    return run


@pytest.fixture(scope="module")
def models():
    """Per model: the JAX variables (numpy values on the port model's tree),
    two calibration batches of 8 and a request batch ``(C, z)``, and the
    JAX results: ``quant_stats`` and the dynamic and static images."""
    out, jobs = {}, []
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for i, (name, (Port, Jax, arch)) in enumerate(ARCH.items()):
            rng = np.random.default_rng(40 + i)
            v = _fill(to_jax_gan_variables(Port(**arch)), rng)
            batches = [(rng.integers(0, M, 8).astype(np.int32),
                        rng.standard_normal((8, LATENT)).astype(np.float32)) for _ in range(2)]
            C = rng.integers(0, M, B).astype(np.int32)
            z = rng.standard_normal((B, LATENT)).astype(np.float32)
            out[name] = dict(v=v, batches=batches, C=C, z=z)
            lowered = jax.jit(_jax_run(Jax(**arch))).lower(v, batches, C, z)
            jobs.append((name, pool.submit(lowered.compile, compiler_options=O0)))
        for name, job in jobs:
            d = out[name]
            qs, dyn, stat = jax.tree_util.tree_map(
                np.asarray, job.result()(d["v"], d["batches"], d["C"], d["z"]))
            d.update(qs=qs, jax={"dynamic": dyn, "static": stat})
    return out


def _port(name, v):
    Port, _, arch = ARCH[name]
    model = Port(**arch).eval()
    model.load_state_dict(from_jax_variables(v), strict=True)
    return model


def _sampler(name, model):
    return Sampler(_cfg(name, data_shape=ARCH[name][2]["data_shape"], gan=GAN_CFG,
                        controller_rate=0.5), model)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- one layer
LAYERS = {  # name: (port layer, JAX layer, input [B, H, W, C] or [B, F])
    "conv3x3": (lambda: players.Conv(16, 8, 3, 1, 1), lambda: jlayers.Conv(8, 3, 1, 1),
                (3, 5, 5, 16)),
    "conv1x1": (lambda: players.Conv(16, 8, 1, 1, 0), lambda: jlayers.Conv(8, 1, 1, 0),
                (3, 5, 5, 16)),
    "upsampled": (lambda: players.UpsampledConv(16, 8), lambda: jlayers.UpsampledConv(8),
                  (3, 5, 4, 16)),
    "conv_transpose": (lambda: players.ConvTranspose(16, 3), lambda: jlayers.ConvTranspose(3),
                       (3, 4, 5, 16)),
    "dense": (lambda: players.Dense(24, 40), lambda: jlayers.Dense(40), (3, 24)),
    "conv_s2d": (lambda: players.ConvS2D(16, 3), lambda: jlayers.ConvS2D(3), (3, 8, 8, 16)),
}


def _layer_name(kind):  # io.jax_import knows a transposed conv by its module name
    return "ConvTranspose_0" if kind == "conv_transpose" else "L"


@pytest.fixture(scope="module")
def layers():
    """Per layer: the port layer (inside a holder, under its JAX name) with
    random variables carried by ``io.jax_import``, a static ``act_amax``
    that clips the top of the input, the input, and the JAX layer's output
    in either int8 mode (one program for all)."""
    cases, jax_in = {}, {}
    for i, (kind, (make_port, make_jax, shape)) in enumerate(LAYERS.items()):
        rng = np.random.default_rng(i)
        name = _layer_name(kind)
        holder = torch.nn.Module()
        holder.add_module(name, make_port())
        v = _fill(to_jax_gan_variables(holder), rng)
        # |x| reaches ~3.5 at these sizes: 2.4 clips the top
        v["quant_stats"] = {name: {"act_amax": np.float32(2.4)}}
        holder.load_state_dict(from_jax_variables(v), strict=True)
        x = rng.standard_normal(shape).astype(np.float32)
        cases[kind] = dict(layer=getattr(holder, name), x=x)
        jax_in[kind] = ({c: t[name] for c, t in v.items()}, x)

    def run(jax_in):
        out = {}
        for kind, (jv, x) in jax_in.items():
            for mode in MODES:
                with jlayers.int8_serving(mode):
                    out[f"{kind}/{mode}"] = LAYERS[kind][1]().apply(jv, x)
        return out

    want = jax.jit(run).lower(jax_in).compile(compiler_options=O0)(jax_in)
    for key, w in want.items():
        kind, mode = key.split("/")
        cases[kind][mode] = np.asarray(w)
    return cases


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", list(LAYERS))
def test_layer_int8_matches_jax(layers, kind, mode):
    """The port's int8 apply of one layer against the JAX ``_int8_apply``
    under ``int8_serving``, its variables carried by ``io.jax_import``; the
    static scale clips part of the input. ``ConvS2D`` has no int8 branch in
    either package: under int8 it is its own full-precision output."""
    case = layers[kind]
    x, layer = case["x"], case["layer"]
    xt = _t(x).permute(0, 3, 1, 2) if x.ndim == 4 else _t(x)
    with torch.no_grad():
        with quant.int8_serving(mode):
            got = layer(xt)
        full = layer(xt)
    if x.ndim == 4:
        got, full = got.permute(0, 2, 3, 1), full.permute(0, 2, 3, 1)
    if kind == "conv_s2d":
        assert torch.equal(got, full)
        np.testing.assert_allclose(got.numpy(), case[mode], atol=1e-5)
        return
    assert not torch.equal(got, full)
    np.testing.assert_allclose(got.numpy(), case[mode], rtol=0, atol=1e-6)


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("name", list(ARCH))
def test_calibrate_matches_jax_quant_stats(models, name):
    """``calibrate_int8`` on the JAX calibration's batches: every quantized
    layer's ``act_amax`` equal to the JAX ``quant_stats`` at rtol 1e-6, and
    the buffers written back to the JAX layout by ``to_jax_gan_variables``."""
    m = models[name]
    s = _sampler(name, _port(name, m["v"]))
    cal = pexport.calibrate_int8(s, batches=[(_t(C), _t(z)) for C, z in m["batches"]])
    want = from_jax_variables({"quant_stats": m["qs"]})
    got = quant.act_amax_state(cal.model)
    assert set(got) == set(want) and want
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
    back = to_jax_gan_variables(cal.model)["quant_stats"]
    assert from_jax_variables({"quant_stats": back}).keys() == want.keys()
    assert not quant.act_amax_state(s.model)  # the sampler given stays uncalibrated


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(ARCH))
def test_generate_int8_matches_jax(models, name, mode):
    """Whole ``generate`` under int8 against the JAX live int8 apply, the
    static scales the JAX calibration's carried over by ``io.jax_import``."""
    m = models[name]
    v = {**m["v"], "quant_stats": m["qs"]} if mode == "static" else m["v"]
    want = m["jax"][mode]
    port = _port(name, v)
    with torch.no_grad(), quant.int8_serving(mode):
        got = port.generate(_t(m["C"]), _t(m["z"])).numpy()
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.mean() < 2e-3 and err.max() < 0.05, (err.mean(), err.max())


# ---------------------------------------------------------------- artifacts
def _live(s, C, z, mode=None):
    with torch.no_grad():
        if mode is None:
            return s.model.generate(C, z)
        with quant.int8_serving(mode):
            return s.model.generate(C, z)


def _request(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.arange(n) % M, torch.randn((n, LATENT), generator=g)


@pytest.fixture(scope="module")
def gan_int8(models):
    """An MCGAN sampler, calibrated, then given 5 -> 7 created modes, and
    the created sampler's dynamic int8 artifact, symbolic batch (the one
    GAN export the artifact tests share); also the sampler before the
    surgery."""
    s = pexport.calibrate_int8(_sampler("mcgan", _port("mcgan", models["mcgan"]["v"])),
                               n_batches=1, batch_size=8)
    s2 = created_sampler(s, 7, 3)
    blob = pexport.export_sampler(s2, batch="b", quantize="int8")
    return s2, pexport.load_serving_fn(blob), s


@pytest.fixture(scope="module")
def vae_blob(models):
    """A CVAE sampler and its full-precision artifact at batch 4."""
    s = _sampler("cvae", _port("cvae", models["cvae"]["v"]))
    return s, pexport.export_sampler(s, batch=4)


def test_export_gan_symbolic_batch_roundtrip(gan_int8):
    """One artifact, several batch sizes, each the live int8 apply (its
    weights quantized once, at export); int8 stays near full precision;
    the int8 mode is off again after the export."""
    s, fn, _ = gan_int8
    assert quant.int8_mode() is None
    assert fn.info == {"family": "gan", "device": "cpu", "quantize": "int8", "batch": "b",
                       "model_name": "mcgan"}
    for n in (1, 3, 5):
        C, z = _request(n, n)
        got, want = fn(C, z), _live(s, C, z, "dynamic")
        assert got.shape == want.shape == (n, 32, 32, 3)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        assert (got - _live(s, C, z)).abs().mean() < 0.1


def test_export_vae_and_file_roundtrip(vae_blob, tmp_path):
    s, blob = vae_blob
    path = str(tmp_path / "export" / "m.pt2")
    pexport.save_artifact(blob, path)
    assert not (tmp_path / "export" / "m.pt2.tmp").exists()
    C, z = _request(4, 7)
    torch.testing.assert_close(pexport.load_artifact(path)(C, z), _live(s, C, z), rtol=0,
                               atol=1e-6)


def _tiny(name, data_shape, **sections):
    cfg = _cfg(name, data_shape=data_shape, **sections)
    return cfg, build_model(cfg, "cpu")


def test_export_glow_z_cascade():
    cfg, model = _tiny("mcglow", (16, 16, 3), glow={"hidden_size": 8, "K": 2, "L": 2,
                                                    "affine": True, "conv_lu": True,
                                                    "scan_flows": False})
    s = Sampler(cfg, model)
    fn = pexport.load_serving_fn(pexport.export_sampler(s))
    C = torch.arange(3) % M
    z = s.sample_z(3, torch.Generator().manual_seed(2))
    torch.testing.assert_close(fn(C, z), s.sample_with_z(C, z), rtol=0, atol=1e-6)


def test_export_pixelcnn_full_autoregressive():
    """The artifact holds the incremental sampler (its two loops) and the
    VQ-VAE's ``decode_code``; the uniforms drawn in the sampler's order
    from one generator give the live sampler's images."""
    vq = {"hidden_size": [8, 8], "num_res_block": 1, "embedding_size": 8, "num_embedding": 16,
          "vq_commit": 0.25}
    cfg, model = _tiny("mcpixelcnn", (16, 16, 1), vqvae=vq,
                       pixelcnn={"num_layer": 2, "hidden_size": 8, "num_embedding": 16})
    ae = build_model(dict(cfg, model_name="vqvae"), "cpu")
    s = Sampler(cfg, model, ae)
    fn = pexport.load_serving_fn(pexport.export_sampler(s))
    for n in (3, 1):
        C = torch.arange(n) % M
        u = draw_uniforms(n, (4, 4), 16, torch.Generator().manual_seed(n))
        want = s.sample(C, torch.Generator().manual_seed(n))
        torch.testing.assert_close(fn(C, u), want, rtol=0, atol=1e-6)


def test_export_int8_batch_invariant(gan_int8):
    """A request's images do not depend on a co-batched 100x outlier: the
    activation scales are per example."""
    _, fn, _ = gan_int8
    C, z = _request(4, 3)
    alone = fn(C[:1], z[:1])
    outliers = 100.0 * torch.randn((3, LATENT), generator=torch.Generator().manual_seed(10))
    cobatched = fn(C, torch.cat([z[:1], outliers]))[:1]
    err = (alone - cobatched).abs()
    assert err.mean() < 2e-3 and err.max() < 0.05, (err.mean(), err.max())


def test_export_int8_static_calibrated(models):
    s = _sampler("cgan", _port("cgan", models["cgan"]["v"]))
    with pytest.raises(ValueError, match="calibrate_int8"):
        pexport.export_sampler(s, quantize="int8_static")
    cal = pexport.calibrate_int8(s, torch.Generator().manual_seed(5), n_batches=2,
                                 batch_size=16)
    blob = pexport.export_sampler(cal, quantize="int8_static")
    program = torch.export.load(io.BytesIO(blob))
    # the weights were quantized at export: int8 constants, no quantize of a weight
    assert any(t.dtype == torch.int8 for t in program.constants.values())
    fn = pexport.load_serving_fn(blob)
    C, z = _request(4, 6)
    got = fn(C, z)
    torch.testing.assert_close(got, _live(cal, C, z, "static"), rtol=0, atol=1e-6)
    torch.testing.assert_close(fn(C[:1], z[:1]), got[:1], rtol=0, atol=1e-6)


def test_export_created_modes_artifact(gan_int8):
    """Mode surgery composes with serving: 5 -> 7 never-trained modes, the
    created sampler's artifact equal to the live created sampler; the
    calibrated scales stay with the created sampler."""
    s2, fn, s = gan_int8
    assert s2.cfg["classes_size"] == 7
    assert quant.act_amax_state(s2.model).keys() == quant.act_amax_state(s.model).keys()
    assert quant.act_amax_state(s2.model)
    C, z = torch.arange(7), torch.randn((7, LATENT), generator=torch.Generator().manual_seed(1))
    got = fn(C, z)
    assert got.shape[0] == 7
    torch.testing.assert_close(got, _live(s2, C, z, "dynamic"), rtol=0, atol=1e-6)


def test_export_refusals_and_the_flag(models, monkeypatch):
    """int8 refused for glow and pixelcnn, an unknown mode refused, and the
    int8 mode restored after an export that fails (after one that does not:
    ``test_export_gan_symbolic_batch_roundtrip``)."""
    for name in ("mcglow", "cpixelcnn"):
        s = Sampler(_cfg(name), torch.nn.Linear(1, 1))
        with pytest.raises(ValueError, match="int8 serving"):
            pexport.export_sampler(s, quantize="int8")
        with pytest.raises(ValueError, match="int8 serving"):
            pexport.calibrate_int8(s)
    s = _sampler("mcvae", _port("mcvae", models["mcvae"]["v"]))
    with pytest.raises(ValueError, match="unknown quantize mode"):
        pexport.export_sampler(s, quantize="int4")
    assert quant.int8_mode() is None

    def fail(*args, **kwargs):
        assert quant.int8_mode() == "dynamic"
        raise RuntimeError("export failed")

    monkeypatch.setattr(torch.export, "export", fail)
    with pytest.raises(RuntimeError, match="export failed"):
        pexport.export_sampler(s, batch=2, quantize="int8")
    assert quant.int8_mode() is None


def test_export_cli_flags_parse(tmp_path):
    """The export-only flags are peeled off before the config's; the CLI
    then looks for the checkpoint. Another platform than cpu / cuda, or
    two, is refused."""
    with pytest.raises(FileNotFoundError, match="best"):
        cli_export.main(["--data_name", "Synthetic", "--model_name", "mcvae", "--platforms",
                         "cpu", "--batch", "4", "--quantize", "int8",
                         "--output_dir", str(tmp_path)])
    own, rest = cli_export.export_flags(["--batch", "8", "--model_name", "cgan"], {})
    assert (own.batch, own.platforms, own.quantize, rest) == (8, None, None,
                                                              ["--model_name", "cgan"])
    for bad in ("tpu", "cpu,cuda"):
        with pytest.raises(SystemExit, match="--platforms"):
            cli_export.export_flags(["--platforms", bad], {})


def test_cuda_artifact_refused_without_card(vae_blob):
    """An artifact made for the card does not run on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, blob = vae_blob
    out = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as src, zipfile.ZipFile(out, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith(f"extra/{pexport.META}"):
                data = data.replace(b'"device": "cpu"', b'"device": "cuda"')
            dst.writestr(item, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexport.load_serving_fn(out.getvalue())


def test_loader_needs_no_model_code():
    """``io/export.py`` and ``kernels/ops.py`` import no model, workflow or
    trainer module at their top level: the loader's host needs torch and
    the custom ops only."""
    for rel in ("mcgm_tpu_torch/io/export.py", "mcgm_tpu_torch/kernels/ops.py",
                "mcgm_tpu_torch/kernels/int8.py", "mcgm_tpu_torch/kernels/mc_gate.py"):
        tree = ast.parse((ROOT / rel).read_text())
        for node in tree.body:
            if isinstance(node, ast.ImportFrom):
                mod = "." * node.level + (node.module or "")
                assert not any(w in mod for w in ("models", "workflows", "train", "jax")), \
                    (rel, mod)
