"""Serving artifacts: a sampler's generate path as one ``torch.export``
program, weights baked in. Port of ``mcgm_tpu/io/export.py``.

The JAX package writes serialized StableHLO through ``jax.export``; the port
writes an ``ExportedProgram`` (``torch.export.save``, a ``.pt2`` zip) with a
symbolic batch (``Dim("b")``), so one artifact serves any request size, and
the family, device and mode in ``extra/mcgm.json``. Loading it needs torch
and :mod:`mcgm_tpu_torch.kernels.ops`, which registers the custom ops the
program calls (the int8 conv and quantizer, ``mc_gated_matmul``), and no
model code. An artifact runs on the device it was exported for (its
weights live there): a CUDA artifact is refused where no card is present,
never run on the CPU instead.

Families: vae / gan take ``(C, z)``; glow ``(C, [z_l per level])``;
pixelcnn ``(C, u)`` with ``u [B, H * W, K]`` the uniforms of its Gumbel
draws (``models.pixelcnn.draw_uniforms``, in the order the incremental
sampler draws them), then the frozen VQ-VAE's ``decode_code``. The JAX
artifact takes a PRNG key there; the port's takes the draws themselves, so
one ``torch.Generator`` gives the live sampler's codes.

``quantize``: ``"int8"`` (dynamic per-example activation scales) or
``"int8_static"`` (the calibrated per-layer scales of :func:`calibrate_int8`)
runs the GAN / VAE generators' convs and Dense layers s8 x s8 -> s32
(``ops/quant.py``), their weights quantized once here; Glow and PixelCNN
stay full precision, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import zipfile

import torch
from torch import nn

from ..kernels import ops  # noqa: F401  (registers the custom ops an artifact calls)

META = "mcgm.json"
FAMILY = {"mcgan": "gan", "cgan": "gan", "mcvae": "vae", "cvae": "vae", "mcglow": "glow",
          "cglow": "glow", "mcpixelcnn": "pixelcnn", "cpixelcnn": "pixelcnn"}
QUANTIZE = {None: None, "int8": "dynamic", "int8_static": "static"}


def family(sampler) -> str:
    return FAMILY.get(sampler.cfg["model_name"], sampler.cfg["model_name"])


def _check_int8(sampler) -> None:
    if family(sampler) not in ("vae", "gan"):
        raise ValueError(f"int8 serving supports vae/gan, not {family(sampler)}")


def _sites(module: nn.Module) -> list:
    from ..ops.quant import Int8Site

    return [m for m in module.modules() if isinstance(m, Int8Site) and m.quantized]


def calibrate_int8(sampler, generator: torch.Generator | None = None, n_batches: int = 4,
                   batch_size: int = 256, batches=None):
    """A copy of ``sampler`` whose generator (a GAN's) or decoder (a VAE's)
    holds each quantized layer's largest ``|x|`` over ``n_batches`` generate
    sweeps in its ``act_amax`` buffer: the input of ``quantize="int8_static"``.

    Calibration runs the full-precision math on serving-like inputs: C
    uniform over the classes, z ~ N(0, 1), both drawn from ``generator``
    (seeded 0 on the sampler's device by default); ``batches``, a list of
    ``(C, z)``, replaces the draws."""
    from ..ops.quant import int8_serving

    _check_int8(sampler)
    s = sampler.with_state(sampler.model.state_dict())
    if batches is None:
        g = generator or torch.Generator(s.device).manual_seed(0)
        n_cls = s.cfg["classes_size"]
        batches = [(torch.randint(0, n_cls, (batch_size,), generator=g, device=g.device),
                    torch.randn((batch_size, s.model.latent_size), generator=g,
                                device=g.device)) for _ in range(n_batches)]
    with torch.no_grad(), int8_serving("calibrate"):
        for C, z in batches:
            s.model.generate(C.to(s.device), z.to(s.device))
    return s


class _Serve(nn.Module):
    """The program an artifact holds: ``forward(C, z_or_u)`` -> images."""

    def __init__(self, fam: str, model: nn.Module, ae_model: nn.Module | None, grid):
        super().__init__()
        self.fam, self.grid = fam, grid
        self.model, self.ae_model = model, ae_model

    def forward(self, C, z):
        if self.fam != "pixelcnn":
            return self.model.generate(C, z)
        from ..models.pixelcnn import sample_codes_incremental

        codes = sample_codes_incremental(self.model, C, None, self.grid, uniforms=z)
        return self.ae_model.decode_code(codes)


def _sampling_part(model: nn.Module) -> nn.Module:
    """A GAN or VAE without what ``generate`` does not run (its
    discriminator, its encoder): a shallow copy sharing the sampling
    module."""
    keep = getattr(model, "sampling_module", None)
    if keep is None or keep not in model._modules:
        return model
    part = copy.copy(model)
    part._modules = {k: v for k, v in model._modules.items() if k == keep}
    return part


def export_sampler(sampler, batch: int | str = "b", device=None,
                   quantize: str | None = None) -> bytes:
    """Serialize ``sampler``'s generate path (weights baked in).

    ``batch``: an int for a fixed batch size, or the name of a symbolic
    dimension (default ``"b"``): the artifact then takes any batch size.
    ``device``: where the artifact runs (default: the sampler's device;
    another one exports a copy of the model moved there). ``quantize``:
    None, ``"int8"`` or ``"int8_static"`` (gan / vae; see the module doc)."""
    if quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize mode {quantize!r}")
    fam = family(sampler)
    if fam not in ("vae", "gan", "glow", "pixelcnn"):
        raise ValueError(f"family {fam} cannot be exported for serving")
    if quantize:
        _check_int8(sampler)
    device = torch.device(device) if device is not None else sampler.device
    model = _sampling_part(sampler.model)
    ae_model = sampler.ae_model
    if device != sampler.device:
        model = copy.deepcopy(model).to(device)
        ae_model = None if ae_model is None else copy.deepcopy(ae_model).to(device)
    if quantize == "int8_static" and any(m.act_amax is None for m in _sites(model)):
        raise ValueError("int8_static needs calibrated activation scales: pass the sampler "
                         "through calibrate_int8 first")
    grid = (sampler.cfg["data_shape"][0] // 4,) * 2
    serve = _Serve(fam, model, ae_model, grid).eval()
    n = batch if isinstance(batch, int) else 2  # 0 and 1 would specialise
    C = torch.zeros(n, dtype=torch.long, device=device)
    if fam == "glow":
        z = [torch.zeros((n, *s), device=device) for s in model.make_z_shapes()]
    elif fam == "pixelcnn":
        z = torch.full((n, grid[0] * grid[1], model.input_size), 0.5, device=device)
    else:
        z = torch.zeros((n, model.latent_size), device=device)
    dynamic = None
    if isinstance(batch, str):
        b = torch.export.Dim(batch, min=1)
        dynamic = ({0: b}, [{0: b}] * len(z) if fam == "glow" else {0: b})
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        if quantize:
            from ..ops import quant

            stack.enter_context(quant.frozen_int8_weights(model))
            stack.enter_context(quant.int8_serving(QUANTIZE[quantize]))
        program = torch.export.export(serve, (C, z), dynamic_shapes=dynamic, strict=False)
    meta = {"family": fam, "device": str(device), "quantize": quantize,
            "batch": batch, "model_name": sampler.cfg["model_name"]}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META: json.dumps(meta)})
    return buf.getvalue()


def artifact_info(blob: bytes) -> dict:
    """The artifact's ``mcgm.json``: family, device, quantize, batch."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        name = next(n for n in z.namelist() if n.endswith(f"extra/{META}"))
        return json.loads(z.read(name))


def load_serving_fn(blob: bytes):
    """The artifact as a function of ``(C, z)`` (glow: ``(C, [z_l])``,
    pixelcnn: ``(C, u)``), run without gradients on the device it was
    exported for, the inputs moved there. Needs only torch and this
    package's ``kernels.ops``."""
    info = artifact_info(blob)
    device = torch.device(info["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"this artifact was exported for {device}, and no CUDA device is "
                           "available; it does not run on the CPU instead")
    program = torch.export.load(io.BytesIO(blob)).module()

    def call(C, z):
        C = torch.as_tensor(C).to(device, torch.long)
        z = ([t.to(device, torch.float32) for t in z] if isinstance(z, (list, tuple))
             else torch.as_tensor(z).to(device, torch.float32))
        with torch.no_grad():
            return program(C, z)

    call.info = info
    return call


def save_artifact(blob: bytes, path: str) -> None:
    """Write ``blob`` to ``path`` atomically (a temporary file, then a
    rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def load_artifact(path: str):
    with open(path, "rb") as f:
        return load_serving_fn(f.read())
