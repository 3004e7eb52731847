"""Synthetic reference (PyTorch) checkpoints: a ``state_dict`` with the key
paths the reference implementation's models have (its ``Sequential``
indices, its ``.module`` wrappers, spectral norm's ``weight_orig`` / ``u``
/ ``v``, the shared controllers' alias keys, Glow's constant masks and
CGlow's unused per-block embeddings), each tensor shaped as the same layer
of a port model of the same dimensions (the reference is NCHW, as the port
is) and filled from a seeded numpy draw at the scale of a trained model:
weights ``N(0, 1 / fan_in)``, biases, BatchNorm means and ActNorm locs
``N(0, 0.1^2)``, BatchNorm weights, variances and ActNorm scales ``1 +
0.1 |N(0, 1)|``, codebooks binary, each invconv the LU factors of a random
orthogonal matrix (the reference's init), Glow's zero convs ``N(0, 1e-2^2)``.

``reference_state_dict(name, model, seed)`` for each of the ten model names.
It imports only numpy and torch (``chip_smoke.py`` uses it on the card).
"""

import numpy as np
import torch

class _Ref:
    """A reference-keyed ``state_dict`` shaped by the port model's layers."""

    def __init__(self, model, seed):
        self.model, self.sd = model, {}
        self.rng = np.random.default_rng(seed)

    def _t(self, shape, positive=False, scale=1.0):
        """``N(0, scale^2)``, or with ``positive`` ``1 + |N(0, scale^2)|``."""
        a = self.rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
        return torch.from_numpy(np.abs(a) + 1.0 if positive else a)

    def _small(self, shape):
        return self._t(shape, scale=0.1)

    def _w(self, shape):
        """A weight ``N(0, 1 / fan_in)`` (``[out, in, ...]``; a transposed
        conv's fan-in is its first axis)."""
        return self._t(shape, scale=1.0 / np.sqrt(np.prod(shape[1:])))

    def mod(self, path):
        return self.model.get_submodule(path)

    def conv(self, key, path, bias=True):
        w = self.mod(path).weight
        self.sd[f"{key}.weight"] = self._w(w.shape)
        if bias:
            self.sd[f"{key}.bias"] = self._small(w.shape[1] if "ConvTranspose" in path
                                                 else w.shape[0])

    dense = conv

    def bn(self, key, path):
        n = self.mod(path).weight.shape[0]
        self.sd.update({f"{key}.weight": self._t(n, positive=True, scale=0.1),
                        f"{key}.bias": self._small(n), f"{key}.running_mean": self._small(n),
                        f"{key}.running_var": self._t(n, positive=True, scale=0.1),
                        f"{key}.num_batches_tracked": torch.tensor(7)})

    def code(self, key, path):
        cb = self.mod(path).codebook
        self.sd[f"{key}.codebook"] = torch.from_numpy(
            (self.rng.random(cb.shape) < 0.5).astype(np.float32))

    def sn(self, key, path, bias=True):
        w = self.mod(path).weight
        self.sd[f"{key}.weight_orig"] = self._w(w.shape)
        self.sd[f"{key}.weight_u"] = self._t(w.shape[0])
        self.sd[f"{key}.weight_v"] = self._t(int(np.prod(w.shape[1:])))
        if bias:
            self.sd[f"{key}.bias"] = self._small(w.shape[0])

    def actnorm(self, key, path):
        n = self.mod(path).loc.shape[0]
        self.sd.update({f"{key}.loc": self._small((1, n, 1, 1)),
                        f"{key}.scale": self._t((1, n, 1, 1), positive=True, scale=0.1),
                        f"{key}.initialized": torch.tensor(1, dtype=torch.uint8)})

    def zeroconv(self, key, path):
        """A Glow zero conv: zero at init, so small in a trained model
        (``N(0, 1e-2^2)``, as ``chip_smoke.py``'s Glow phases set them)."""
        w = self.mod(path).conv.weight
        self.sd[f"{key}.conv.weight"] = self._t(w.shape, scale=1e-2)
        self.sd[f"{key}.conv.bias"] = self._small(w.shape[0])
        self.sd[f"{key}.scale"] = self._t((1, self.mod(path).scale.shape[0], 1, 1), scale=0.1)


def _mc_resblock(r, key, path):
    r.conv(f"{key}.conv.0.module", f"{path}.Conv_0")
    r.bn(f"{key}.conv.1.module", f"{path}.BatchNorm_0")
    r.code(f"{key}.conv.3", f"{path}.MultimodalController_0")
    r.conv(f"{key}.conv.4.module", f"{path}.Conv_1")
    r.bn(f"{key}.conv.5.module", f"{path}.BatchNorm_1")
    r.code(f"{key}.conv.6", f"{path}.MultimodalController_1")


def _resblock(r, key, path):
    r.conv(f"{key}.conv.0", f"{path}.Conv_0")
    r.bn(f"{key}.conv.1", f"{path}.BatchNorm_0")
    r.conv(f"{key}.conv.3", f"{path}.Conv_1")
    r.bn(f"{key}.conv.4", f"{path}.BatchNorm_1")


def _vae(r, a, mc):
    L, R = len(a["hidden_size"]), a["num_res_block"]
    if mc:
        for i in range(L):
            r.conv(f"encoder.blocks.{4 * i}.module", f"encoder.Conv_{i}")
            r.bn(f"encoder.blocks.{4 * i + 1}.module", f"encoder.BatchNorm_{i}")
            r.code(f"encoder.blocks.{4 * i + 3}", f"encoder.MultimodalController_{i}")
        for j in range(R):
            _mc_resblock(r, f"encoder.blocks.{4 * L + j}", f"encoder.MCResBlock_{j}")
        r.code("decoder.linear.0", "decoder.MultimodalController_0")
        r.dense("decoder.linear.1.module", "decoder.Dense_0")
        r.bn("decoder.linear.2.module", "decoder.BatchNorm_0")
        r.code("decoder.blocks.0", "decoder.MultimodalController_1")
        for j in range(R):
            _mc_resblock(r, f"decoder.blocks.{1 + j}", f"decoder.MCResBlock_{j}")
        for g in range(L - 1):
            base = 1 + R + 4 * g
            r.conv(f"decoder.blocks.{base}.module", f"decoder.ConvTranspose_{g}")
            r.bn(f"decoder.blocks.{base + 1}.module", f"decoder.BatchNorm_{1 + g}")
            r.code(f"decoder.blocks.{base + 3}", f"decoder.MultimodalController_{2 + g}")
        r.conv(f"decoder.blocks.{1 + R + 4 * (L - 1)}.module", f"decoder.ConvTranspose_{L - 1}")
    else:
        r.dense("encoder.embedding", "encoder.embedding", bias=False)
        for i in range(L):
            r.conv(f"encoder.blocks.{3 * i}", f"encoder.Conv_{i}")
            r.bn(f"encoder.blocks.{3 * i + 1}", f"encoder.BatchNorm_{i}")
        for j in range(R):
            _resblock(r, f"encoder.blocks.{3 * L + j}", f"encoder.ResBlock_{j}")
        r.dense("decoder.embedding", "decoder.embedding", bias=False)
        r.dense("decoder.linear.0", "decoder.Dense_0")
        r.bn("decoder.linear.1", "decoder.BatchNorm_0")
        for j in range(R):
            _resblock(r, f"decoder.blocks.{j}", f"decoder.ResBlock_{j}")
        for g in range(L - 1):
            r.conv(f"decoder.blocks.{R + 3 * g}", f"decoder.ConvTranspose_{g}")
            r.bn(f"decoder.blocks.{R + 3 * g + 1}", f"decoder.BatchNorm_{1 + g}")
        r.conv(f"decoder.blocks.{R + 3 * (L - 1)}", f"decoder.ConvTranspose_{L - 1}")
    r.dense("encoder.mu", "encoder.mu")
    r.dense("encoder.logvar", "encoder.logvar")


def _vqvae(r, a):
    L, R = len(a["hidden_size"]), a["num_res_block"]
    for i in range(L):
        r.conv(f"encoder.blocks.{3 * i}", f"encoder.Conv_{i}")
        r.bn(f"encoder.blocks.{3 * i + 1}", f"encoder.BatchNorm_{i}")
    for j in range(R):
        _resblock(r, f"encoder.blocks.{3 * L + j}", f"encoder.ResBlock_{j}")
    r.conv(f"encoder.blocks.{3 * L + R}", f"encoder.Conv_{L}")
    r.conv("decoder.blocks.0", "decoder.Conv_0")
    r.bn("decoder.blocks.1", "decoder.BatchNorm_0")
    for j in range(R):
        _resblock(r, f"decoder.blocks.{3 + j}", f"decoder.ResBlock_{j}")
    for g in range(L - 1):
        r.conv(f"decoder.blocks.{3 + R + 3 * g}", f"decoder.ConvTranspose_{g}")
        r.bn(f"decoder.blocks.{3 + R + 3 * g + 1}", f"decoder.BatchNorm_{1 + g}")
    r.conv(f"decoder.blocks.{3 + R + 3 * (L - 1)}", f"decoder.ConvTranspose_{L - 1}")
    q = r.mod("quantizer")
    for k in ("embedding", "cluster_size", "embedding_mean"):
        r.sd[f"quantizer.{k}"] = r._t(getattr(q, k).shape, positive=k == "cluster_size")


def _classifier(r, a):
    for i in range(4):
        r.conv(f"blocks.{4 * i}", f"Conv_{i}")
        r.bn(f"blocks.{4 * i + 1}", f"BatchNorm_{i}")
    r.dense("classifier", "classifier")


def _gan(r, a, mc):
    Lg, dh = len(a["generator_hidden_size"]), a["discriminator_hidden_size"]
    w = ".module" if mc else ""
    blk = "_MCGenResBlock" if mc else "_CGenResBlock"
    if not mc:
        r.dense("generator.embedding", "generator.embedding", bias=False)
    r.dense(f"generator.linear{w}", "generator.Dense_0")
    for i in range(Lg - 1):
        b, p = f"generator.blocks.{i}", f"generator.blocks.{blk}_{i}"
        convs = (4, 8, 2) if mc else (3, 6, 1)
        r.bn(f"{b}.conv.0{w}", f"{p}.BatchNorm_0")
        r.conv(f"{b}.conv.{convs[0]}{w}", f"{p}.Conv_0")  # the reference keeps every bias
        r.bn(f"{b}.conv.{convs[0] + 1}{w}", f"{p}.BatchNorm_1")
        r.conv(f"{b}.conv.{convs[1]}{w}", f"{p}.Conv_1")
        r.conv(f"{b}.shortcut.{convs[2]}{w}", f"{p}.Conv_2")
        if mc:
            for m, alias in (("mc_1", "conv.3"), ("mc_2", "conv.7"), ("mc_1", "shortcut.1")):
                r.code(f"{b}.{alias}", f"{p}.{m}")  # the shared controllers' aliases
            r.code(f"{b}.mc_1", f"{p}.mc_1")
            r.code(f"{b}.mc_2", f"{p}.mc_2")
    r.bn(f"generator.blocks.{Lg - 1}{w}", "generator.BatchNorm_0")
    if mc:
        r.code(f"generator.blocks.{Lg + 1}", "generator.MultimodalController_0")
    r.conv(f"generator.blocks.{Lg + 2 if mc else Lg + 1}{w}", "generator.Conv_0")
    first = "discriminator.blocks." + ("_MCFirstDisResBlock_0" if mc else "_CFirstDisResBlock_0")
    if not mc:
        r.sn("discriminator.embedding", "discriminator.embedding", bias=False)
    for j, k in enumerate((0, 3, None) if mc else (0, 2, None)):
        key = "shortcut.0" if k is None else f"conv.{k}"
        r.sn(f"discriminator.blocks.0.{key}{w}", f"{first}.SNConv_{j}")
    if mc:
        r.code("discriminator.blocks.0.mc_1", f"{first}.mc_1")
        r.code("discriminator.blocks.0.conv.2", f"{first}.mc_1")
    n_tail = 2
    for i in range(len(dh) - 1):
        b = f"discriminator.blocks.{1 + i}"
        p = f"discriminator.blocks.{'_MCDisResBlock' if mc else '_CDisResBlock'}_{i}"
        stride2 = i < len(dh) - 1 - n_tail
        r.sn(f"{b}.conv.{2 if mc else 1}{w}", f"{p}.SNConv_0")
        r.sn(f"{b}.conv.{5 if mc else 3}{w}", f"{p}.SNConv_1")
        if mc:
            r.code(f"{b}.mc_1", f"{p}.mc_1")
            r.code(f"{b}.mc_2", f"{p}.mc_2")
            r.code(f"{b}.conv.1", f"{p}.mc_1")
            r.code(f"{b}.conv.4", f"{p}.mc_2")
        if hasattr(r.mod(p), "SNConv_2"):
            if mc:
                r.sn(f"{b}.shortcut.1.module" if stride2 else f"{b}.shortcut.1", f"{p}.SNConv_2")
                r.code(f"{b}.shortcut.0", f"{p}.mc_1")
            else:
                r.sn(f"{b}.shortcut.0", f"{p}.SNConv_2")
    if mc:
        r.code(f"discriminator.blocks.{len(dh) + 1}", "discriminator.MultimodalController_0")
        r.sn(f"discriminator.blocks.{len(dh) + 3}.module", "discriminator.SNDense_0")
    else:
        r.sn(f"discriminator.blocks.{len(dh) + 2}", "discriminator.SNDense_0")


def _pixelcnn(r, a, mc):
    w = ".module" if mc else ""
    r.sd["embedding.weight"] = r._t(r.mod("embedding").weight.shape)
    for l in range(a["num_layer"]):
        b, p = f"layers.{l}", f"layer_{l}"
        if not mc:
            r.sd[f"{b}.class_cond_embedding.weight"] = r._t(
                r.mod(f"{p}.class_cond_embedding").weight.shape)
        for conv in ("vert_stack", "horiz_stack", "vert_to_horiz"):
            r.conv(f"{b}.{conv}", f"{p}.{conv}")
        for gate in ("gate_v", "gate_h"):
            r.bn(f"{b}.{gate}.bn", f"{p}.{gate}.BatchNorm_0")
            if mc:
                r.code(f"{b}.{gate}.mc", f"{p}.{gate}.MultimodalController_0")
        r.conv(f"{b}.horiz_resid.0{w}", f"{p}.horiz_resid_conv")
        r.bn(f"{b}.horiz_resid.1{w}", f"{p}.horiz_resid_bn")
        if mc:
            r.code(f"{b}.horiz_resid.2", f"{p}.horiz_resid_mc")
    r.conv(f"output_conv.0{w}", "head.Conv_0")
    r.bn(f"output_conv.1{w}", "head.BatchNorm_0")
    if mc:
        r.code("output_conv.3", "head.MultimodalController_0")
    r.conv(f"output_conv.{4 if mc else 3}{w}", "head.Conv_1")


def _glow(r, a, mc):
    w = ".module" if mc else ""
    net_idx = (0, 1, 4, 5, 8) if mc else (0, 1, 3, 4, 6)
    for i in range(a["L"]):
        for k in range(a["K"]):
            f, p = f"blocks.{i}.flows.{k}", f"block_{i}.flow_{k}"
            r.actnorm(f"{f}.actnorm", f"{p}.actnorm")
            ic = r.mod(f"{p}.invconv")
            # the reference's init: the LU factors of a random orthogonal matrix
            q = torch.linalg.qr(r._t(tuple(ic.w_p.shape)))[0]
            w_p, w_l, u = torch.linalg.lu(q)
            d = torch.diagonal(u)
            r.sd.update({f"{f}.invconv.w_p": w_p, f"{f}.invconv.w_l": w_l,
                         f"{f}.invconv.w_u": torch.triu(u, 1),
                         f"{f}.invconv.w_s": torch.log(d.abs()),
                         f"{f}.invconv.s_sign": torch.sign(d)})
            for const in ("u_mask", "l_mask", "l_eye"):
                r.sd[f"{f}.invconv.{const}"] = torch.ones_like(ic.w_p)
            n, pn = f"{f}.coupling.net", f"{p}.coupling.net"
            r.conv(f"{n}.{net_idx[0]}{w}", f"{pn}.Conv_0")
            r.actnorm(f"{n}.{net_idx[1]}{w}", f"{pn}.ActNorm_0")
            r.conv(f"{n}.{net_idx[2]}{w}", f"{pn}.Conv_1")
            r.actnorm(f"{n}.{net_idx[3]}{w}", f"{pn}.ActNorm_1")
            r.zeroconv(f"{n}.{net_idx[4]}{w}", f"{pn}.ZeroConv2d_0")
            if mc:
                r.code(f"{n}.3", f"{pn}.MultimodalController_0")
                r.code(f"{n}.7", f"{pn}.MultimodalController_1")
        r.zeroconv(f"blocks.{i}.prior", f"block_{i}.prior")
        if not mc:  # the reference builds the conditional prior's embedding on every block
            last = f"block_{a['L'] - 1}.embedding"
            out = r.mod(f"block_{i}.prior").scale.shape[0] * (1 if i == a["L"] - 1 else 2)
            modes = r.mod(last).conv.weight.shape[1]
            r.sd[f"blocks.{i}.embedding.conv.weight"] = r._t((out, modes, 1, 1))
            r.sd[f"blocks.{i}.embedding.conv.bias"] = r._t(out)
            r.sd[f"blocks.{i}.embedding.scale"] = r._t((1, out, 1, 1))
            if i == a["L"] - 1:
                assert r.mod(last).conv.weight.shape == (out, modes, 1, 1)


def reference_state_dict(name: str, model, arch: dict, seed: int = 0) -> dict:
    """The reference ``state_dict`` of ``name`` whose dimensions are the
    config section ``arch`` (``cfg['vae']``, ``cfg['gan']`` ...) and whose
    tensors have the shapes of ``model``'s layers."""
    r = _Ref(model, seed)
    a = arch
    {"mcvae": lambda: _vae(r, a, True), "cvae": lambda: _vae(r, a, False),
     "vqvae": lambda: _vqvae(r, a), "classifier": lambda: _classifier(r, a),
     "mcgan": lambda: _gan(r, a, True), "cgan": lambda: _gan(r, a, False),
     "mcpixelcnn": lambda: _pixelcnn(r, a, True), "cpixelcnn": lambda: _pixelcnn(r, a, False),
     "mcglow": lambda: _glow(r, a, True), "cglow": lambda: _glow(r, a, False)}[name]()
    return r.sd
