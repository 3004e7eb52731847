"""CPU parity of the PyTorch port's ops against the JAX package's.

Inputs come from ``np.random.default_rng``; the JAX layer is initialised,
its variables are carried into the port with ``from_jax_variables``, and both
run in f32 on the CPU. Tolerance for f32 results that differ only in
summation order: ``rtol=1e-4, atol=1e-5``.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcgm_tpu.models.gan import _MCFirstDisResBlock as JaxFirstBlock
from mcgm_tpu.ops import controller as jc
from mcgm_tpu.ops import layers as jl
from mcgm_tpu_torch.io.jax_import import from_jax_variables
from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.models.gan import _MCFirstDisResBlock
from mcgm_tpu_torch.ops.controller import Seeds
from mcgm_tpu_torch.ops import controller as pc
from mcgm_tpu_torch.ops import layers as pl
from mcgm_tpu_torch.utils import resolve_device

TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def carry(port, variables):
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


# ------------------------------------------------------------- controller
@pytest.mark.parametrize("seed,num_mode,features,rate",
                         [(0, 10, 64, 0.5), (7, 8, 3, 0.5), (123, 5, 128, 0.25)])
def test_make_codebook_rows_identical(seed, num_mode, features, rate):
    want = np.asarray(jc.make_codebook(seed, num_mode, features, rate))
    got = pc.make_codebook(seed, num_mode, features, rate)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("soft", [False, True])
def test_mc_gate(soft):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 5, 5, 16)).astype(np.float32)
    cb = jc.make_codebook(3, 6, 16)
    if soft:  # row-mixing indicators, as the transit/create workflows use
        ind = rng.dirichlet(np.ones(6), size=4).astype(np.float32)
    else:
        ind = np.eye(6, dtype=np.float32)[[0, 5, 2, 2]]
    want = np.asarray(jc.mc_gate(jnp.asarray(x), jnp.asarray(ind), cb))
    got = pc.mc_gate(nchw(x), torch.from_numpy(ind), torch.from_numpy(np.array(cb)))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_one_hot_and_mc_gate_is_detached():
    ind = pc.one_hot(torch.tensor([2, 0]), 3)
    np.testing.assert_array_equal(ind.numpy(), np.eye(3, dtype=np.float32)[[2, 0]])
    cb = torch.ones(3, 4, requires_grad=True)
    x = torch.ones(2, 4, 2, 2, requires_grad=True)
    pc.mc_gate(x, ind, cb).sum().backward()
    assert cb.grad is None and x.grad is not None


# ---------------------------------------------------------------- layers
LAYERS = {
    "conv3x3": (lambda: jl.Conv(8, 3, 1, 1, kernel_init=jl.xavier_uniform),
                lambda: pl.Conv(5, 8, 3, 1, 1)),
    "conv1x1_nobias": (lambda: jl.Conv(8, 1, 1, 0, use_bias=False),
                       lambda: pl.Conv(5, 8, 1, 1, 0, bias=False)),
    "upsampled_conv": (lambda: jl.UpsampledConv(8, use_bias=False),
                       lambda: pl.UpsampledConv(5, 8, bias=False)),
    "conv_s2d": (lambda: jl.ConvS2D(3), lambda: pl.ConvS2D(5, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_conv_layers(name):
    jmod, pmod = LAYERS[name][0](), LAYERS[name][1]()
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 5)).astype(np.float32)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    got = carry(pmod, v)(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_dense():
    x = np.random.default_rng(3).standard_normal((4, 7)).astype(np.float32)
    jmod = jl.Dense(9, kernel_init=jl.xavier_uniform)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    got = carry(pl.Dense(7, 9), v)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jmod.apply(v, x)), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm(train):
    rng = np.random.default_rng(4)
    x = (3 + 2 * rng.standard_normal((4, 6, 6, 8))).astype(np.float32)
    jmod = jl.BatchNorm()
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=True)
    # non-trivial running statistics
    v = {"params": v["params"],
         "batch_stats": {"bn": {"mean": rng.standard_normal(8).astype(np.float32),
                                "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}}
    port = carry(pl.BatchNorm(8), v)
    got = port(nchw(x), train=train)
    if train:
        want, upd = jmod.apply(v, x, use_running_average=False, mutable=["batch_stats"])
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["bn"]["mean"]), **TOL)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["bn"]["var"]), **TOL)
    else:
        want = jmod.apply(v, x, use_running_average=True)
        np.testing.assert_array_equal(port.running_mean.numpy(),
                                      v["batch_stats"]["bn"]["mean"])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_l2_normalize_eps():
    for v in (np.array([3.0, 4.0], np.float32), np.full(4, 1e-13, np.float32)):
        np.testing.assert_allclose(pl._l2_normalize(torch.from_numpy(v)).numpy(),
                                   np.asarray(jl._l2_normalize(jnp.asarray(v))), rtol=1e-6)


SN_LAYERS = {
    "snconv3x3": (lambda: jl.SNConv(8, 3, 1, 1), lambda: pl.SNConv(5, 8, 3, 1, 1), 4),
    "snconv1x1": (lambda: jl.SNConv(8, 1, 1, 0), lambda: pl.SNConv(5, 8, 1, 1, 0), 4),
    "snconvpool": (lambda: jl.SNConvPool(8), lambda: pl.SNConvPool(5, 8), 4),
    "sndense": (lambda: jl.SNDense(3), lambda: pl.SNDense(5, 3), 2),
}


@pytest.mark.parametrize("name", sorted(SN_LAYERS))
@pytest.mark.parametrize("update_stats", [False, True])
def test_spectral_norm_layers(name, update_stats):
    """Eval still runs one power iteration from the stored u but does not
    store it (not torch.nn.utils.spectral_norm's eval); training stores it."""
    jf, pf, ndim = SN_LAYERS[name]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 5) if ndim == 4 else (3, 5)).astype(np.float32)
    jmod = jf()
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = carry(pf(), v)
    u0 = port.u.clone()
    want, upd = jmod.apply(v, x, update_stats=update_stats, mutable=["spectral"])
    got = port(nchw(x) if ndim == 4 else torch.from_numpy(x), update_stats=update_stats)
    got = nhwc(got) if ndim == 4 else got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(port.u.numpy(), np.asarray(upd["spectral"]["u"]), **TOL)
    if not update_stats:
        assert torch.equal(port.u, u0)
    else:
        assert not torch.equal(port.u, u0)


def test_pool_and_residual_functions():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    sc = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(nhwc(pl.avg_pool(nchw(x), 2)),
                               np.asarray(jl.avg_pool(jnp.asarray(x), 2)), **TOL)
    np.testing.assert_allclose(pl.global_sum_pool(nchw(x)).numpy(),
                               np.asarray(jl.global_sum_pool(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        nhwc(pl.add_upsampled_nearest(nchw(x), nchw(sc))),
        np.asarray(jl.add_upsampled_nearest(jnp.asarray(x), jnp.asarray(sc))), **TOL)


# ------------------------------------------------------------- layer VJPs
# name -> (JAX module, port module, input shape, JAX apply kwargs, port kwargs)
VJP_LAYERS = {
    **{n: (jf, pf, (2, 8, 8, 5), {}, {}) for n, (jf, pf) in LAYERS.items()},
    "dense": (lambda: jl.Dense(9, kernel_init=jl.xavier_uniform), lambda: pl.Dense(7, 9),
              (4, 7), {}, {}),
    "batchnorm_train": (jl.BatchNorm, lambda: pl.BatchNorm(5), (4, 6, 6, 5),
                        {"use_running_average": False, "mutable": ["batch_stats"]},
                        {"train": True}),
    **{f"{n}_update_{us}": (jf, pf, (2, 8, 8, 5) if nd == 4 else (3, 5),
                            {"update_stats": us, "mutable": ["spectral"]}, {"update_stats": us})
       for n, (jf, pf, nd) in SN_LAYERS.items() for us in (False, True)},
}


def _nhwc_out(t):
    return t.permute(0, 2, 3, 1) if t.ndim == 4 else t


def _port_in(a):
    return (nchw(a) if a.ndim == 4 else torch.from_numpy(a)).requires_grad_(True)


def _assert_grads_close(got, want, what):
    """f32 sums in another order: ``rtol=1e-4, atol=1e-5 * max|grad|``."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("name", sorted(VJP_LAYERS))
def test_layer_vjp_matches_jax(name):
    """Each ported layer's gradient with respect to its input and every
    parameter, against ``jax.vjp`` of the JAX layer at the same cotangent
    (the train step's backward is built from these)."""
    jf, pf, shape, jkw, pkw = VJP_LAYERS[name]
    rng = np.random.default_rng(9)
    x = rng.standard_normal(shape).astype(np.float32)
    jmod = jf()
    init_kw = {k: a for k, a in jkw.items() if k != "mutable"}
    v = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), **init_kw)

    def f(params, xx):
        out = jmod.apply({**v, "params": params}, xx, **jkw)
        return out[0] if "mutable" in jkw else out

    port = carry(pf(), v)
    xt = _port_in(x)
    y = _nhwc_out(port(xt, **pkw))
    ct = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    (y * torch.from_numpy(ct)).sum().backward()
    # one compiled program: cheaper than the VJP's eager dispatches
    gp, gx = jax.jit(lambda p, xx, c: jax.vjp(f, p, xx)[1](c))(v["params"], x, ct)
    _assert_grads_close(_nhwc_out(xt.grad), gx, "x")
    want = from_jax_variables({"params": gp})
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for n, g in got.items():
        _assert_grads_close(g, want[n].numpy(), n)


_CB = jc.make_codebook(3, 6, 4)
_IND = np.eye(6, dtype=np.float32)[[0, 5, 2, 2]]
# name -> (JAX function, port function, input shapes, NHWC)
VJP_FUNCTIONS = {
    "mc_gate": (lambda x: jc.mc_gate(x, jnp.asarray(_IND), _CB),
                lambda x: pc.mc_gate(x, torch.from_numpy(_IND), torch.from_numpy(np.array(_CB))),
                [(4, 5, 5, 4)]),
    "avg_pool": (lambda x: jl.avg_pool(x, 2), lambda x: pl.avg_pool(x, 2), [(2, 8, 8, 4)]),
    "global_sum_pool": (jl.global_sum_pool, pl.global_sum_pool, [(2, 8, 8, 4)]),
    "add_upsampled_nearest": (jl.add_upsampled_nearest, pl.add_upsampled_nearest,
                              [(2, 8, 8, 4), (2, 4, 4, 4)]),
}


@pytest.mark.parametrize("name", sorted(VJP_FUNCTIONS))
def test_function_vjp_matches_jax(name):
    """The parameter-free ops of the GAN path: gradients with respect to
    every input against ``jax.vjp`` (the mode code carries none)."""
    jf, pf, shapes = VJP_FUNCTIONS[name]
    rng = np.random.default_rng(10)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ins = [_port_in(a) for a in xs]
    y = _nhwc_out(pf(*ins))
    ct = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    (y * torch.from_numpy(ct)).sum().backward()
    want = jax.jit(lambda c, *a: jax.vjp(jf, *a)[1](c))(ct, *xs)
    for i, (t, w) in enumerate(zip(ins, want)):
        _assert_grads_close(_nhwc_out(t.grad), w, f"input {i}")


def test_initializers():
    g = torch.Generator().manual_seed(0)
    conv = pl.SNConv(16, 32, 3, generator=g)
    bound = np.sqrt(6.0 / (16 * 9 + 32 * 9))  # xavier-uniform, as jl.xavier_uniform
    w = conv.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    b = conv.bias.detach().numpy()
    assert np.abs(b).max() <= 1 / np.sqrt(16 * 9)  # torch-uniform bias
    np.testing.assert_allclose(np.linalg.norm(conv.u.numpy()), 1.0, rtol=1e-6)
    s = pl.BatchNorm(4096, generator=g).weight.detach().numpy()
    assert abs(s.mean() - 1) < 3e-3 and abs(s.std() - 0.02) < 2e-3


def test_resolve_compute_dtype():
    assert pl.resolve_compute_dtype("auto", "cpu") == torch.float32
    assert pl.resolve_compute_dtype("auto", "cuda") == torch.bfloat16
    assert pl.resolve_compute_dtype("bf16", "cpu") == torch.bfloat16
    with pytest.raises(ValueError):
        pl.resolve_compute_dtype("fp8", "cpu")


# ------------------------------------------------------------ first block
@pytest.fixture(scope="module")
def first_block_case():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 16, 12, 3)).astype(np.float32)
    labels = np.array([0, 3, 1])
    ind = np.eye(4, dtype=np.float32)[labels]
    jmod = JaxFirstBlock(8, 4, 0.5)
    v = jax.jit(lambda k: jmod.init(k, jnp.asarray(x), jnp.asarray(ind), False))(
        jax.random.PRNGKey(2))
    v = jax.tree_util.tree_map(np.asarray, v)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), jnp.asarray(ind), False))
    return x, ind, v, want


def test_first_block_module_matches_jax(first_block_case):
    x, ind, v, want = first_block_case
    port = carry(_MCFirstDisResBlock(3, 8, 4, 0.5, Seeds(torch.Generator())), v)
    before = fd.first_dblock.launches
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(ind), False)
    np.testing.assert_allclose(nhwc(got), want, **TOL)
    assert fd.first_dblock.launches == before  # the CPU path launches nothing


def test_first_dblock_reference_matches_jax(first_block_case):
    """The plain version, fed the SN-normalised, pool-folded HWIO weights the
    block's prologue builds, is the JAX block's function."""
    x, ind, v, want = first_block_case
    got = fd.first_dblock_reference(torch.from_numpy(x), *_first_block_operands(v, ind))
    assert got.shape == (3, 8, 6, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cin,cout", [(3, 64), (1, 128)])
def test_first_dblock_weight_packing_round_trips(cin, cout):
    """The layouts the kernel reads: w1 as [Cout, K] (k = (dy*3+dx)*Cin + ci,
    zero-padded to K), w2f as [tap = ky*4+kx, Cout(out), Cout(in)]."""
    rng = np.random.default_rng(11)
    w1 = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    w2f = torch.from_numpy(rng.standard_normal((4, 4, cout, cout)).astype(np.float32))
    k = fd.conv1_depth(cin)
    assert k % 16 == 0 and 9 * cin <= k < 9 * cin + 16
    for dt in (torch.float32, torch.bfloat16):  # the kernel is handed bf16
        w1p, w2p = fd.pack_w1(w1.to(dt)), fd.pack_w2f(w2f.to(dt))
        assert w1p.shape == (cout, k) and w1p.dtype == dt and w1p.is_contiguous()
        assert w2p.shape == (16, cout, cout) and w2p.dtype == dt and w2p.is_contiguous()
        assert not w1p[:, 9 * cin:].any()
        dy, dx, ci, co = 2, 1, cin - 1, cout - 3
        assert w1p[co, (dy * 3 + dx) * cin + ci] == w1[dy, dx, ci, co].to(dt)
        assert w2p[3 * 4 + 2, co, 5] == w2f[3, 2, 5, co].to(dt)
        assert torch.equal(_unpack_w1(w1p, cin), w1.to(dt))
        assert torch.equal(_unpack_w2f(w2p), w2f.to(dt))


def _unpack_w1(w1p, cin):
    """Inverse of ``pack_w1``: [Cout, K] -> HWIO."""
    return w1p[:, :9 * cin].t().reshape(3, 3, cin, w1p.shape[0])


def _unpack_w2f(w2p):
    """Inverse of ``pack_w2f``: [16, Cout(out), Cout(in)] -> HWIO."""
    c = w2p.shape[-1]
    return w2p.reshape(4, 4, c, c).permute(0, 1, 3, 2)


def _first_block_operands(v, ind):
    """The kernel's operands as the block's prologue builds them (HWIO)."""
    p, u = v["params"], v["spectral"]
    w1, w2, w3 = (_sn_numpy(p[n]["kernel"], u[n]["u"])
                  for n in ("SNConv_0", "SNConv_1", "SNConv_2"))
    w2f = np.asarray(jl._fold_pool_axis(jl._fold_pool_axis(jnp.asarray(w2), 0), 1))
    code = ind @ v["codebook"]["mc_1"]["codebook"]
    return [torch.from_numpy(np.array(a)) for a in  # writable copies
            (code, w1, p["SNConv_0"]["bias"], w2f, p["SNConv_1"]["bias"],
             w3.reshape(w1.shape[2], -1), p["SNConv_2"]["bias"])]


def test_first_dblock_reference_on_unpacked_operands_matches_jax(first_block_case):
    """The packed layouts lose nothing: w1 and w2f packed (here in f32) and
    unpacked again still give the JAX block's function."""
    x, ind, v, want = first_block_case
    code, w1, b1, w2f, b2, w3, b3 = _first_block_operands(v, ind)
    w1u = _unpack_w1(fd.pack_w1(w1), w1.shape[2])
    w2u = _unpack_w2f(fd.pack_w2f(w2f))
    got = fd.first_dblock_reference(torch.from_numpy(x), code, w1u, b1, w2u, b2, w3, b3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_first_block_gradient_matches_jax_grad(first_block_case):
    """The port's block on the CPU (the plain path, which the card's backward
    recomputes) has the JAX block's gradient with respect to x and every
    parameter, in f32. Tolerance: f32 sums in another order,
    ``rtol=1e-4, atol=1e-5 * max|grad|``."""
    x, ind, v, _ = first_block_case
    ct = np.random.default_rng(8).standard_normal((3, 8, 6, 8)).astype(np.float32)
    jmod = JaxFirstBlock(8, 4, 0.5)
    rest = {k: v[k] for k in v if k != "params"}

    def loss(params, xx):
        y = jmod.apply(dict(rest, params=params), xx, jnp.asarray(ind), False)
        return jnp.sum(y * ct)

    gp, gx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    port = carry(_MCFirstDisResBlock(3, 8, 4, 0.5, Seeds(torch.Generator())), v)
    xt = nchw(x).requires_grad_(True)
    (port(xt, torch.from_numpy(ind), False) * nchw(ct)).sum().backward()
    pairs = [(xt.grad.permute(0, 2, 3, 1), gx)]
    for name in ("SNConv_0", "SNConv_1", "SNConv_2"):
        mod = getattr(port, name)
        pairs.append((mod.weight.grad.permute(2, 3, 1, 0), gp[name]["kernel"]))
        pairs.append((mod.bias.grad, gp[name]["bias"]))
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def _sn_numpy(kernel, u):
    """The JAX package's one power iteration (layers.py _spectral_normalize)."""
    mat = kernel.reshape(-1, kernel.shape[-1]).T
    v = mat.T @ u
    v = v / (np.linalg.norm(v) + 1e-12)
    u_new = mat @ v
    u_new = u_new / (np.linalg.norm(u_new) + 1e-12)
    return kernel / (u_new @ mat @ v)


def test_first_dblock_wrapper_checks():
    """What the CUDA kernel does not take is refused before any launch."""
    z = torch.zeros

    def args(B=2, H=8, W=8, cin=3, cout=64, dtype=torch.bfloat16):
        return [z(B, H, W, cin, dtype=dtype), z(B, cout), z(3, 3, cin, cout), z(cout),
                z(4, 4, cout, cout), z(cout), z(cin, cout), z(cout)]

    fd._check(*args())
    fd._check(*args(cin=1, cout=128, H=6, W=10))
    with pytest.raises(TypeError):
        fd._check(*args(dtype=torch.float32))
    for bad in (dict(H=7), dict(cin=2), dict(cout=96)):
        with pytest.raises(ValueError):
            fd._check(*args(**bad))
    a = args()
    a[4] = z(3, 3, 64, 64)  # unfolded 3x3 kernel
    with pytest.raises(ValueError):
        fd._check(*a)
    with pytest.raises(ValueError):
        fd._check(args()[0].permute(0, 2, 1, 3), *args()[1:])


def test_first_dblock_phase_tool_finds_its_places():
    """``bench/first_dblock_phases.py`` compiles phases out of a copy of the
    kernel source at fixed anchors; each must still occur once, in order."""
    from mcgm_tpu_torch.bench import first_dblock_phases as ph
    src = ph.guarded_source()
    at = [src.index(text + anchor) for anchor, text in ph.GUARDS]
    assert at == sorted(at)
    assert src.count("#ifndef NO_CONV1") == src.count("#ifndef NO_CONV2") == 1


# ---------------------------------------------------------- package rules
def test_port_imports_no_jax_and_no_jax_package():
    banned = {"jax", "jaxlib", "flax", "optax", "mcgm_tpu"}
    files = sorted((ROOT / "mcgm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, f"{path}: imports {m}"


def test_resolve_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
