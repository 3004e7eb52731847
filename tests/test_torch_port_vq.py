"""CPU parity of the port's VQ-VAE layers against the JAX package:
``ConvTranspose`` (forward and VJP) and ``VectorQuantizerEMA`` (codes,
``quantize``, the commitment ``diff`` and, in train mode, the three buffers
after one EMA update, with and without a sample mask ``w``), and the plain
versions of the two VQ kernels, which the CPU runs.

Inputs and variables come from numpy seeds; both packages run f32.
Tolerances:

- ``ConvTranspose``: outputs and each VJP term ``rtol=1e-5``,
  ``atol=1e-5 * max|ref|`` (f32 sums in another order);
- the quantizer: codes equal (the inputs keep every row's two best codes
  apart by far more than f32 rounding); ``quantize`` and the gathered
  codebook rows equal; ``diff``, ``cluster_size``, ``embedding_mean`` and
  ``embedding`` ``rtol=1e-6``, ``atol=1e-6 * max|ref|`` (one f32 matrix
  product and one sum in two libraries);
- ties: a codebook with duplicated columns gives the lowest index, as
  ``jnp.argmin`` does.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcgm_tpu.ops.layers import ConvTranspose as JaxConvTranspose
from mcgm_tpu.ops.vq import VectorQuantizerEMA as JaxVQ
from mcgm_tpu_torch.io.jax_import import from_jax_variables, to_jax_gan_variables
from mcgm_tpu_torch.kernels import vq as kvq
from mcgm_tpu_torch.ops.layers import ConvTranspose
from mcgm_tpu_torch.ops.vq import VectorQuantizerEMA

D, K = 8, 16


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ ConvTranspose
@pytest.mark.parametrize("shape", [(2, 6, 6, 3, 5), (1, 4, 4, 8, 1)])
def test_conv_transpose_matches_jax(shape):
    """Forward and VJP against the JAX layer, whose HWIO kernel the port
    holds transposed (2, 3, 0, 1) and unflipped; the kernels are random, so
    no symmetry hides a flip. Output side ``(H - 1) * 2 - 2 + 4 = 2 H``."""
    B, H, W, cin, cout = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    kernel = rng.standard_normal((4, 4, cin, cout)).astype(np.float32) / 4
    bias = rng.standard_normal(cout).astype(np.float32)
    g = rng.standard_normal((B, 2 * H, 2 * W, cout)).astype(np.float32)
    jm = JaxConvTranspose(cout, 4, 2, 1)
    v = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    want, vjp = jax.vjp(lambda v, x: jm.apply(v, x), v, jnp.asarray(x))
    gv, gx = vjp(jnp.asarray(g))

    port = ConvTranspose(cin, cout)
    state = from_jax_variables({"params": {"ConvTranspose_0": v["params"]}})
    port.load_state_dict({k.partition(".")[2]: t for k, t in state.items()})
    assert tuple(port.weight.shape) == (cin, cout, 4, 4)
    np.testing.assert_array_equal(to_jax_gan_variables(port)["params"]["kernel"], kernel)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = port(xt)
    assert tuple(y.shape) == (B, cout, 2 * H, 2 * W)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    _close(y.detach().permute(0, 2, 3, 1), want, 1e-5)
    _close(xt.grad.permute(0, 2, 3, 1), gx, 1e-5)
    _close(port.weight.grad.permute(2, 3, 0, 1), gv["params"]["kernel"], 1e-5)
    _close(port.bias.grad, gv["params"]["bias"], 1e-5)


# ---------------------------------------------------------------- quantizer
def _stats(rng):
    emb = rng.standard_normal((D, K)).astype(np.float32)
    cs = rng.uniform(1.0, 3.0, K).astype(np.float32)
    return {"embedding": emb, "cluster_size": cs,
            "embedding_mean": (emb * cs + 0.1 * rng.standard_normal((D, K))).astype(np.float32)}


def _inputs(rng, stats, B=4, side=4):
    """Rows near codes (noise 0.05 of a code's spread): every row's best
    code beats its second by far more than f32 rounding."""
    pick = rng.integers(0, K, (B, side, side))
    x = stats["embedding"].T[pick] + 0.05 * rng.standard_normal((B, side, side, D))
    return x.astype(np.float32)


@pytest.mark.parametrize("train,masked", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_quantizer_matches_jax(train, masked):
    rng = np.random.default_rng(1)
    stats = _stats(rng)
    x = _inputs(rng, stats)
    w = np.array([1, 0, 1, 1], np.float32) if masked else None
    jm = JaxVQ(D, K)
    (jq, jdiff, jcode), jvars = jm.apply(
        {"vq_stats": {k: jnp.asarray(a) for k, a in stats.items()}}, jnp.asarray(x),
        train=train, w=None if w is None else jnp.asarray(w), mutable=["vq_stats"])

    port = VectorQuantizerEMA(D, K)
    port.load_state_dict({k: torch.from_numpy(a.copy()) for k, a in stats.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    q, diff, code = port(xt, train=train, w=None if w is None else torch.from_numpy(w))
    assert code.dtype == torch.int32 and tuple(code.shape) == (4, 4, 4)
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(jq))
    _close(diff.detach(), jdiff, 1e-6)
    for k, want in jvars["vq_stats"].items():
        got = getattr(port, k).numpy()
        if train:
            _close(got, want, 1e-6)
            assert not np.array_equal(got, stats[k]), k
        else:
            np.testing.assert_array_equal(got, stats[k])
    # the straight-through gradient: identity through q, plus diff's
    (q.sum() + diff).backward()
    n = x.size if w is None else x[w > 0].size
    want_grad = 1 + 2 * (x - np.asarray(jq)) / n * (1 if w is None else w[:, None, None, None])
    _close(xt.grad, want_grad, 1e-5)


def test_quantizer_buffers_in_the_jax_tree():
    """``embedding_mean`` starts as a copy of ``embedding``, and the three
    buffers sit in the JAX package's ``vq_stats`` collection, both ways."""
    port = VectorQuantizerEMA(D, K, generator=torch.Generator().manual_seed(0))
    assert torch.equal(port.embedding, port.embedding_mean)
    assert port.embedding.data_ptr() != port.embedding_mean.data_ptr()
    assert torch.equal(port.cluster_size, torch.zeros(K))
    tree = to_jax_gan_variables(port)
    assert set(tree) == {"vq_stats"} and set(tree["vq_stats"]) == set(port.state_dict())
    back = from_jax_variables({"vq_stats": {"quantizer": tree["vq_stats"]}})
    assert all(torch.equal(back[f"quantizer.{k}"], t) for k, t in port.state_dict().items())


def test_embedding_code_gathers_codebook_rows():
    port = VectorQuantizerEMA(D, K, generator=torch.Generator().manual_seed(2))
    code = torch.tensor([[3, 0], [15, 3]], dtype=torch.int32)
    want = JaxVQ.embedding_code_from(jnp.asarray(port.embedding.numpy()), jnp.asarray(code))
    np.testing.assert_array_equal(port.embedding_code(code).numpy(), np.asarray(want))


# ------------------------------------------------------------ plain versions
def test_assign_ties_go_to_the_lowest_code():
    """Duplicated columns: every row's distance ties between two codes; the
    plain version (and the kernel, on the card) picks the lower, as
    ``jnp.argmin`` does. On a CPU tensor the wrapper runs the plain version
    and launches nothing."""
    rng = np.random.default_rng(3)
    half = rng.standard_normal((D, K // 2)).astype(np.float32)
    emb = np.concatenate([half, half], 1)[:, rng.permutation(K)]
    flat = rng.standard_normal((37, D)).astype(np.float32)
    before = kvq.vq_assign.launches
    code, q = kvq.vq_assign(torch.from_numpy(flat), torch.from_numpy(emb))
    assert kvq.vq_assign.launches == before
    dist = ((flat ** 2).sum(1, keepdims=True) - 2 * flat @ emb + (emb ** 2).sum(0, keepdims=True))
    want = np.asarray(jnp.argmin(jnp.asarray(dist), axis=1))
    np.testing.assert_array_equal(code.numpy(), want)
    for n, k in enumerate(code.numpy()):
        twin = [j for j in range(K) if j != k and np.array_equal(emb[:, j], emb[:, k])]
        assert twin and twin[0] > k
    np.testing.assert_array_equal(q.numpy(), emb.T[code.numpy()])


@pytest.mark.parametrize("N,codes,weighted", [
    (20, K, True),
    # the card's cases: one row, every row on one code or on three (a
    # train step's codes collapse), the digits' ragged batch of 17 grids
    (1, K, False), (300, 1, False), (300, 3, True), (17 * 64, K, True),
    # a chunk of 64 rows exactly, one row past it, every code used once;
    # the card's check at N 3,000, D 8, K 16, masked
    (64, K, False), (65, K, True), (K, K, False), (3000, K, True),
])
def test_ema_plain_version_matches_a_direct_count(N, codes, weighted):
    """``vq_ema`` on CPU tensors runs the plain version, in place, and
    launches nothing; held to per-code counts and sums taken with
    ``index_add_`` (exact counts; sums ``rtol=1e-6``)."""
    rng = np.random.default_rng(4)
    stats = {k: torch.from_numpy(a) for k, a in _stats(rng).items()}
    flat = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    code = torch.from_numpy((rng.integers(0, codes, N) * (K // codes)).astype(np.int32))
    w = torch.from_numpy((rng.random(N) < 0.7 if weighted else np.ones(N)).astype(np.float32))
    bufs = {k: t.clone() for k, t in stats.items()}
    before = kvq.vq_ema.launches
    kvq.vq_ema(flat, code, w, bufs["cluster_size"], bufs["embedding_mean"], bufs["embedding"],
               0.99, 1e-5)
    assert kvq.vq_ema.launches == before
    counts = torch.zeros(K).index_add_(0, code.long(), w)
    sums = torch.zeros((K, D)).index_add_(0, code.long(), flat * w[:, None]).t()
    cs = stats["cluster_size"] * 0.99 + counts * 0.01
    mean = stats["embedding_mean"] * 0.99 + sums * 0.01
    n = cs.sum()
    assert torch.equal(bufs["cluster_size"], cs)
    _close(bufs["embedding_mean"], mean, 1e-6)
    _close(bufs["embedding"], mean / ((cs + 1e-5) / (n + K * 1e-5) * n), 1e-6)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kvq.vq_assign(meta, torch.empty((D, K), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        kvq.vq_ema(meta, None, None, None, None, None, 0.99, 1e-5)
