"""CPU parity of ``mc_gated_matmul``'s plain backward,
``mc_gated_matmul_backward_reference``, against ``jax.vjp`` of the JAX
expression it differentiates: ``x @ w``, the affine ``* alpha + beta``,
``jax.nn.relu`` and the JAX package's ``mc_gate`` (the Pallas kernel's
reference, whose custom VJP the backward widens to the epilogue). ``x``,
``w``, ``alpha`` and ``beta`` are the differentiable inputs, so ``dalpha``
and ``dbeta`` are held too; the gate's code carries no gradient.

The cases run over ReLU off / on, the gate on / off and P = none (``x
[B, K]``), 16 and 64 positions per sample (the port reads NCHW ``[B, K,
P]`` where the JAX expression is channels-last ``[B, P, K]``), at B = 6,
K = 32, N = 48. Every case's VJP is one JAX program, compiled once at a
low XLA optimisation level. Both sides are f32: ``rtol=1e-5``, ``atol=1e-5
* max|ref|`` (f32 sums in another order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcgm_tpu.ops.controller import mc_gate as jax_mc_gate
from mcgm_tpu_torch.kernels import mc_gate as kmc

B, K, N, MODES = 6, 32, 48, 4
CASES = [(relu, gate, P) for relu in (False, True) for gate in (True, False)
         for P in (None, 16, 64)]
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(i: int, P):
    """Channels-last numpy inputs of case ``i`` and its upstream gradient."""
    rng = np.random.default_rng(100 + i)
    x = rng.standard_normal((B, K) if P is None else (B, P, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    alpha = rng.uniform(0.5, 1.5, N).astype(np.float32)
    beta = (0.1 * rng.standard_normal(N)).astype(np.float32)
    ind = np.eye(MODES, dtype=np.float32)[np.arange(B) % MODES]
    cb = (rng.random((MODES, N)) < 0.5).astype(np.float32)
    g = rng.standard_normal(x.shape[:-1] + (N,)).astype(np.float32)
    return x, w, alpha, beta, ind, cb, g


@pytest.fixture(scope="module")
def cases():
    """Each case's inputs and ``jax.vjp`` in ``(x, w, alpha, beta)``, all
    from one compiled program."""
    inputs = [_inputs(i, P) for i, (_, _, P) in enumerate(CASES)]

    def vjps(args):
        out = []
        for (relu, gate, _), (x, w, alpha, beta, ind, cb, g) in zip(CASES, args):
            def f(x, w, alpha, beta, relu=relu, gate=gate, ind=ind, cb=cb):
                z = x @ w * alpha + beta
                if relu:
                    z = jax.nn.relu(z)
                return jax_mc_gate(z, ind, cb) if gate else z

            out.append(jax.vjp(f, x, w, alpha, beta)[1](g))
        return out

    args = jax.tree_util.tree_map(jnp.asarray, inputs)
    grads = jax.jit(vjps).lower(args).compile(compiler_options=O0)(args)
    return {case: (inputs[i], [np.asarray(v) for v in grads[i]])
            for i, case in enumerate(CASES)}


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _nchw(a, P):
    return a if P is None else a.transpose(0, 2, 1)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _port_args(inputs, relu, gate, P):
    x, w, alpha, beta, ind, cb, g = inputs
    xp, wp = _t(_nchw(x, P)), _t(w.T)
    i, c = (_t(ind), _t(cb)) if gate else (None, None)
    return xp, wp, _t(alpha), _t(beta), i, c, relu, _t(_nchw(g, P))


@pytest.mark.parametrize("relu,gate,P", CASES)
def test_backward_reference_matches_jax_vjp(cases, relu, gate, P):
    """``(dx, dw, dalpha, dbeta)`` of the plain backward (the mask from the
    plain forward's ``out > 0``) against ``jax.vjp``."""
    inputs, (jdx, jdw, jda, jdb) = cases[(relu, gate, P)]
    xp, wp, a, b, i, c, relu, gp = _port_args(inputs, relu, gate, P)
    out = kmc.mc_gated_matmul_reference(xp, wp, a, b, i, c, relu)
    dx, dw, da, db = kmc.mc_gated_matmul_backward_reference(xp, wp, a, b, i, c, relu, gp, out)
    assert dx.shape == xp.shape and dw.shape == wp.shape and da.shape == db.shape == (N,)
    _close(_nchw(dx.numpy(), P), jdx)
    _close(dw.numpy().T, jdw)
    _close(da.numpy(), jda)
    _close(db.numpy(), jdb)


def test_autograd_backward_on_the_cpu_is_the_reference(cases):
    """On CPU tensors the autograd Function's backward is the plain one
    (``backward_variant`` names it), bit-equal, and launches nothing."""
    inputs, _ = cases[(True, True, 16)]
    xp, wp, a, b, i, c, relu, gp = _port_args(inputs, True, True, 16)
    want = kmc.mc_gated_matmul_backward(xp, wp, a, b, i, c, relu, gp)
    assert kmc.backward_variant(xp, wp) == "plain"
    leaves = [t.clone().requires_grad_() for t in (xp, wp, a, b)]
    kmc.mc_gated_matmul(*leaves, i, c, relu).backward(gp)
    for leaf, ref in zip(leaves, want):
        assert torch.equal(leaf.grad, ref)
    assert kmc.mc_gated_matmul.launches == kmc.mc_gated_matmul.backward_launches == 0
