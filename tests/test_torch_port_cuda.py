"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``; without a card they skip.
They import neither JAX nor the JAX package, so the card's machine runs
them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerance: ``max|kernel - plain| <= 2e-2 * max|plain|``, both rounded to
bf16 at the output and h rounded to bf16 in both (the kernel's f32 sums run
in another order than cuDNN's).
"""

import math

import pytest
import torch

from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.ops.layers import fold_pool

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False  # the plain version is an f32 reference
    return torch.device("cuda")


def _args(dev, B, H, W, cin, cout, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale

    x = (torch.rand((B, H, W, cin), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    code = (torch.rand((B, cout), generator=g, device=dev) < 0.5).float()
    w1 = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
    w2f = fold_pool(randn(cout, cout, 3, 3, scale=1 / math.sqrt(9 * cout)))
    w3 = randn(cin, cout, scale=1 / math.sqrt(cin))
    return [x, code, w1, randn(cout, scale=0.1), w2f.permute(2, 3, 1, 0).contiguous(),
            randn(cout, scale=0.1), w3, randn(cout, scale=0.1)]


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 3, 64),       # one tile, mostly padding
    (3, 32, 32, 3, 128),    # C_out 128
    (2, 30, 70, 1, 64),     # ragged rows (Ho 15) and columns (Wo 35 > one tile)
    (1, 6, 66, 1, 128),     # Wo 33: a column tile of one
    (4, 128, 128, 3, 64),   # the 128px MCGAN first block
    (16, 128, 128, 3, 64),  # the class sweep's tail chunk
    (1, 128, 128, 3, 64),   # 32 work items: fewer than the persistent grid's blocks
    (5, 128, 128, 3, 64),   # 160 work items: not a multiple of the grid
    (512, 32, 32, 3, 128),  # CIFAR's test batch
])
def test_first_dblock_matches_plain(dev, shape):
    B, H, W, cin, cout = shape
    args = _args(dev, *shape)
    before = fd.first_dblock.launches
    y = fd.first_dblock(*args)
    torch.cuda.synchronize()
    assert fd.first_dblock.launches == before + 1
    ref = fd.first_dblock_reference(*args)
    assert y.shape == ref.shape == (B, H // 2, W // 2, cout) and y.dtype == torch.bfloat16
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= TOL * ref.float().abs().max().item()


def test_first_dblock_refuses_what_it_does_not_take(dev):
    args = _args(dev, 2, 8, 8, 3, 64)
    with pytest.raises(TypeError):
        fd.first_dblock(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        fd.first_dblock(args[0][:, :7], *args[1:])
    with pytest.raises(ValueError):
        fd.first_dblock(*_args(dev, 2, 8, 8, 2, 64))


@pytest.mark.parametrize("shape", [(2, 16, 12, 3, 64), (2, 8, 12, 1, 128)])
def test_first_dblock_gradient_matches_plain(dev, shape):
    """On the card the kernel is differentiable: its backward is the plain
    version's VJP in f32, so its gradients match the plain version's own
    autograd gradients (h and y rounded to bf16 in both forwards)."""
    args = _args(dev, *shape)
    grad_at = (0, 2, 3, 4, 5, 6, 7)  # every input but code
    gy = torch.randn(args[0].shape[0], shape[1] // 2, shape[2] // 2, shape[4],
                     generator=torch.Generator(device=dev).manual_seed(9), device=dev)

    def grads(fn):
        leaves = [a.detach().clone().requires_grad_(i in grad_at) for i, a in enumerate(args)]
        y = fn(*leaves)
        return torch.autograd.grad(y, [leaves[i] for i in grad_at], gy.to(y.dtype))

    before = fd.first_dblock.launches
    got = grads(fd.first_dblock)
    assert fd.first_dblock.launches == before + 1
    want = grads(fd.first_dblock_reference)
    for i, g, w in zip(grad_at, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL * w.float().abs().max().item(), (i, err)
