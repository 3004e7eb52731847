"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``; without a card they skip.
They import neither JAX nor the JAX package, so the card's machine runs
them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerance: ``max|kernel - plain| <= 2e-2 * max|plain|``, both rounded to
bf16 at the output and h rounded to bf16 in both (the kernel's f32 sums run
in another order than cuDNN's). A GAN train step through the kernel against
the same step through the plain version: ``5e-2 * max|plain|`` for the
losses and the first D update's gradients, since the step's bf16 activations
carry the kernel's rounding through D's other layers.
"""

import math

import pytest
import torch

from mcgm_tpu_torch.bench import train_gan
from mcgm_tpu_torch.config import load_config
from mcgm_tpu_torch.kernels import first_dblock as fd
from mcgm_tpu_torch.ops.layers import fold_pool
from mcgm_tpu_torch.train import loop
from mcgm_tpu_torch.train.state import make_gan_train_step

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads: the tests run beside other workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


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
    (256, 32, 32, 3, 128),  # the train step's fused D pass (real and fake)
    (128, 32, 32, 3, 128),  # the train step's G update
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


# ------------------------------------------------------------- train step
D_ITER = 2
TRAIN_TOL = 5e-2
SMALL_GAN = {"latent_size": 32, "generator_hidden_size": [64] * 4,
             "discriminator_hidden_size": [64] * 4, "embedding_size": 8}


def _train_state(dev, plain=False):
    """A small CIFAR10 MCGAN (D's first block at 32x32x3 -> 64, the kernel's
    narrowest C_out) with Adam, B=8, bf16 operands, weights from seed 0."""
    return train_gan.bench_state(train_gan.bench_config(gan=SMALL_GAN, batch=8), dev, plain)


def _d_grads(ts):
    """The gradients D's optimizer sees at each update, by name."""
    seen = []
    ts.d_opt.register_step_pre_hook(lambda *_: seen.append(
        {n: p.grad.clone() for n, p in ts.model.discriminator.named_parameters()}))
    return seen


def test_train_step_launches_the_kernel_in_every_d_pass(dev):
    ts, batch = _train_state(dev)
    seen = _d_grads(ts)
    before = fd.first_dblock.launches
    metrics = make_gan_train_step(D_ITER)(ts, batch)
    torch.cuda.synchronize()
    assert fd.first_dblock.launches == before + D_ITER + 1
    assert all(torch.isfinite(m) for m in metrics.values())
    first = {n: g for n, g in seen[0].items() if n.startswith("blocks._MCFirstDisResBlock_0.")}
    assert len(first) == 6  # SNConv_0/1/2 weights and biases
    for n, g in first.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, n


def test_train_step_kernel_path_matches_plain(dev):
    (ts_k, batch), (ts_p, _) = _train_state(dev), _train_state(dev, plain=True)
    g = torch.Generator(device=dev).manual_seed(4)
    z = [torch.randn((8, SMALL_GAN["latent_size"]), generator=g, device=dev)
         for _ in range(D_ITER + 1)]
    seen_k, seen_p = _d_grads(ts_k), _d_grads(ts_p)
    step = make_gan_train_step(D_ITER)
    got, want = step(ts_k, batch, z=z), step(ts_p, batch, z=z)
    scale = max(abs(w.item()) for w in want.values())  # Loss = Loss_D + Loss_G may be near 0
    for k in want:
        assert abs(got[k].item() - want[k].item()) <= TRAIN_TOL * scale, k
    for n, w in seen_p[0].items():
        err = (seen_k[0][n].float() - w.float()).abs().max().item()
        assert err <= TRAIN_TOL * w.float().abs().max().item(), (n, err)


# ---------------------------------------------------------------- trainer
def test_trainer_epoch_on_the_card(dev, tmp_path):
    """One epoch of the port's trainer on ``Synthetic`` at a small width
    (D's first block at C_out 64): the staged images and every batch stay
    on the card, and ``first_dblock`` launches 6 times per step."""
    cfg = dict(load_config(), data_name="Synthetic", model_name="mcgan",
               output_dir=str(tmp_path), derive_model_params=False, gan=SMALL_GAN,
               derive_batch_size=False, batch_size={"train": 16, "test": 40},
               limit_train_batches=3, num_epochs=1)
    exp = loop.Experiment(cfg)
    assert exp.device.type == "cuda"
    exp.setup()
    seen = []
    step = exp.train_step

    def recording(ts, batch):
        seen.append((batch["img"].device.type, batch["label"].device.type))
        return step(ts, batch)

    exp.setup = lambda: None  # run() would build it all again
    exp.train_step = recording
    before = fd.first_dblock.launches
    exp.run()
    torch.cuda.synchronize()
    assert fd.first_dblock.launches - before == 6 * 3
    assert seen == [("cuda", "cuda")] * 3
    assert exp.loaders["train"].staged()[0].device.type == "cuda"
    assert all(torch.isfinite(torch.tensor(v)).all()
               for k, v in exp.logger.history.items() if k.startswith("train/"))
