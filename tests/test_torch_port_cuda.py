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
    (256, 32, 32, 1, 64),   # the real-digit (MNIST) MCGAN's fused D pass
    (128, 32, 32, 1, 64),   # and its G update
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


@pytest.mark.parametrize("flags", [dict(fuse_g_pass=True), dict(remat=True),
                                   dict(fuse_g_pass=True, remat=True)])
def test_train_step_fused_g_pass_and_remat_match_the_plain_step(dev, flags):
    """The step with ``fuse_g_pass`` (one G pass at ``D_ITER * B``) and / or
    ``remat`` against the plain step from the same state and z, both through
    the kernel: losses and the first D update's gradients within
    ``TRAIN_TOL * max|plain|``; BatchNorm statistics and ``u`` within it
    too; ``first_dblock`` once per D pass, and again in each recompute."""
    (ts_f, batch), (ts_p, _) = _train_state(dev), _train_state(dev)
    g = torch.Generator(device=dev).manual_seed(4)
    z = [torch.randn((8, SMALL_GAN["latent_size"]), generator=g, device=dev)
         for _ in range(D_ITER + 1)]
    seen_f, seen_p = _d_grads(ts_f), _d_grads(ts_p)
    before = fd.first_dblock.launches
    got = make_gan_train_step(D_ITER, **flags)(ts_f, batch, z=z)
    torch.cuda.synchronize()
    launches = fd.first_dblock.launches - before
    want = make_gan_train_step(D_ITER)(ts_p, batch, z=z)
    assert launches == (D_ITER + 1) * (2 if flags.get("remat") else 1)
    scale = max(abs(w.item()) for w in want.values())
    for k in want:
        assert abs(got[k].item() - want[k].item()) <= TRAIN_TOL * scale, k
    for n, w in seen_p[0].items():
        err = (seen_f[0][n].float() - w.float()).abs().max().item()
        assert err <= TRAIN_TOL * w.float().abs().max().item(), (n, err)
    sf = ts_f.model.state_dict()
    for k, b in ts_p.model.state_dict().items():
        if k.endswith(("running_mean", "running_var", ".u")):
            assert (sf[k] - b).abs().max() <= TRAIN_TOL * b.abs().max(), k


def test_cgan_train_step_matches_f32(dev):
    """A small CIFAR10 CGAN step in bf16 on the card against the same step
    in f32 (its first block, 3 + 8 channels, runs plain cuDNN: no kernel
    launch), within the step tolerance."""
    cfg = train_gan.bench_config(gan=SMALL_GAN, batch=8, model_name="cgan")
    (ts_b, batch), (ts_f, _) = (train_gan.bench_state(cfg, dev),
                                train_gan.bench_state(dict(cfg, compute_dtype="float32"), dev))
    assert ts_b.model.compute_dtype == torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4)
    z = [torch.randn((8, SMALL_GAN["latent_size"]), generator=g, device=dev)
         for _ in range(D_ITER + 1)]
    seen_b, seen_f = _d_grads(ts_b), _d_grads(ts_f)
    step = make_gan_train_step(D_ITER)
    before = fd.first_dblock.launches
    got, want = step(ts_b, batch, z=z), step(ts_f, batch, z=z)
    assert fd.first_dblock.launches == before
    scale = max(abs(w.item()) for w in want.values())
    for k in want:
        assert abs(got[k].item() - want[k].item()) <= TRAIN_TOL * scale, k
    for n, w in seen_f[0].items():
        err = (seen_b[0][n].float() - w.float()).abs().max().item()
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


# ------------------------------------------------------------- VQ kernels
VQ_D, VQ_K = 64, 512  # the CIFAR10 VQ-VAE's codebook


def _vq_inputs(dev, N, tie=False, seed=0, D=VQ_D, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn((N, D), generator=g, device=dev)
    if tie:  # every column twice, at shuffled places
        half = torch.randn((D, VQ_K // 2), generator=g, device=dev)
        emb = torch.cat([half, half], 1)[:, torch.randperm(VQ_K, generator=g, device=dev)]
    else:
        emb = torch.randn((D, VQ_K), generator=g, device=dev)
    return (flat * scale).contiguous(), (emb * scale).contiguous()


def _vq_case(dev, kind, N):
    """(flat, emb) of the vq_assign case ``kind`` with ``N`` rows. The near
    ties and a VQ-VAE train step's rows are the card check's own: rows at
    the midpoint of two codes moved by 0 to 30 x the cross term's TF32
    rounding, both signs; the full-width CIFAR10 VQ-VAE's rows and codebook
    after 13 steps on one batch of 128 (their codes fall on a few; an unused
    code's column is ~1/eps larger)."""
    import chip_smoke as cs  # imports neither JAX nor the JAX package

    if kind == "near ties":
        return cs.vq_near_tie_inputs(N, VQ_D, VQ_K, seed=0)
    if kind == "step":
        flat, _, bufs = cs.vq_step_inputs(cs.vqvae_cfg(), 13)
        assert len(flat) == N
        return flat, bufs["embedding"]
    return {"random": lambda: _vq_inputs(dev, N),
            "ties": lambda: _vq_inputs(dev, N, tie=True),
            "large norms": lambda: _vq_inputs(dev, N, seed=2, scale=30.0),
            "D 256": lambda: _vq_inputs(dev, N, seed=3, D=256),
            "D 12": lambda: _vq_inputs(dev, N, seed=4, D=12)}[kind]()


@pytest.mark.parametrize("kind,N,variant", [
    ("random", 128 * 64, "tf32"),     # a train step's codes
    ("random", 17 * 64, "tf32"),      # the digits' ragged batch
    ("ties", 4096, "tf32"),           # every column twice: the lower code
    ("near ties", 4096, "tf32"),      # the two best within 0 to 30 x the TF32 rounding
    ("large norms", 8192, "tf32"),    # rows and codebook scaled by 30
    ("D 256", 4096, "tf32"),          # the codebook in chunks
    ("step", 128 * 64, "tf32"),       # a VQ-VAE train step's own rows and codebook
    ("D 12", 1000, "ffma"),           # a D the tensor-core kernel does not take
    # 512 tiles on 132 SMs: several tiles a block, most rows decided in f32
    ("ties", 512 * 64, "tf32"),
    ("near ties", 512 * 64, "tf32"),
    ("D 256", 512 * 64, "tf32"),      # the chunked codebook reloaded per tile
])
def test_vq_assign_matches_plain(dev, kind, N, variant):
    """Codes equal to the plain version's wherever the best two codes are
    further apart than ``1e-5 * (|x|^2 + max|e|^2)`` (f32 sums in another
    order), the chosen code within that margin of the least everywhere, q
    the chosen columns; ties go to the lower code; one launch, through the
    kernel the C entry point names."""
    from mcgm_tpu_torch.kernels import vq as kvq

    flat, emb = _vq_case(dev, kind, N)
    assert kvq.assign_variant(flat.shape[0], flat.shape[1], emb.shape[1]) == variant
    before = kvq.vq_assign.launches
    code, q = kvq.vq_assign(flat, emb)
    assert kvq.vq_assign.launches == before + 1
    ref, _ = kvq.vq_assign_reference(flat, emb)
    d = ((flat.double() ** 2).sum(1, keepdim=True) - 2 * flat.double() @ emb.double()
         + (emb.double() ** 2).sum(0, keepdim=True))
    top2 = d.topk(2, dim=1, largest=False).values
    margin = 1e-5 * ((flat.double() ** 2).sum(1) + (emb.double() ** 2).sum(0).max())
    clear = top2[:, 1] - top2[:, 0] > margin
    assert torch.equal(code[clear], ref[clear])
    assert (d.gather(1, code.long()[:, None])[:, 0] - top2[:, 0] <= margin).all()
    assert torch.equal(q, emb.t()[code.long()])
    if kind == "ties":
        lowest = (emb.t()[:, None, :] == emb.t()[None, :, :]).all(-1).int().argmax(1)
        assert torch.equal(code.long(), lowest[code.long()])


@pytest.mark.parametrize("kind,N", [("random", 128 * 64), ("near ties", 4096), ("ties", 4096),
                                    ("near ties", 512 * 64), ("D 256", 512 * 64)])
def test_vq_assign_two_launches_are_bit_equal(dev, kind, N):
    """No order in the search changes from run to run: two launches on the
    same inputs give bit-equal codes and rows; the rows the screen left to
    exact f32 distances are counted, against every code and by their two
    best codes (all rows where every column is twice)."""
    from mcgm_tpu_torch.kernels import vq as kvq

    flat, emb = _vq_case(dev, kind, N)
    rescored = torch.zeros(2, dtype=torch.int32, device=dev)
    a = kvq.vq_assign(flat, emb, rescored=rescored)
    b = kvq.vq_assign(flat, emb)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    n = int(rescored.sum())
    assert n == len(flat) if kind == "ties" else 0 < n < len(flat)


@pytest.mark.parametrize("N,weighted,codes", [
    (128 * 64, False, None), (128 * 64, True, None),  # spread, and with a row mask
    (128 * 64, False, 3), (128 * 64, False, 1),       # collapsed onto three codes, onto one
    (1, False, None), (17 * 64, True, None),          # one row; the digits' ragged batch
])
def test_vq_ema_matches_plain(dev, N, weighted, codes):
    """The buffers after one update: cluster sizes bit-equal (exact counts,
    the plain version's rounding), the mean and the codebook within
    ``1e-5 * max|plain|`` (sums of rows in another order); the codes spread
    by the search, or every row on one of ``codes`` codes."""
    from mcgm_tpu_torch.kernels import vq as kvq

    got, want, args = _vq_ema_case(dev, N, weighted, codes)
    before = kvq.vq_ema.launches
    kvq.vq_ema(*args, *got, 0.99, 1e-5)
    assert kvq.vq_ema.launches == before + 3  # rows, counts, codes
    kvq.vq_ema_reference(*args, *want, 0.99, 1e-5)
    assert torch.equal(got[0], want[0])
    for g, t in zip(got[1:], want[1:]):
        assert (g - t).abs().max() <= 1e-5 * t.abs().max()


def _vq_ema_case(dev, N, weighted, codes):
    """Copies of the same buffers for two updates, and ``(flat, code, w)``."""
    from mcgm_tpu_torch.kernels import vq as kvq

    flat, emb = _vq_inputs(dev, N, seed=1)
    code, _ = kvq.vq_assign(flat, emb)
    if codes is not None:
        code = torch.tensor([5, 6, VQ_K - 1][:codes], device=dev, dtype=torch.int32)[
            code % codes]
    cs = torch.rand(VQ_K, device=dev) * 2 + 1
    w = (torch.rand(len(flat), device=dev) < 0.75).float() if weighted else None
    got = [cs.clone(), (emb * cs).contiguous(), emb.clone()]
    return got, [t.clone() for t in got], (flat, code, w)


@pytest.mark.parametrize("weighted,codes", [(False, None), (True, None), (False, 3)])
def test_vq_ema_two_launches_are_bit_equal(dev, weighted, codes):
    """No order in the kernel's sums changes from run to run: two updates of
    copies of the same buffers from the same inputs are bit-equal."""
    from mcgm_tpu_torch.kernels import vq as kvq

    a, b, args = _vq_ema_case(dev, 128 * 64, weighted, codes)
    kvq.vq_ema(*args, *a, 0.99, 1e-5)
    kvq.vq_ema(*args, *b, 0.99, 1e-5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_vqvae_step_kernel_path_matches_plain(dev):
    """One full-width CIFAR10 VQ-VAE step (B=128) from the same state through
    the kernels (one search, one EMA update) and through the plain versions:
    the loss within ``1e-2 * |plain|``, at least 99 % of the codes equal, and
    the three buffers within ``1e-2`` of each code's column of the plain
    ones (``max_d |kernel - plain| / max_d |plain|``), leaving out the codes
    that a row went to on one path only. After this first update an unused
    code's column is ~1/eps times a used one's, so one bound for the whole
    buffer would pass any error in the used codes."""
    from mcgm_tpu_torch.config import process_control
    from mcgm_tpu_torch.kernels import vq as kvq
    from mcgm_tpu_torch.models import build_model
    from mcgm_tpu_torch.train.optim import make_optimizer
    from mcgm_tpu_torch.train.state import TrainState, make_train_step

    cfg = process_control({"data_name": "CIFAR10", "model_name": "vqvae", "ae_name": "vqvae"})
    img = torch.rand((128, 32, 32, 3), generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev) * 2 - 1
    outs = {}
    for plain in (False, True):
        model = build_model(cfg, dev).use_plain_kernels(plain)
        ts = TrainState(model, make_optimizer(model.parameters(), {
            "optimizer_name": "Adam", "lr": 3e-4, "weight_decay": 0}, grad_clip=1.0))
        before = (kvq.vq_assign.launches, kvq.vq_ema.launches)
        out = make_train_step()(ts, {"img": img})
        launched = (kvq.vq_assign.launches - before[0], kvq.vq_ema.launches - before[1])
        assert launched == ((0, 0) if plain else (1, 3))  # vq_ema: three kernels
        outs[plain] = (out, model.quantizer)
    (k, qk), (p, qp) = outs[False], outs[True]
    assert abs(float(k["loss"]) - float(p["loss"])) <= 1e-2 * abs(float(p["loss"]))
    code_k, code_p = k["output"]["code"].reshape(-1), p["output"]["code"].reshape(-1)
    assert (code_k == code_p).float().mean() >= 0.99
    keep = torch.ones(VQ_K, dtype=torch.bool, device=dev)
    keep[code_k[code_k != code_p].long()] = False
    keep[code_p[code_k != code_p].long()] = False
    for name in ("cluster_size", "embedding_mean", "embedding"):
        a, b = (getattr(q, name).reshape(-1, VQ_K)[:, keep] for q in (qk, qp))
        assert ((a - b).abs().amax(0) <= 1e-2 * b.abs().amax(0)).all(), name


# ------------------------------------------------------- mc_gated_matmul
def _mc_inputs(dev, B, K, N, P, modes=10, dtype=torch.bfloat16, seed=0, soft=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, K) if P is None else (B, K, P)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = (torch.randn((N, K), generator=g, device=dev) / math.sqrt(K)).to(dtype)
    alpha = torch.rand(N, generator=g, device=dev) + 0.5
    beta = torch.randn(N, generator=g, device=dev) * 0.1
    cb = (torch.rand((modes, N), generator=g, device=dev) < 0.5).float()
    ind = torch.nn.functional.one_hot(torch.arange(B, device=dev) % modes, modes).float()
    if soft:  # a row-mixed indicator, as transit and create make them
        ind = torch.softmax(torch.randn((B, modes), generator=g, device=dev), -1)
    return x, w, alpha, beta, ind.contiguous(), cb


@pytest.mark.parametrize("B,K,N,P,relu,dtype,gate,variant", [
    (1000, 128, 512, None, True, torch.bfloat16, True, "rows"),   # the sampler's head
    (512, 128, 128, 64, False, torch.bfloat16, True, "wide"),     # an eval batch's residual
    (17, 128, 512, 64, True, torch.float32, False, "generic"),    # the digits' batch, f32
    (512, 128, 512, 64, True, torch.bfloat16, True, "wide"),      # an eval batch's head
    (17, 64, 200, 64, True, torch.bfloat16, True, "wide"),        # ragged: K 64, N 200
    (1, 128, 512, None, True, torch.bfloat16, True, "rows"),      # M = 1
    (48, 96, 200, 16, False, torch.bfloat16, True, "generic"),    # K 96, P 16
    (128, 128, 100, None, False, torch.bfloat16, True, "generic"),  # P = 1, N % 8 != 0
    # the re-forward's chunk of 1,000 grids, and 1,200: many tiles per block
    # of the wide kernel, each spanning two samples
    (1000, 128, 512, 64, True, torch.bfloat16, True, "wide"),
    (1000, 128, 128, 64, False, torch.bfloat16, True, "wide"),
    (1200, 128, 128, 64, False, torch.bfloat16, True, "wide"),
    (1200, 64, 200, 64, True, torch.bfloat16, True, "wide"),
    # Glow's coupling nets at B=128 (levels 1-3: P = 256, 64, 16; K = N =
    # 512), MCGlow's with the gate and CGlow's without: the wide kernel
    (128, 512, 512, 256, True, torch.bfloat16, True, "wide"),
    (128, 512, 512, 64, True, torch.bfloat16, True, "wide"),
    (128, 512, 512, 16, True, torch.bfloat16, True, "wide"),
    (128, 512, 512, 256, True, torch.bfloat16, False, "wide"),
    (128, 512, 512, 64, True, torch.bfloat16, False, "wide"),
    (128, 512, 512, 16, True, torch.bfloat16, False, "wide"),
    # the digits' last batch of 17 at levels 1 and 3, an eval batch of 512
    (17, 512, 512, 256, True, torch.bfloat16, True, "wide"),
    (512, 512, 512, 256, True, torch.bfloat16, True, "wide"),
    (17, 512, 512, 16, True, torch.bfloat16, True, "wide"),
    # the wide kernel's other shapes: K below 512, N not a multiple of 128 (a
    # slice of 128 channels part empty), P 32 and 192 (64-position tiles)
    (48, 128, 192, 32, True, torch.bfloat16, True, "wide"),
    (40, 256, 320, 192, True, torch.bfloat16, True, "wide"),
    (33, 64, 64, 16, False, torch.bfloat16, True, "wide"),
])
def test_mc_gated_matmul_matches_plain(dev, B, K, N, P, relu, dtype, gate, variant):
    """The kernel against its plain version (f32 sums, one rounding to the
    operands' dtype): within ``2e-2 * max|plain|`` in bf16 and
    ``1e-5 * max|plain|`` in f32 (sums in another order), through each of
    the three kernels the C entry point picks from, the pick named."""
    from mcgm_tpu_torch.kernels import mc_gate

    x, w, alpha, beta, ind, cb = _mc_inputs(dev, B, K, N, P, dtype=dtype)
    if not gate:
        ind = cb = None
    assert mc_gate.variant(x, w) == variant
    before = mc_gate.mc_gated_matmul.launches
    got = mc_gate.mc_gated_matmul(x, w, alpha, beta, ind, cb, relu)
    assert mc_gate.mc_gated_matmul.launches == before + 1
    want = mc_gate.mc_gated_matmul_reference(x, w, alpha, beta, ind, cb, relu)
    assert got.shape == want.shape and got.dtype == dtype
    tol = TOL if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()


def test_mc_gated_matmul_gradient_matches_plain(dev):
    """The Pallas form (no affine, no activation, a soft indicator): the
    autograd Function's gradients against the plain version's autograd."""
    from mcgm_tpu_torch.kernels import mc_gate

    x, w, _, _, ind, cb = _mc_inputs(dev, 300, 128, 128, None, dtype=torch.float32, soft=True)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    (mc_gate.mc_gated_matmul(xs, ws, None, None, ind, cb) ** 2).sum().backward()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (mc_gate.mc_gated_matmul_reference(xr, wr, None, None, ind, cb) ** 2).sum().backward()
    for a, b in ((xs.grad, xr.grad), (ws.grad, wr.grad)):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("gate", [True, False])
def test_mc_gated_matmul_affine_gradient_matches_plain(dev, gate):
    """The widened backward at Glow's level-2 shape (bf16 operands, ReLU,
    alpha and beta requiring gradients): every gradient against the plain
    version's autograd, ``dx`` / ``dw`` (bf16) within ``2e-2 * max``,
    ``dalpha`` / ``dbeta`` (f32 sums in another order) within ``1e-4 *
    max``. The upstream gradient is 0 where the pre-activation is within
    ``1e-3 * max`` of 0: there the kernel's f32 sums, in another order, may
    take the ReLU's mask the other way."""
    from mcgm_tpu_torch.kernels import mc_gate

    x, w, alpha, beta, ind, cb = _mc_inputs(dev, 128, 512, 512, 64)
    if not gate:
        ind = cb = None
    pre = torch.einsum("nk,bkp->bnp", w.float(), x.float()) * alpha[:, None] + beta[:, None]
    r = torch.randn((128, 512, 64), device=dev) * (pre.abs() > 1e-3 * pre.abs().max())
    grads = []
    for fn in (mc_gate.mc_gated_matmul, mc_gate.mc_gated_matmul_reference):
        leaves = [t.clone().requires_grad_() for t in (x, w, alpha, beta)]
        (fn(*leaves, ind, cb, True).float() * r).sum().backward()
        grads.append([t.grad.float() for t in leaves])
    for i, (a, b) in enumerate(zip(*grads)):
        assert (a - b).abs().max() <= (TOL if i < 2 else 1e-4) * b.abs().max(), i


def _glow_backward_case(dev, B, P, gate, K=512, N=512):
    """The gated 1x1 at Glow's K = N = 512 (or the K and N given; bf16,
    ReLU) and an upstream gradient that is 0 where the pre-activation is
    within ``1e-3 * max`` of 0 (there the plain version's f32 sums, in
    another order, may take the ReLU's mask the other way)."""
    x, w, alpha, beta, ind, cb = _mc_inputs(dev, B, K, N, P, seed=B + P)
    if not gate:
        ind = cb = None
    pre = torch.einsum("nk,bkp->bnp", w.float(), x.float()) * alpha[:, None] + beta[:, None]
    g = torch.Generator(device=dev).manual_seed(P)
    r = torch.randn((B, N, P), generator=g, device=dev) * (pre.abs() > 1e-3 * pre.abs().max())
    return (x, w, alpha, beta, ind, cb, True), r.to(torch.bfloat16)


# Glow's three levels at B=128, then the wide kernel's other shapes: K below
# 512, N not a multiple of 128 (200 not even of 64), P 32, 192 and the
# PixelCNN's 64
BACKWARD_SHAPES = [(128, 512, 512, 256), (128, 512, 512, 64), (128, 512, 512, 16),
                   (48, 128, 192, 32), (40, 256, 320, 192), (33, 64, 64, 16), (17, 64, 200, 64)]


@pytest.mark.parametrize("B,K,N,P", BACKWARD_SHAPES)
@pytest.mark.parametrize("gate", [True, False])
def test_mc_gated_matmul_backward_kernel_matches_plain(dev, B, K, N, P, gate):
    """The backward kernel and its two bf16 cuBLAS products
    (``backward_variant`` names them, one kernel launch) against the plain
    f32 backward: ``dx`` / ``dw`` within ``2e-2 * max``, ``dalpha`` /
    ``dbeta`` (f32 sums in another order) within ``1e-4 * max``."""
    from mcgm_tpu_torch.kernels import mc_gate

    args, r = _glow_backward_case(dev, B, P, gate, K, N)
    assert mc_gate.backward_variant(args[0], args[1]) == "wide"
    before = mc_gate.mc_gated_matmul.backward_launches
    got = mc_gate.mc_gated_matmul_backward(*args, r)
    assert mc_gate.mc_gated_matmul.backward_launches == before + 1
    want = mc_gate.mc_gated_matmul_backward_reference(
        *args, r, mc_gate.mc_gated_matmul_reference(*args))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert (a.float() - b.float()).abs().max() <= (TOL if i < 2 else 1e-4) * b.abs().max(), i


@pytest.mark.parametrize("B,K,N,P", [(128, 512, 512, 256), (17, 512, 512, 16),
                                     (40, 256, 320, 192)])
def test_mc_gated_matmul_backward_two_launches_are_bit_equal(dev, B, K, N, P):
    """``gza``, ``dalpha`` and ``dbeta`` of two launches on the same inputs
    are bit-equal: the per-block sums are added in a fixed order."""
    from mcgm_tpu_torch.kernels import mc_gate

    args, r = _glow_backward_case(dev, B, P, True, K, N)
    first = mc_gate.mc_gated_matmul_backward_kernel(*args, r)
    second = mc_gate.mc_gated_matmul_backward_kernel(*args, r)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("backward", ["remat_flows", "reversible_flows"])
def test_glow_step_kernel_path_matches_plain(dev, backward):
    """One full-width CIFAR10 MCGlow step (B=128, bf16 convs, ``remat_flows``
    or the reversible backward) from one state, through the kernels (48
    forward launches in the forward, 48 in the recompute or the reversible
    backward's net runs, and 48 of the backward kernel) and through the
    plain version: the loss within ``1e-2 *
    |plain|``, the gradients of the coupling nets' ActNorm after the 1x1
    (through the widened backward) within ``5e-2 * max|plain|``, and every
    parameter after the step within ``5e-2 * max|plain|`` of its tensor plus
    ``2 lr / 16`` (this first, warmed-up Adam update is a sign: a gradient
    near 0 may take the other one). The zero convs start from small random
    weights, so gradients reach the 1x1."""
    from mcgm_tpu_torch.config import process_control
    from mcgm_tpu_torch.kernels import mc_gate
    from mcgm_tpu_torch.models import build_model
    from mcgm_tpu_torch.models.glow import ZeroConv2d
    from mcgm_tpu_torch.train.optim import make_optimizer
    from mcgm_tpu_torch.train.state import TrainState, make_train_step

    cfg = loop.apply_family_overrides(process_control({"data_name": "CIFAR10",
                                                       "model_name": "mcglow"}))
    cfg["classes_size"] = 10
    cfg["glow"] = dict(cfg["glow"], reversible_flows=backward == "reversible_flows")
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"img": torch.rand((128, 32, 32, 3), generator=g, device=dev) * 2 - 1,
             "label": torch.arange(128, device=dev) % 10}
    noise = torch.rand((128, 32, 32, 3), generator=g, device=dev)
    state = None
    outs = {}
    for plain in (False, True):
        model = build_model(cfg, dev).use_plain_kernels(plain)
        if state is None:
            with torch.no_grad():
                model(batch, train=True, ddi=True, noise=noise)
                for m in model.modules():
                    if isinstance(m, ZeroConv2d):
                        m.conv.weight.normal_(0.0, 1e-2, generator=g)
            state = {k: t.clone() for k, t in model.state_dict().items()}
        model.load_state_dict(state)
        ts = TrainState(model, make_optimizer(model.parameters(), cfg, grad_clip=1.0))
        seen = []
        ts.opt.register_step_pre_hook(lambda *_, m=model: seen.append(
            {n: p.grad.clone() for n, p in m.named_parameters() if "ActNorm_1" in n}))
        before = mc_gate.mc_gated_matmul.launches
        before_bwd = mc_gate.mc_gated_matmul.backward_launches
        out = make_train_step(skip_nonfinite=True)(ts, batch, noise=noise)
        assert mc_gate.mc_gated_matmul.launches - before == (0 if plain else 96)
        assert mc_gate.mc_gated_matmul.backward_launches - before_bwd == (0 if plain else 48)
        assert float(out["skipped"]) == 0.0
        outs[plain] = (float(out["loss"]), model.state_dict(), seen[0])
    (lk, sk, gk), (lp, sp, gp) = outs[False], outs[True]
    assert abs(lk - lp) <= 1e-2 * abs(lp)
    for k, b in sp.items():
        assert ((sk[k].float() - b.float()).abs().max()
                <= 5e-2 * b.float().abs().max() + 2 * cfg["lr"] / 16), k
    for k, b in gp.items():
        assert b.abs().max() > 0, k
        assert (gk[k] - b).abs().max() <= 5e-2 * b.abs().max(), k


@pytest.mark.parametrize("name", ["mcpixelcnn", "cpixelcnn"])
def test_pixelcnn_eval_forward_kernel_path_matches_plain(dev, name):
    """The full-width PixelCNN's eval forward on 64 random 8x8 grids (bf16
    operands), through the kernel (16 launches: 15 residuals and the head)
    and through its plain version: logits within ``2e-2 * max|plain|``."""
    from mcgm_tpu_torch.config import process_control
    from mcgm_tpu_torch.kernels import mc_gate
    from mcgm_tpu_torch.models import build_model

    cfg = process_control({"data_name": "CIFAR10", "model_name": name, "ae_name": "vqvae"})
    cfg["classes_size"] = 10
    model = build_model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"img": torch.randint(0, 512, (64, 8, 8), generator=g, device=dev),
             "label": torch.arange(64, device=dev) % 10}
    with torch.no_grad():
        before = mc_gate.mc_gated_matmul.launches
        got = model(batch)["logits"].float()
        assert mc_gate.mc_gated_matmul.launches == before + 16
        want = model.use_plain_kernels()(batch)["logits"].float()
    assert (got - want).abs().max() <= TOL * want.abs().max()
