"""Two repairs of the port, on the CPU: Glow's seeded invconv weights no
longer depend on torch's thread count, and the experiment logger writes
TensorBoard event files (``log_backend`` ``tensorboard`` / ``both``) as the
JAX package's logger does, falling back to jsonl where TensorBoard cannot be
imported.

The logger tests send the same scalars and info lines through both
packages' loggers and read the event files back with TensorBoard's
``event_accumulator``: tags, steps and values equal, the jsonl files equal
line for line but for the wall time. They run TensorBoard on its stub of the
TensorFlow API (``tensorboard.compat.notf``): importing TensorFlow, where it
is installed, would cost a test worker some 15 s and changes nothing the
event files hold.
"""

import json
import pickle
import sys
import types

import pytest
import torch

from mcgm_tpu.report.logger import Logger as JaxLogger
from mcgm_tpu_torch.models.glow import InvConv2d, InvConv2dLU
from mcgm_tpu_torch.report.logger import Logger


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------- Glow's init
@pytest.mark.parametrize("features", [192, 512])
@pytest.mark.parametrize("cls", [InvConv2dLU, InvConv2d])
def test_glow_invconv_init_is_independent_of_thread_count(cls, features):
    """The same seed gives bit-equal QR / LU factors under 1 and 4 torch
    threads (unpinned, LAPACK's blocked factorisations differ by up to 2e-4
    at 512)."""
    states = []
    for threads in (1, 4):
        torch.set_num_threads(threads)
        m = cls(features, generator=torch.Generator().manual_seed(3))
        states.append({k: v.clone() for k, v in m.state_dict().items()})
        assert torch.get_num_threads() == threads  # the init restores the count
    assert states[0].keys() == states[1].keys()
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


# ------------------------------------------------------------ the logger
@pytest.fixture
def no_tensorflow(monkeypatch):
    """TensorBoard on its TensorFlow stub (see the module doc)."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))


def _drive(logger):
    """Two epochs of scalars and info lines, as a trainer sends them."""
    for epoch in range(2):
        logger.safe(True)
        for step in range(3):
            logger.append({"Loss": 1.5 / (1 + step + 3 * epoch), "Accuracy": 0.25 * step},
                          "train", n=4)
            logger.append({"info": ["Model: t", f"Train Epoch: {epoch}"]}, "train",
                          mean=False)
            logger.write("train", ["Loss", "Accuracy"])
        logger.safe(False)
        logger.reset()
    logger.close()


def _events(path):
    from tensorboard.backend.event_processing import event_accumulator

    acc = event_accumulator.EventAccumulator(str(path), size_guidance={"scalars": 0,
                                                                       "tensors": 0})
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
               for tag in acc.Tags()["scalars"]}
    texts = {tag: [(e.step, e.tensor_proto.string_val[0].decode()) for e in acc.Tensors(tag)]
             for tag in acc.Tags()["tensors"]}
    return scalars, texts


def _jsonl(path):
    lines = (path / "scalars.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in lines]


@pytest.mark.parametrize("backend", ["tensorboard", "both"])
def test_logger_tensorboard_matches_jax(tmp_path, no_tensorflow, backend, capsys):
    port, ref = Logger(str(tmp_path / "p"), backend), JaxLogger(str(tmp_path / "j"), backend)
    _drive(port)
    _drive(ref)
    got, want = _events(tmp_path / "p"), _events(tmp_path / "j")
    assert got == want
    scalars, texts = got
    assert sorted(scalars) == ["train/Accuracy", "train/Loss"]
    assert [s for s, _ in scalars["train/Loss"]] == list(range(1, 7))
    assert [len(v) for v in texts.values()] == [6]  # the info lines
    assert port.history == ref.history
    if backend == "both":
        assert _jsonl(tmp_path / "p") == _jsonl(tmp_path / "j")
    else:
        assert not (tmp_path / "p" / "scalars.jsonl").exists()
    out = capsys.readouterr().out.splitlines()
    assert out[:6] == out[6:]  # the same info lines from both


def test_logger_falls_back_to_jsonl_without_tensorboard(tmp_path, monkeypatch):
    """A failed import of the writer: a warning, then jsonl, as the JAX
    package's logger does."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    loggers = (Logger(str(tmp_path / "p"), "tensorboard"),
               JaxLogger(str(tmp_path / "j"), "tensorboard"))
    for logger in loggers:
        with pytest.warns(UserWarning, match="falling back to jsonl"):
            _drive(logger)
        assert logger.backend == "jsonl"
    assert _jsonl(tmp_path / "p") == _jsonl(tmp_path / "j")
    assert len(_jsonl(tmp_path / "p")) == 2 * 3 * 2  # epochs x steps x metrics


def test_logger_backend_after_resume(tmp_path, no_tensorflow):
    """A resumed run's logger (unpickled, as a mode-1 resume loads it, its
    backend then set from the config) opens the backend it is given; a
    pickle from before the tensorboard backend loads too."""
    logger = Logger(str(tmp_path / "run"), "jsonl")
    logger.safe(True)
    logger.append({"Loss": 2.0}, "train")
    logger.write("train", ["Loss"])
    logger.safe(False)
    state = pickle.loads(pickle.dumps(logger))
    assert state._tb is None and state._fh is None
    state.backend = "tensorboard"  # train/loop.py's mode-1 resume
    state.safe(True)
    state.append({"Loss": 1.0}, "train")
    state.write("train", ["Loss"])
    state.close()
    scalars, _ = _events(tmp_path / "run")
    assert scalars == {"train/Loss": [(2, 1.5)]}  # the resumed step count, the running mean
    old = logger.__getstate__()
    del old["_tb"], old["backend"]  # as pickled before the backends
    revived = Logger.__new__(Logger)
    revived.__setstate__(old)
    assert revived._tb is None and revived.backend == "jsonl"
