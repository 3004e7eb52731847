"""The vector quantizer's two kernels: nearest-code search and the EMA
codebook update. Wrappers, plain versions and launch counts.

``vq_assign(flat, emb)`` -> ``(code, q)``: for rows ``flat [N, D]`` and a
codebook ``emb [D, K]`` (codes are columns), ``code[n] = argmin_k
|flat[n] - emb[:, k]|^2`` in the expanded form ``|x|^2 - 2 x.e + |e|^2``
(int32, the lowest index on ties) and ``q = emb.T[code]``.

``vq_ema(flat, code, w, cluster_size, embedding_mean, embedding, decay,
eps)`` updates the three buffers in place: per-code (``w``-weighted) counts
and sums of rows, their EMA into ``cluster_size`` and ``embedding_mean``,
Laplace smoothing of the cluster sizes and ``embedding = mean / smoothed``.

On a CUDA tensor each launches its kernel (``csrc/vq_assign.cu``: one
launch, the cross term on the tensor cores in TF32 and an exact f32
decision of the rows that screen cannot decide, or f32 on the CUDA cores
for a D that is not a multiple of 8, the ``.cu``'s choice by the shape,
named by :func:`assign_variant`; ``csrc/vq_ema.cu``: three launches over a
scratch buffer whose size and layout the ``.cu`` sets) or raises, and its
``launches`` gains one per kernel launched (three per ``vq_ema`` call); on
a CPU tensor it computes the plain version (:func:`vq_assign_reference`,
:func:`vq_ema_reference`), which follows the JAX package's XLA code
(``mcgm_tpu/ops/vq.py``) op for op. Neither needs a gradient: codes are
integers and the EMA updates buffers.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

ASSIGN, EMA = "vq_assign", "vq_ema"
MAX_D = 256  # both kernels hold D floats per row in shared memory (vq_ema: D % 4 == 0)
ASSIGN_VARIANTS = ("ffma", "tf32")  # vq_assign.cu's kernels, by its variant code
# mcgm_vq_assign(x, emb, idx, q, N, D, K, rescored, stream)
ASSIGN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def assign_variant(N: int, D: int, K: int) -> str:
    """The kernel that :func:`vq_assign` launches for rows ``[N, D]`` and a
    codebook ``[D, K]`` on the card, as the C entry point chooses it
    (``mcgm_vq_assign_variant``, by the shape alone)."""
    fn = build.load(ASSIGN).mcgm_vq_assign_variant
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
    return ASSIGN_VARIANTS[fn(N, D, K)]


def vq_assign_reference(flat: torch.Tensor, emb: torch.Tensor):
    """Plain version: the distances in the expanded form, ``argmin``, and
    the gathered rows."""
    dist = ((flat ** 2).sum(1, keepdim=True) - 2.0 * flat @ emb
            + (emb ** 2).sum(0, keepdim=True))
    code = dist.argmin(1).to(torch.int32)
    return code, emb.t().index_select(0, code)


def vq_ema_reference(flat, code, w, cluster_size, embedding_mean, embedding,
                     decay: float, eps: float) -> None:
    """Plain version of :func:`vq_ema`: ``onehot`` (times ``w``), its counts
    and ``flat^T @ onehot``, the EMA, the Laplace smoothing and the
    division, written into the buffers."""
    K = cluster_size.shape[0]
    oh = F.one_hot(code.long(), K).to(flat.dtype)
    if w is not None:
        oh = oh * w[:, None]
    new_cluster = cluster_size * decay + oh.sum(0) * (1 - decay)
    new_mean = embedding_mean * decay + (flat.t() @ oh) * (1 - decay)
    n = new_cluster.sum()
    smoothed = (new_cluster + eps) / (n + K * eps) * n
    cluster_size.copy_(new_cluster)
    embedding_mean.copy_(new_mean)
    embedding.copy_(new_mean / smoothed[None, :])


def _f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous f32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}{'' if t.is_contiguous() else ' (strided)'}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, flat on {device}")


def _fn(kernel: str, argtypes):
    lib = build.load(kernel)
    fn = getattr(lib, f"mcgm_{kernel}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
    return lib, fn


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def vq_assign(flat: torch.Tensor, emb: torch.Tensor, rescored: torch.Tensor | None = None):
    """``(code int32 [N], q [N, D])``: the kernel for a CUDA ``flat``, the
    plain version for a CPU one (see the module doc). ``rescored``, an int32
    ``[2]`` on the card or None, gains the rows that the ``tf32`` kernel
    decided in f32: ``[0]`` against every code, ``[1]`` by their two best
    codes (counts for the checks; the main path passes None)."""
    if flat.device.type == "cpu":
        return vq_assign_reference(flat, emb)
    if flat.device.type != "cuda":
        raise ValueError(f"vq_assign: no kernel for device {flat.device}")
    if flat.dim() != 2 or emb.dim() != 2 or not 0 < flat.shape[1] <= MAX_D:
        raise ValueError(f"vq_assign: flat {tuple(flat.shape)}, emb {tuple(emb.shape)}: want "
                         f"[N, D] and [D, K] with D <= {MAX_D}")
    N, D = flat.shape
    K = emb.shape[1]
    _f32("flat", flat, (N, D), flat.device)
    _f32("emb", emb, (D, K), flat.device)
    if rescored is not None and (rescored.dtype != torch.int32 or rescored.numel() != 2
                                 or not rescored.is_contiguous()
                                 or rescored.device != flat.device):
        raise ValueError(f"vq_assign: rescored must be a contiguous int32 [2] on {flat.device}")
    code = torch.empty(N, dtype=torch.int32, device=flat.device)
    q = torch.empty((N, D), dtype=torch.float32, device=flat.device)
    if N == 0:
        return code, q
    if flat.data_ptr() % 16:  # rows are read 16 bytes at a time
        flat = flat.clone()
    lib, fn = _fn(ASSIGN, ASSIGN_ARGTYPES)
    with torch.cuda.device(flat.device):
        err = fn(flat.data_ptr(), emb.data_ptr(), code.data_ptr(), q.data_ptr(), N, D, K,
                 None if rescored is None else rescored.data_ptr(), _stream(flat.device))
    build.check(lib, err, ASSIGN)
    vq_assign.launches += 1
    return code, q


def vq_ema(flat, code, w, cluster_size, embedding_mean, embedding, decay: float,
           eps: float) -> None:
    """Update ``cluster_size [K]``, ``embedding_mean [D, K]`` and
    ``embedding [D, K]`` in place from rows ``flat [N, D]``, their codes
    ``code [N]`` and optional row weights ``w [N]``: the kernel for CUDA
    tensors, the plain version for CPU ones."""
    if flat.device.type == "cpu":
        vq_ema_reference(flat, code, w, cluster_size, embedding_mean, embedding, decay, eps)
        return
    if flat.device.type != "cuda":
        raise ValueError(f"vq_ema: no kernel for device {flat.device}")
    if flat.dim() != 2 or not 0 < flat.shape[1] <= MAX_D or flat.shape[1] % 4:
        raise ValueError(f"vq_ema: flat {tuple(flat.shape)}: want [N, D], D <= {MAX_D} and "
                         "a multiple of 4")
    N, D = flat.shape
    K = cluster_size.shape[0]
    dev = flat.device
    _f32("flat", flat, (N, D), dev)
    _f32("cluster_size", cluster_size, (K,), dev)
    _f32("embedding_mean", embedding_mean, (D, K), dev)
    _f32("embedding", embedding, (D, K), dev)
    if w is not None:
        _f32("w", w, (N,), dev)
    if code.dtype != torch.int32 or tuple(code.shape) != (N,) or code.device != dev \
            or not code.is_contiguous():
        raise ValueError(f"vq_ema: code must be contiguous int32 ({N},) on {dev}")
    if embedding.data_ptr() == embedding_mean.data_ptr():
        raise ValueError("vq_ema: embedding and embedding_mean share storage")
    if N == 0:
        return
    if flat.data_ptr() % 16:  # rows are read 16 bytes at a time
        flat = flat.clone()
    cs_out = torch.empty_like(cluster_size)  # the last pass reads all of the new sizes
    lib, fn = _fn(EMA, [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
                  + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    size = lib.mcgm_vq_ema_scratch_bytes
    if size.argtypes is None:
        size.argtypes, size.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    # the partial sums, their counts and the slot table (csrc/vq_ema.cu)
    scratch = torch.empty(size(N, D, K), dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):  # 1 - decay and K eps as the plain version's scalars
        err = fn(flat.data_ptr(), code.data_ptr(), None if w is None else w.data_ptr(),
                 cluster_size.data_ptr(), cs_out.data_ptr(), embedding_mean.data_ptr(),
                 embedding.data_ptr(), scratch.data_ptr(), N, D, K, decay, 1 - decay, eps,
                 K * eps, ctypes.byref(launched), _stream(dev))
    vq_ema.launches += launched.value  # one per kernel launched: three a call
    build.check(lib, err, EMA)
    cluster_size.copy_(cs_out)


vq_assign.launches = 0
vq_ema.launches = 0
