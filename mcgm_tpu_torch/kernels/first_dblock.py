"""The fused first discriminator block: wrapper, plain version, launch count.

``first_dblock`` computes, NHWC,

    h = relu(conv3x3_pad1(x, w1) + b1) * code[b]
    y = conv4x4_s2_pad1(h, w2f) + b2 + conv1x1(avgpool2(x), w3) + b3

On a CUDA tensor it launches ``csrc/first_dblock.cu`` (bf16 x and y, f32
accumulation, h kept on chip in bf16) or raises; on a CPU tensor it computes
:func:`first_dblock_reference`. Weights are in the JAX package's HWIO layout.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

KERNEL = "first_dblock"


def first_dblock_reference(x, code, w1, b1, w2f, b2, w3, b3):
    """Plain PyTorch version of the kernel's function.

    x ``[B,H,W,Cin]``, code ``[B,Cout]``, w1 ``[3,3,Cin,Cout]``,
    w2f ``[4,4,Cout,Cout]``, w3 ``[Cin,Cout]`` (or ``[1,1,Cin,Cout]``), biases
    ``[Cout]``; returns ``[B,H/2,W/2,Cout]`` in ``x.dtype``. Weights and h
    are rounded to ``x.dtype`` where the kernel rounds them (a no-op in f32);
    the arithmetic is f32.
    """
    dt, f32 = x.dtype, torch.float32
    cin, cout = w1.shape[2], w1.shape[3]

    def oihw(w):
        return w.to(dt).to(f32).permute(3, 2, 0, 1)

    xc = x.permute(0, 3, 1, 2).to(f32)
    h = F.conv2d(xc, oihw(w1), b1.to(f32), padding=1).relu()
    h = (h * code.to(f32)[:, :, None, None]).to(dt).to(f32)
    y = F.conv2d(h, oihw(w2f), b2.to(f32), stride=2, padding=1)
    sc = F.conv2d(F.avg_pool2d(xc, 2), oihw(w3.reshape(1, 1, cin, cout)), b3.to(f32))
    return (y + sc).to(dt).permute(0, 2, 3, 1)


def _check(x, code, w1, b1, w2f, b2, w3, b3):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"first_dblock kernel takes bf16 x, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("first_dblock kernel takes a contiguous NHWC x")
    B, H, W, cin = x.shape
    cout = w1.shape[-1]
    if cin not in (1, 3) or cout not in (64, 128) or H % 2 or W % 2 or B > 65535:
        raise ValueError(f"first_dblock kernel does not take x {tuple(x.shape)} -> {cout} "
                         "(C_in in {1,3}, C_out in {64,128}, even H and W)")
    shapes = {"code": (code, (B, cout)), "w1": (w1, (3, 3, cin, cout)), "b1": (b1, (cout,)),
              "w2f": (w2f, (4, 4, cout, cout)), "b2": (b2, (cout,)),
              "w3": (w3, (cin * cout,)), "b3": (b3, (cout,))}
    for name, (t, shape) in shapes.items():
        got = tuple(t.shape) if name != "w3" else (t.numel(),)
        if got != shape:
            raise ValueError(f"first_dblock: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.device != x.device:
            raise ValueError(f"first_dblock: {name} is on {t.device}, x on {x.device}")


def first_dblock(x, code, w1, b1, w2f, b2, w3, b3):
    """Launch the kernel for a CUDA ``x``; the plain version for a CPU one."""
    if x.device.type == "cpu":
        return first_dblock_reference(x, code, w1, b1, w2f, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"first_dblock: no kernel for device {x.device}")
    _check(x, code, w1, b1, w2f, b2, w3, b3)
    B, H, W, cin = x.shape
    cout = w1.shape[-1]
    bf16 = torch.bfloat16
    w2 = w2f.to(bf16).contiguous()
    if w2.data_ptr() % 16:  # the kernel streams w2f in 16-byte loads
        w2 = w2.clone()
    # the kernel reads these; keep them referenced until the launch returns
    args = [x, code.float().contiguous(), w1.to(bf16).contiguous(), b1.float().contiguous(),
            w2, b2.float().contiguous(), w3.to(bf16).contiguous(), b3.float().contiguous()]
    y = torch.empty((B, H // 2, W // 2, cout), dtype=bf16, device=x.device)
    lib = build.load(KERNEL)
    fn = lib.mcgm_first_dblock
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in args), y.data_ptr(), B, H, W, cin, cout, stream)
    build.check(lib, err, KERNEL)
    first_dblock.launches += 1
    return y


first_dblock.launches = 0
