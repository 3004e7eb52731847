"""The int8 kernels' host-side plans (``kernels/int8.py``: ``conv_plan``,
``quantize_plan``), on the CPU, for every case ``chip_smoke.py`` runs on the
card (``bench/int8_cases.py``: the generators' shapes and the extra
variants, at its batches and the artifacts' 1,000).

- ``int8_conv``: what TMA and the kernels take, checked from the numbers
  the ``.cu`` is handed: the byte-load kernel wherever ``C`` bytes (a row of
  x and of w per tap) are not a multiple of 16 or an operand is not 16-byte
  aligned; ``narrow`` (n8) for ``N <= 8``; every TMA box at most 256 along
  each dimension, its channel bytes 32, 64 or 128 (the swizzle's width,
  dividing C or reading zeros past it), its pixels at most a tile's; the
  global strides multiples of 16 bytes; the wide kernel's TMA stores only
  where the output's rows are too and, up2, a store box stays in its
  parity's channels. The variant of each extra case and the whole plan of
  the five timed shapes are written out by hand.
- ``int8_quantize``: one kernel a call, ``rows`` for examples of at most
  1,024 values, a cluster of at most 8 blocks whose slices cover the
  example and fit in shared memory, ``stream`` where they would not or
  where x is not 16-byte aligned.
"""

import pytest

from mcgm_tpu_torch.bench.int8_cases import (INT8_BATCHES, INT8_CASES, INT8_EXTRA_CASES,
                                             INT8_TIMED, SERVE_BATCH)
from mcgm_tpu_torch.kernels import int8 as ki

CASES = INT8_CASES + INT8_EXTRA_CASES
BATCHES = INT8_BATCHES + (SERVE_BATCH,)
# the extra cases' variants for a bf16 and an f32 output
EXTRA_VARIANTS = {
    "n8 direct 3x3 64->3": ("narrow", "narrow"),
    # a bf16 store box holds 64 channels, an f32 one 32: 96 splits only the f32 one evenly
    "up2 128->96 at 8 (bytes: N % 64)": ("bytes", "wide"),
    # 260 and 520 bytes a row
    "1x1 64->130 at 6 (bytes: 260-byte rows)": ("bytes", "bytes"),
}
# the timed shapes at B = 1,000, bf16 out: the box fills a 128-pixel tile
# (256 for narrow) with whole rows of one phase, then examples
TIMED_PLANS = {
    "GAN Conv_1 3x3 at 32": {"variant": "wide", "kc": 128, "chunks": 2, "bn": 256,
                             "box": (128, 32, 4, 1), "tiles": 8 * 1000,
                             "store_box": (64, 32, 4, 1)},
    "GAN Conv_0 up2 16->32": {"variant": "wide", "kc": 128, "chunks": 2, "bn": 256,
                              "box": (128, 16, 8, 1), "tiles": 2 * 1000,
                              "store_box": (64, 16, 8, 1)},
    "GAN Conv_2 1x1 at 16": {"variant": "wide", "kc": 128, "chunks": 2, "bn": 256,
                             "box": (128, 16, 8, 1), "tiles": 2 * 1000,
                             "store_box": (64, 16, 8, 1)},
    "Dense_0 128->4096": {"variant": "wide", "kc": 128, "chunks": 1, "bn": 256,
                          "box": (128, 1, 1, 128), "tiles": 8 * 16,
                          "store_box": (64, 1, 1, 128)},
    "VAE ConvTranspose 64->3 16->32": {"variant": "narrow", "kc": 64, "chunks": 1, "bn": 8,
                                       "box": (64, 16, 16, 1), "tiles": 1000,
                                       "store_box": None},
}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_conv_plan(case):
    name, layout, H, W, C, N, kh, kw, pad, _ = case
    Hp, Wp = (H, W) if layout == ki.UP2 else ki._out_hw(layout, H, W, kh, kw, pad)
    for B in BATCHES:
        for itemsize in (2, 4):
            plan = ki.conv_plan(B, H, W, C, N, layout, kh, kw, pad, out_itemsize=itemsize)
            assert ki.conv_plan(B, H, W, C, N, layout, kh, kw, pad,
                                aligned=False)["variant"] == "bytes"
            if name in EXTRA_VARIANTS:
                assert plan["variant"] == EXTRA_VARIANTS[name][itemsize // 4], (name, plan)
            elif C % 16 == 0:  # every generator shape that TMA can read runs on TMA
                assert plan["variant"] == ("narrow" if N <= 8 else "wide"), (name, plan)
            if C % 16:
                assert plan == {"variant": "bytes"}, (name, B, plan)
            if plan["variant"] == "bytes":
                continue
            assert (N <= ki.NARROW_N) == (plan["variant"] == "narrow"), (name, plan)
            kc, bw, bh, bb = plan["box"]
            assert kc in (32, 64, 128) and (C % kc == 0 or kc == 32)
            assert plan["chunks"] * kc >= C > (plan["chunks"] - 1) * kc
            assert all(1 <= d <= ki.TMA_BOX_MAX for d in plan["box"] + plan["w_box"])
            assert bw * bh * bb <= plan["rows"] and bw <= Wp and bh <= Hp and bb <= B
            assert all(st % 16 == 0 for st in plan["x_strides"] + plan["w_strides"])
            assert plan["bn"] >= min(N, 64) and plan["tiles"] >= 1
            if plan["variant"] == "wide":
                sc = plan["store_box"][0]
                assert sc * itemsize == 128 and plan["store_box"][1:] == (bw, bh, bb)
                assert N * itemsize % 16 == 0 and (layout == ki.DIRECT or N % sc == 0)
            else:
                assert plan["store_box"] is None and plan["bn"] == 8


@pytest.mark.parametrize("name", INT8_TIMED)
def test_conv_plan_timed(name):
    _, layout, H, W, C, N, kh, kw, pad, _ = next(c for c in INT8_CASES if c[0] == name)
    plan = ki.conv_plan(SERVE_BATCH, H, W, C, N, layout, kh, kw, pad, out_itemsize=2)
    assert {k: plan[k] for k in TIMED_PLANS[name]} == TIMED_PLANS[name]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_quantize_plan(case):
    _, layout, H, W, C, N, kh, kw, pad, _ = case
    E = H * W * C
    for B in BATCHES:
        for itemsize in (2, 4):
            assert ki.quantize_plan(B, E, itemsize, True)["variant"] == "static"
            plan = ki.quantize_plan(B, E, itemsize, False)
            if E <= ki.Q_ROWS_MAX_E:
                assert plan["variant"] == "rows"
                continue
            assert plan["variant"] in ("cluster", "stream")
            assert 1 <= plan["cluster"] <= ki.Q_CLUSTER
            assert plan["cluster"] * plan["slice"] >= E
            if plan["variant"] == "cluster":
                assert E % 16 == 0 and plan["slice"] % 16 == 0
                assert plan["slice"] * itemsize <= ki.Q_MAX_SLICE_BYTES
                assert (plan["cluster"] - 1) * plan["slice"] < E  # no block idle
            else:
                assert E % 16 or plan["slice"] * itemsize > ki.Q_MAX_SLICE_BYTES
            assert ki.quantize_plan(B, E, itemsize, False, aligned=False)["variant"] == "stream"


def test_quantize_plan_sizes():
    """The largest activation the GAN artifact quantizes (Conv_1's input at
    32 px): 8 blocks of 64 KB in bf16, of 128 KB in f32; f32 examples of 4
    MB stream; a Dense input, one warp per example."""
    assert ki.quantize_plan(1000, 32 * 32 * 256, 2, False) == {
        "variant": "cluster", "cluster": 8, "slice": 32768}
    assert ki.quantize_plan(1000, 32 * 32 * 256, 4, False)["variant"] == "cluster"
    assert ki.quantize_plan(2, 64 * 64 * 256, 4, False)["variant"] == "stream"
    assert ki.quantize_plan(1000, 128, 2, False)["variant"] == "rows"
