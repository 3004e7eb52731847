"""The shapes the int8 serving kernels are checked and timed at.

``INT8_CASES``: every ``int8_conv`` call of the CIFAR10-width GAN and VAE
generators as ``(case, layout, H, W, C, N, kh, kw, pad, bias)``, each run at
``INT8_BATCHES`` (dynamic and static); ``INT8_EXTRA_CASES``: the variants no
generator shape reaches; ``INT8_TIMED``: the cases timed at the serving
artifacts' batch ``SERVE_BATCH``. ``chip_smoke.py``, the phase probe and
the plan tests read them; this module imports nothing of the port but
``kernels.int8``.
"""

from __future__ import annotations

from ..kernels.int8 import DIRECT, UP2

INT8_CASES = (
    ("Dense_0 128->4096", DIRECT, 1, 1, 128, 4096, 1, 1, 0, True),
    ("CGAN / CVAE Dense_0 160->4096", DIRECT, 1, 1, 160, 4096, 1, 1, 0, True),
    ("CGAN / CVAE embedding 10->32 (byte loads)", DIRECT, 1, 1, 10, 32, 1, 1, 0, False),
    *((f"GAN Conv_0 up2 {h}->{2 * h}", UP2, h, h, 256, 256, 4, 4, 0, False)
      for h in (4, 8, 16)),
    *((f"GAN Conv_1 3x3 at {h}", DIRECT, h, h, 256, 256, 3, 3, 1, True) for h in (8, 16, 32)),
    *((f"GAN Conv_2 1x1 at {h}", DIRECT, h, h, 256, 256, 1, 1, 0, True) for h in (4, 8, 16)),
    ("VAE res block 3x3 at 4", DIRECT, 4, 4, 256, 256, 3, 3, 1, True),
    ("VAE ConvTranspose 256->128 4->8", UP2, 4, 4, 256, 128, 4, 4, 0, True),
    ("VAE ConvTranspose 128->64 8->16", UP2, 8, 8, 128, 64, 4, 4, 0, True),
    ("VAE ConvTranspose 64->3 16->32", UP2, 16, 16, 64, 3, 4, 4, 0, True),
)
INT8_BATCHES = (1, 5, 64)
# beside them, the variants no generator shape reaches: the narrow (n8)
# kernel on a direct 3x3, and the byte-load kernel where the wide kernel's
# TMA stores cannot take the output (up2 with N not a multiple of a store
# box's channels; a row of 260 bytes)
INT8_EXTRA_CASES = (
    ("n8 direct 3x3 64->3", DIRECT, 16, 16, 64, 3, 3, 3, 1, True),
    ("up2 128->96 at 8 (bytes: N % 64)", UP2, 8, 8, 128, 96, 4, 4, 0, True),
    ("1x1 64->130 at 6 (bytes: 260-byte rows)", DIRECT, 6, 6, 64, 130, 1, 1, 0, False),
)
# the first leads chip_smoke.py's kernels line
INT8_TIMED = ("GAN Conv_1 3x3 at 32", "GAN Conv_0 up2 16->32", "GAN Conv_2 1x1 at 16",
              "Dense_0 128->4096", "VAE ConvTranspose 64->3 16->32")
SERVE_BATCH = 1000
