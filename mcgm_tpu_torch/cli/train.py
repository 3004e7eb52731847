"""Training entry point of the port (mcgan, cgan, mcvae, cvae, vqvae,
mcpixelcnn, cpixelcnn, mcglow, cglow and the classifier):

    python -m mcgm_tpu_torch.cli.train --data_name CIFAR10 --model_name mcgan \
        [--control_name 0.5] [--num_epochs N] [--resume_mode 1] [--device cpu]

(``--control_name None`` for cgan, cvae, vqvae, cpixelcnn, cglow and the
classifier.) A Glow starting from scratch first runs ActNorm's
data-dependent init over the first ``num_init_batches`` (8) train batches. A PixelCNN trains on the codes of the VQ-VAE of the same seed
and data (``--ae_name vqvae``, the default), whose ``_best`` checkpoint
must exist: train ``--model_name vqvae`` first.

It runs on the card unless ``--device cpu`` is given, and raises if there is
no card. ``data_dir`` must hold ``CIFAR10/processed/{train,test}.npz`` or the
raw python batches under ``CIFAR10/raw/cifar-10-batches-py``; IS / FID read
``{output_dir}/inception/inception_v3.pkl`` when it exists.
"""

from __future__ import annotations

from ..train.loop import run_experiments
from ._common import parse_cfg


def main(argv=None, **defaults):
    """Parse the flags (``defaults`` set keys first, as config entries) and
    run the experiments; returns them."""
    return run_experiments(parse_cfg(argv, **defaults))


if __name__ == "__main__":
    main()
