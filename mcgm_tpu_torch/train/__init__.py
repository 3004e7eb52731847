"""Training: optimizers and the GAN train step (port of ``mcgm_tpu/train``)."""
