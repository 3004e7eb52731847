"""IS / FID and the feature models they read (port of ``mcgm_tpu/evals``)."""
