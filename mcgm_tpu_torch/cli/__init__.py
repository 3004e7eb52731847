"""Command-line entry points (port of ``mcgm_tpu/cli``)."""
