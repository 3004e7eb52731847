"""Datasets: packers from raw files, packed uint8 arrays, channel
statistics, and the loader that serves them from the card (port of
``mcgm_tpu/data``)."""
