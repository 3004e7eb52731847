"""Datasets as packed uint8 arrays and the loader that serves them from the card (port of ``mcgm_tpu/data``)."""
