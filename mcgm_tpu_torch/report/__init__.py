"""Run records and results: the experiment logger, step timing, results
over seeds, learning curves and parameter tables (port of
``mcgm_tpu/report``)."""
