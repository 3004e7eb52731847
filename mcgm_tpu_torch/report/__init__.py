"""Run records: the experiment logger and step timing (port of ``mcgm_tpu/report``)."""
