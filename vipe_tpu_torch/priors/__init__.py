"""Priors that feed the SLAM layer (port of ``vipe_tpu/priors``)."""
