"""Amplitude sharding on a single-controller device mesh (port of
``dtc_tpu/parallel``)."""
