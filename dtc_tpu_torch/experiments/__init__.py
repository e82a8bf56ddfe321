"""Sweep machinery and experiment drivers (port of dtc_tpu.experiments)."""
