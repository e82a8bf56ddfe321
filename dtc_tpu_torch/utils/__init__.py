"""CLI and parameter carry-over from the JAX reference (port of dtc_tpu.utils)."""
