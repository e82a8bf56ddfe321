"""Gate layers, kernel feeders and the hand-written kernels (port of dtc_tpu.ops)."""
