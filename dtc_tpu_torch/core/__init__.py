"""State construction and the sigma-frame trajectory engine (port of dtc_tpu.core)."""
