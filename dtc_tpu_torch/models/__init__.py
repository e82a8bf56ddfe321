"""Model families (port of dtc_tpu.models): drive schedules and noise."""
