"""Post-processing of autocorrelation traces (copies of the JAX package's
analysis modules)."""
