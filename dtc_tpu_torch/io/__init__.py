"""Result files: disorder instances, config-encoded names, column CSVs
(copies of the JAX package's jax-free io modules)."""
