"""dtc_tpu_torch — PyTorch/CUDA port of the dtc_tpu simulation framework.

The JAX package ``dtc_tpu`` stays the reference; every module here names
the JAX file and function it ports. This package imports ``torch`` and
never ``jax``. Hand-written Hopper kernels live in ``csrc/`` and are built
at first use by ``ops/_build.py``.
"""
