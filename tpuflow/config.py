"""Global numeric configuration.

The reference computes in C ``double`` (``ofpix_t`` = double via
``OFPIX_DOUBLE``, reference src/of.h:4-10) but always writes float32
``.flo`` files.  On the GPU the compute type is float32; float64 is
the oracle precision (CPU tests, and the GPU reference in
chip_smoke.py).  Every tpuflow op derives its
compute dtype from its input arrays, so the caller picks the policy by
casting the inputs; `default_dtype` is only used when materializing new
arrays from Python scalars.
"""

import jax.numpy as jnp

default_dtype = jnp.float32


def result_dtype(*arrays):
    """Common dtype of the inputs, falling back to `default_dtype`."""
    dtypes = [a.dtype for a in arrays if hasattr(a, "dtype")]
    if not dtypes:
        return default_dtype
    return jnp.result_type(*dtypes)
