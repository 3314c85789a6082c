"""tpuflow — a data-parallel dense optical-flow engine in JAX.

A from-scratch JAX/XLA re-design of the classical variational
optical-flow method family collected in the reference C/C++ library
(`devernay/optical-flow`): Horn-Schunck (classic + pyramidal), TV-L1
(Zach/Pock/Bischof duality), Brox et al. robust flow (spatial + temporal),
joint TV-L1 flow + occlusion estimation, and the robust exponential
discontinuity-preserving tensor methods.

Design principles (a re-design, not a translation):
  * images are (H, W) / (C, H, W) jnp arrays
  * all stencils are shift/pad expressions XLA fuses into one pass
  * warping is a vectorized 16-tap bicubic gather whose tap indices
    and weights are shared by every warped plane
  * Gauss-Seidel SOR sweeps become red-black half-sweeps (two masked
    vector updates) — convergence-equivalent to the reference, whose
    OpenMP sweeps race on neighbor reads by design
  * fixed-point iteration runs under `lax.while_loop`/`lax.scan`; a
    whole coarse-to-fine pyramid is one jitted program, with the
    convergence error in the loop carry
  * multi-device scaling uses `jax.sharding.Mesh` + `shard_map` with
    halo exchange via `lax.ppermute` (see `tpuflow.parallel`)
"""

__version__ = "0.1.0"

from tpuflow.config import default_dtype
