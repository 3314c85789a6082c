"""Device-mesh helpers.

The reference's only parallelism is OpenMP loop-splitting inside one
address space (e.g. reference src/tvl1flow.cpp:98).  tpuflow scales
across devices with a `jax.sharding.Mesh`; the canonical axes are

  * "batch" — data parallel over frame pairs (throughput axis)
  * "y", "x" — spatial tiling of one frame with halo exchange
    (for resolutions that exceed one device, e.g. the 4K config)
  * "t" — frame axis for the temporal methods (ring halo)

Multi-host runs use the same mesh over all processes' devices after
`jax.distributed.initialize()` (standard JAX: the mesh spans hosts and
XLA inserts the collectives).  The mesh shape follows the algorithm
alone: the GPUs of one host are joined all to all by NVLink, so no
axis order is cheaper than another.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(axes, devices=None):
    """Create a Mesh from {"name": size, ...} (sizes must multiply to
    the device count; use -1 once for 'remaining devices')."""
    devices = jax.devices() if devices is None else devices
    names = tuple(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, "
                         f"have {len(devices)}")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, names)


def batch_sharding(mesh, axis="batch"):
    """Sharding for a (B, H, W) batch of images split over `axis`."""
    return NamedSharding(mesh, PartitionSpec(axis, None, None))


def spatial_sharding(mesh, y_axis="y", x_axis="x"):
    """Sharding for one (H, W) image tiled over a 2D mesh."""
    return NamedSharding(mesh, PartitionSpec(y_axis, x_axis))
