"""Spatial (H x W) sharding for the 4K multiscale configs.

BASELINE config 5 runs tvl1occflow / robust_expo on >= 4K frames tiled
over a (y, x) device mesh.  Two lanes exist in tpuflow:

  * `tpuflow.parallel.tiled` — explicit shard_map + ppermute halo
    exchange, bit-exact vs single-device, single-scale TV-L1 only.
  * THIS module — GSPMD auto-partitioning: inputs are device_put with a
    NamedSharding over the (y, x) mesh and the UNMODIFIED multiscale
    solvers run on them with `warp_mode="fast"`.  Every op on the hot
    path is then static shifts / elementwise math / separable convs,
    which XLA's SPMD partitioner turns into per-tile compute plus halo
    `collective-permute`s between devices automatically — the "annotate
    shardings, let XLA insert collectives" recipe (SURVEY.md §5.8).
    The two global ops per scale — joint normalization min/max and
    DF-AUTO's percentile sort (robust_expo) — become all-reduce /
    all-gather, both once per scale and off the hot loop.

The bounded warp is the key enabler: the exact gather warp would force
an all-gather of the full frame per warp, while `warp_planes_shift`
(warp_mode="fast") is a static-shift stencil whose halo is the per-level
displacement bound — tile-local communication only.

Numerics: identical operations in a different partition order; f32
reductions may reassociate, so tests assert EPE-level agreement
(<1e-5) rather than bitwise equality.

Reference solvers this config targets: src/tvl1occflow.cpp:143-328,
src/robust_expo_methods.cpp:161-455 (the reference itself has no
multi-node story at all — OpenMP rows on one socket is its ceiling).
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_spatial_mesh(y=None, x=None, devices=None):
    """(y, x) mesh over the available devices; defaults to the most
    square factorization."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if y is None or x is None:
        y = 1
        for cand in range(int(n ** 0.5), 0, -1):
            if n % cand == 0:
                y = cand
                break
        x = n // y
    return Mesh(np.asarray(devices[: y * x]).reshape(y, x), ("y", "x"))


def shard_spatial(arrays, mesh):
    """Place (..., H, W) arrays tiled over mesh axes ("y", "x")."""
    out = []
    for a in arrays:
        spec = PartitionSpec(*([None] * (a.ndim - 2) + ["y", "x"]))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def tvl1occflow_spatial(Im1, I0, I1, filt_i0=None, mesh=None, **kwargs):
    """Spatially-sharded multiscale tvl1occflow (4K tiled config).

    Shards the three frames (+ smoothed frame) over a (y, x) mesh and
    runs the standard multiscale solver with the shift-based bounded
    warp; XLA partitions every level (pyramid construction included)
    with halo collectives.  Same signature/returns as
    `tpuflow.models.tvl1occflow.tvl1occflow`."""
    from tpuflow.models.tvl1occflow import tvl1occflow

    mesh = make_spatial_mesh() if mesh is None else mesh
    if filt_i0 is None:
        filt_i0 = I0
    Im1, I0, I1, filt_i0 = shard_spatial((Im1, I0, I1, filt_i0), mesh)
    kwargs.setdefault("warp_mode", "fast")
    return tvl1occflow(Im1, I0, I1, filt_i0, **kwargs)


def robust_expo_spatial(I1, I2, mesh=None, **kwargs):
    """Spatially-sharded multiscale robust_expo (4K tiled config).

    Same signature/returns as `tpuflow.models.robust_expo.robust_expo`.
    DF-AUTO (method_type=3) includes a global percentile sort — one
    all-gather per scale, off the hot loop."""
    from tpuflow.models.robust_expo import robust_expo

    mesh = make_spatial_mesh() if mesh is None else mesh
    I1, I2 = shard_spatial((I1, I2), mesh)
    kwargs.setdefault("warp_mode", "fast")
    return robust_expo(I1, I2, **kwargs)


def tvl1_spatial(I0, I1, mesh=None, **kwargs):
    """Spatially-sharded multiscale TV-L1 (the same lane for the
    flagship solver; complements the explicit shard_map single-scale
    `tpuflow.parallel.tiled.tvl1_scale_tiled`)."""
    from tpuflow.models.tvl1 import tvl1_multiscale

    mesh = make_spatial_mesh() if mesh is None else mesh
    I0, I1 = shard_spatial((I0, I1), mesh)
    kwargs.setdefault("warp_mode", "fast")
    return tvl1_multiscale(I0, I1, **kwargs)
