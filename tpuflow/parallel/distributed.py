"""Multi-host entry point and data-parallel scaling helpers.

The reference is a single-process OpenMP program (e.g. reference
src/tvl1flow.cpp:98); its scaling ceiling is one CPU socket.  tpuflow's
multi-host story is the standard JAX recipe (SURVEY.md §5.8):

  1. every process calls `initialize()` (a thin wrapper over
     `jax.distributed.initialize`, no-op when single-process),
  2. a single `Mesh` spans all processes' devices,
  3. `jit` over sharded arrays inserts the collectives itself (NCCL
     between GPUs).

Because each frame pair's solve is independent (batch data parallelism,
the throughput axis), the only cross-device traffic in a DP run is the
initial scatter and the final gather — scaling efficiency is bounded by
dispatch overheads, not communication.  `dp_efficiency` measures it:
time a batch of B on 1 device vs. B·n sharded over n devices; perfect
scaling keeps the wall time equal (efficiency = t1 / tn).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kw):
    """Multi-host init: call once per process before any JAX op.

    A no-op for single-process runs (the common case: one process
    drives every GPU of a host).  Multi-process runs pass the
    coordinator explicitly, e.g. `initialize("localhost:12345", 2, 0)`
    in process 0 and `initialize("localhost:12345", 2, 1)` in
    process 1.
    """
    if num_processes in (None, 1) and coordinator_address is None:
        # single-process: nothing to coordinate
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)
    return True


def dp_shard(arrays, mesh, axis="batch"):
    """Place (B, ...) arrays batch-sharded over `mesh[axis]`."""
    out = []
    for a in arrays:
        spec = PartitionSpec(axis, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def _sync(x):
    return jax.block_until_ready(x)


def dp_efficiency(step, make_batch, per_device_batch, devices=None,
                  repeats=3):
    """Measure data-parallel scaling efficiency of `step`.

    step(I0, I1) -> arrays; make_batch(B) -> (I0, I1) host arrays.
    Returns {n_devices: {"fields_per_sec": ..., "efficiency": ...}} for
    n = 1, 2, ..., len(devices) (powers of two), efficiency relative to
    the single-device throughput (≥0.8 is the BASELINE.md target).
    """
    devices = jax.devices() if devices is None else devices
    results = {}
    base_fps = None
    n = 1
    while n <= len(devices):
        B = per_device_batch * n
        I0, I1 = make_batch(B)
        mesh = Mesh(np.asarray(devices[:n]).reshape(n), ("batch",))
        I0s, I1s = dp_shard((jnp.asarray(I0), jnp.asarray(I1)), mesh)
        _sync(step(I0s, I1s))  # compile
        t0 = time.perf_counter()
        for _ in range(repeats):
            _sync(step(I0s, I1s))
        dt = (time.perf_counter() - t0) / repeats
        fps = B / dt
        if base_fps is None:
            base_fps = fps
        results[n] = {
            "fields_per_sec": round(fps, 3),
            "efficiency": round(fps / (base_fps * n), 4),
        }
        n *= 2
    return results
