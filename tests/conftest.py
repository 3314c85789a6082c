"""Test configuration.

Tests run on the CPU (`JAX_PLATFORMS=cpu`) with 8 virtual devices (the
standard JAX recipe for multi-device testing without a cluster,
SURVEY.md §4.4) and with x64 enabled so op unit tests can compare
against the reference's double-precision oracles at ~1e-12.  Library
code always derives dtypes from its inputs, so enabling x64 here does
not change f32 behavior.  The persistent compile cache follows the
package policy (tpuflow.utils.cache), so repeat runs skip compilation.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from tpuflow.utils.cache import configure_cache

configure_cache()

import numpy as np
import pytest

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(scope="session")
def ops_goldens():
    return {
        tag: dict(np.load(os.path.join(GOLDENS, f"ops_{tag}.npz")))
        for tag in ("a", "b")
    }


@pytest.fixture(scope="session")
def solver_goldens():
    return dict(np.load(os.path.join(GOLDENS, "solvers.npz")))
