"""The displacement-bounded shift warp (`warp_mode="fast"`) vs the exact
gather warp.

The shift warp evaluates the identical 16-tap bicubic for flows within
the static bound; flows beyond the bound produce 0 (documented)."""

import jax.numpy as jnp
import numpy as np

from tpuflow.ops import warp_planes
from tpuflow.ops.interp import warp_planes_shift


def _case(ny=53, nx=77, nplanes=3, amp=2.5, clip=3.0, seed=2):
    rng = np.random.default_rng(seed)
    I = 128 + 100 * rng.standard_normal((nplanes, ny, nx))
    u = np.clip(rng.standard_normal((ny, nx)) * amp, -clip, clip)
    v = np.clip(rng.standard_normal((ny, nx)) * amp, -clip, clip)
    return jnp.asarray(I), jnp.asarray(u), jnp.asarray(v)


def test_shift_warp_matches_gather_f64():
    I, u, v = _case()
    a = warp_planes(I, u, v, border_out=True)
    b = warp_planes_shift(I, u, v, 3, border_out=True)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-11)


def test_shift_warp_large_displacement():
    I, u, v = _case(amp=6.0, clip=8.0, seed=5)
    a = warp_planes(I, u, v, border_out=True)
    b = warp_planes_shift(I, u, v, 8, border_out=True)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-11)


def test_shift_warp_out_of_bound_flow_zeroes():
    I, u, v = _case()
    u = u.at[10, 10].set(25.0)  # exceeds dmax
    b = warp_planes_shift(I, u, v, 3, border_out=True)
    assert float(np.abs(np.asarray(b)[:, 10, 10]).max()) == 0.0
