"""Brox spatio-temporal solver vs the reference oracle (3D red-black
SOR vs the reference's frame-sequential sweep — same fixed point)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpuflow.models.brox_temporal import brox_temporal


def _epe(u1, v1, u2, v2):
    return float(np.mean(np.hypot(np.asarray(u1) - u2, np.asarray(v1) - v2)))


@pytest.fixture(scope="session")
def bt_goldens():
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(np.load(os.path.join(here, "goldens", "brox_temporal.npz")))


def test_single_scale_vs_reference(bt_goldens):
    g = bt_goldens
    u, v = brox_temporal(jnp.asarray(g["vol"]), nscales=1, clamp_scales=False)
    assert u.shape == (g["vol"].shape[0] - 1,) + g["vol"].shape[1:]
    epe = _epe(u, v, g["s1_u"], g["s1_v"])
    assert epe < 5e-3, epe


def test_pyramid_vs_reference(bt_goldens):
    g = bt_goldens
    u, v = brox_temporal(jnp.asarray(g["vol"]), nscales=2, clamp_scales=False)
    epe = _epe(u, v, g["s2_u"], g["s2_v"])
    assert epe < 5e-3, epe


def test_f32(bt_goldens):
    g = bt_goldens
    u, v = brox_temporal(jnp.asarray(g["vol"], dtype=jnp.float32),
                         nscales=2, clamp_scales=False)
    assert u.dtype == jnp.float32
    epe = _epe(u, v, g["s2_u"], g["s2_v"])
    assert epe < 1e-2, epe


def test_needs_three_frames(bt_goldens):
    g = bt_goldens
    with pytest.raises(ValueError):
        brox_temporal(jnp.asarray(g["vol"][:2]))


def test_recovers_truth(bt_goldens):
    """Each estimated field should recover the constant per-pair motion
    (true_u, true_v) reasonably well."""
    g = bt_goldens
    u, v = brox_temporal(jnp.asarray(g["vol"]), nscales=2, clamp_scales=False)
    epe = _epe(u, v, np.broadcast_to(g["true_u"], u.shape),
               np.broadcast_to(g["true_v"], v.shape))
    epe_ref = _epe(g["s2_u"], g["s2_v"],
                   np.broadcast_to(g["true_u"], u.shape),
                   np.broadcast_to(g["true_v"], v.shape))
    assert epe < epe_ref * 1.1 + 0.02, (epe, epe_ref)


def test_fast_warp_mode_matches_exact(bt_goldens):
    """warp_mode="fast" (per-frame 6-plane warps through the bounded
    shift path instead of the exact gather) must match the exact gather
    closely for in-bound flows."""
    g = bt_goldens
    vol = jnp.asarray(g["vol"], dtype=jnp.float32)
    u_e, v_e = brox_temporal(vol, nscales=2, clamp_scales=False,
                             warp_mode="exact")
    u_f, v_f = brox_temporal(vol, nscales=2, clamp_scales=False,
                             warp_mode="fast")
    assert _epe(u_f, v_f, np.asarray(u_e), np.asarray(v_e)) < 2e-3


def test_fast_warp_route_big_level():
    """At a 96x128 level the fast mode's shift warp, vmapped over the
    frame axis, must agree with the exact gather over two cheap
    fixed-sweep outer iterations."""
    rng = np.random.default_rng(7)
    ny, nx = 96, 128
    base = rng.standard_normal((ny + 8, nx + 8))
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(base, 3.0) * 120 + 128
    vol = np.stack([base[4 + dy:4 + dy + ny, 4:4 + nx]
                    for dy in (-1, 0, 1)])
    vol = jnp.asarray(vol, jnp.float32)
    kw = dict(nscales=1, clamp_scales=False, outer_iter=2, stop="fixed",
              maxiter=3)
    u_e, v_e = brox_temporal(vol, warp_mode="exact", **kw)
    u_f, v_f = brox_temporal(vol, warp_mode="fast", **kw)
    assert _epe(u_f, v_f, np.asarray(u_e), np.asarray(v_e)) < 2e-3
