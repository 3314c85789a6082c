"""The plain call of the four spatial multiscale solvers runs the whole
coarse-to-fine pyramid as one jitted program; the per-level host loop
(`_whole=False`, the path behind verbose output, diagnostics and
checkpoint hooks) must compute the same flow."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpuflow.models.brox_spatial import brox_spatial
from tpuflow.models.brox_temporal import brox_temporal
from tpuflow.models.robust_expo import robust_expo
from tpuflow.models.tvl1occflow import tvl1occflow


def _frames(n, ny=32, nx=48, seed=0):
    """n frames of one smooth random image drifting one pixel per frame
    along x (float64)."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx + n)[None, :]
    base = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((ny, nx + n)))
                                * np.exp(-(fx ** 2 + fy ** 2) * 300)))
    base = 128 + 90 * base / np.abs(base).max()
    return [jnp.asarray(base[:, k:k + nx]) for k in range(n)]


SOLVERS = {
    "brox_spatial": lambda f, whole: brox_spatial(
        f[0], f[1], nscales=2, outer_iter=4, _whole=whole),
    "robust_expo": lambda f, whole: robust_expo(
        f[0], f[1], nscales=2, outer_iter=4, _whole=whole),
    "tvl1occflow": lambda f, whole: tvl1occflow(
        f[0], f[1], f[2], nscales=2, warps=2, _whole=whole)[:2],
    "brox_temporal": lambda f, whole: brox_temporal(
        jnp.stack(f), nscales=2, zfactor=0.5, outer_iter=3, _whole=whole),
}


@pytest.mark.parametrize("method", sorted(SOLVERS))
def test_whole_pyramid_matches_per_level(method):
    frames = _frames(4)
    u_w, v_w = SOLVERS[method](frames, True)
    u_l, v_l = SOLVERS[method](frames, False)
    assert u_w.shape == u_l.shape and u_w.dtype == jnp.float64
    # one program vs one program per level: XLA may fuse (and so round)
    # differently, ~1e-14 in float64; tvl1occflow's discrete steps (3x3
    # median, chi >= 0.75 branch selection) amplify that to ~1e-7
    atol = 1e-5 if method == "tvl1occflow" else 1e-10
    np.testing.assert_allclose(np.asarray(u_w), np.asarray(u_l), atol=atol)
    np.testing.assert_allclose(np.asarray(v_w), np.asarray(v_l), atol=atol)
    assert float(np.abs(np.asarray(u_w)).max()) > 0.1
