"""Batched TV-L1 and pyramidal HS (the throughput path) against the
single-pair solvers."""

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.models.batch import tvl1_batched
from tpuflow.models.tvl1 import tvl1_multiscale


def test_batched_matches_error_stop(solver_goldens):
    """The fixed-schedule batched path lands within the parity budget of
    the faithful data-dependent-stopping path."""
    g = solver_goldens
    B = 2
    I0 = jnp.asarray(np.stack([g["I0"]] * B))
    I1 = jnp.asarray(np.stack([g["I1"]] * B))
    u_b, v_b = tvl1_batched(I0, I1, nscales=3)
    u_r, v_r = tvl1_multiscale(jnp.asarray(g["I0"]), jnp.asarray(g["I1"]),
                               nscales=3, clamp_scales=False)
    epe = float(np.mean(np.hypot(np.asarray(u_b[0]) - np.asarray(u_r),
                                 np.asarray(v_b[0]) - np.asarray(v_r))))
    assert epe < 0.05, epe
    # batch samples are independent: identical inputs -> identical flows
    np.testing.assert_array_equal(np.asarray(u_b[0]), np.asarray(u_b[1]))


def _smooth_pair(ny=128, nx=192, seed=9):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((ny, nx))
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    base = np.real(np.fft.ifft2(np.fft.fft2(noise)
                                * np.exp(-(fx ** 2 + fy ** 2) * 800)))
    I0 = 128 + 90 * base / np.abs(base).max()
    return I0, np.roll(I0, 1, axis=1)


def test_batched_big_level_matches_exact():
    """A 128x192 finest level through the batched engine (batched
    exact gather + per-sample stopping) against the single-pair exact
    path."""
    I0, I1 = _smooth_pair()
    u_b, v_b = tvl1_batched(jnp.asarray(I0[None]), jnp.asarray(I1[None]),
                            nscales=3)
    u_r, v_r = tvl1_multiscale(jnp.asarray(I0), jnp.asarray(I1), nscales=3,
                               clamp_scales=False)
    epe = float(np.mean(np.hypot(np.asarray(u_b[0]) - np.asarray(u_r),
                                 np.asarray(v_b[0]) - np.asarray(v_r))))
    assert epe < 0.05, epe


def test_hs_batched_matches_unbatched(solver_goldens):
    from tpuflow.models.batch import hs_pyramidal_batched
    from tpuflow.models.hs_pyramidal import hs_pyramidal

    g = solver_goldens
    I1 = jnp.asarray(g["I0"], dtype=jnp.float32)
    I2 = jnp.asarray(g["I1"], dtype=jnp.float32)
    u_b, v_b = hs_pyramidal_batched(I1[None], I2[None], nscales=3)
    u_r, v_r = hs_pyramidal(I1, I2, nscales=3, clamp_scales=False)
    epe = float(np.mean(np.hypot(np.asarray(u_b[0]) - np.asarray(u_r),
                                 np.asarray(v_b[0]) - np.asarray(v_r))))
    assert epe < 0.05, epe


def test_warp_early_exit_equivalence():
    """The r5 warp-level early exit (skip remaining warps once a warp
    converges within 2 inner iterations) must stay well inside the
    0.05 parity budget vs the strictly reference-faithful all-warps
    schedule (measured ~0.017 on this adversarial constant-shift pair;
    ~0.007 end-to-end vs the reference binary on smooth content).
    """
    rng = np.random.default_rng(3)
    ny, nx = 96, 128
    from scipy.ndimage import gaussian_filter

    base = gaussian_filter(rng.standard_normal((ny, nx + 4)), 3.0)
    base = base * 120 + 128
    I0 = jnp.asarray(base[:, :nx][None], jnp.float32)
    I1 = jnp.asarray(base[:, 2:nx + 2][None], jnp.float32)
    u_e, v_e = tvl1_batched(I0, I1, nscales=2, stop="error")
    u_f, v_f = tvl1_batched(I0, I1, nscales=2, stop="error",
                            warp_early_exit=False)
    epe = float(np.mean(np.hypot(np.asarray(u_e) - np.asarray(u_f),
                                 np.asarray(v_e) - np.asarray(v_f))))
    assert epe < 0.03, epe


def test_hs_batched_big_level_vs_exact_f64():
    """Batched HS at a 128x192 finest level against the single-pair
    exact float64 path (the reference-faithful warp count)."""
    from tpuflow.models.batch import hs_pyramidal_batched
    from tpuflow.models.hs_pyramidal import hs_pyramidal

    I0, I1 = _smooth_pair(seed=4)
    u_b, v_b = hs_pyramidal_batched(jnp.asarray(I0[None]),
                                    jnp.asarray(I1[None]), nscales=3,
                                    warp_early_exit=False)
    u_r, v_r = hs_pyramidal(jnp.asarray(I0), jnp.asarray(I1), nscales=3,
                            clamp_scales=False)
    assert u_b.dtype == jnp.float64
    epe = float(np.mean(np.hypot(np.asarray(u_b[0]) - np.asarray(u_r),
                                 np.asarray(v_b[0]) - np.asarray(v_r))))
    assert epe < 0.05, epe
