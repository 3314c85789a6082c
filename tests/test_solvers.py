"""Solver-level tests against reference oracles (deterministic,
single-threaded reference runs)."""

import jax.numpy as jnp
import numpy as np

from tpuflow.models import hs_classic_jit, tvl1_multiscale, tvl1_scale


def _epe(u1, v1, u2, v2):
    return float(np.mean(np.hypot(np.asarray(u1) - u2, np.asarray(v1) - v2)))


def test_hs_classic_exact(solver_goldens):
    g = solver_goldens
    u, v = hs_classic_jit(jnp.asarray(g["I0"]), jnp.asarray(g["I1"]),
                          niter=100, alpha=20.0)
    np.testing.assert_allclose(u, g["hs_classic_u"], atol=1e-9)
    np.testing.assert_allclose(v, g["hs_classic_v"], atol=1e-9)


def test_hs_classic_f32(solver_goldens):
    g = solver_goldens
    u, v = hs_classic_jit(
        jnp.asarray(g["I0"], dtype=jnp.float32),
        jnp.asarray(g["I1"], dtype=jnp.float32), niter=100, alpha=20.0)
    assert u.dtype == jnp.float32
    assert _epe(u, v, g["hs_classic_u"], g["hs_classic_v"]) < 1e-4


def test_tvl1_scale_exact(solver_goldens):
    """Single-scale TV-L1 in f64 must track the C oracle closely: the
    iteration sequence is identical (pointwise ops + identical stencils),
    only summation order in the error reduction differs."""
    g = solver_goldens
    u = jnp.zeros_like(jnp.asarray(g["n0"]))
    u1, u2 = tvl1_scale(jnp.asarray(g["n0"]), jnp.asarray(g["n1"]), u, u,
                        tau=0.25, lam=0.15, theta=0.3, warps=5, epsilon=0.01)
    assert _epe(u1, u2, g["tvl1_scale_u"], g["tvl1_scale_v"]) < 1e-8


def test_tvl1_multiscale_f64(solver_goldens):
    g = solver_goldens
    u1, u2 = tvl1_multiscale(jnp.asarray(g["I0"]), jnp.asarray(g["I1"]),
                             nscales=5, zfactor=0.5, warps=5,
                             clamp_scales=False)
    assert _epe(u1, u2, g["tvl1_multi_u"], g["tvl1_multi_v"]) < 1e-6


def test_tvl1_multiscale_f32(solver_goldens):
    """The f32 path must stay within the 0.05 EPE parity budget
    (it lands orders of magnitude below it)."""
    g = solver_goldens
    u1, u2 = tvl1_multiscale(
        jnp.asarray(g["I0"], dtype=jnp.float32),
        jnp.asarray(g["I1"], dtype=jnp.float32),
        nscales=5, zfactor=0.5, warps=5, clamp_scales=False)
    assert u1.dtype == jnp.float32
    assert _epe(u1, u2, g["tvl1_multi_u"], g["tvl1_multi_v"]) < 5e-3


def test_tvl1_fixed_iteration_mode(solver_goldens):
    """stop='fixed' runs the fixed point to a deterministic budget (for
    batching/benchmarks) — a different but equally valid operating
    point.  Both modes must recover the synthetic ground-truth flow to
    comparable accuracy."""
    g = solver_goldens
    u1a, u2a = tvl1_multiscale(jnp.asarray(g["I0"]), jnp.asarray(g["I1"]),
                               nscales=3, zfactor=0.5, warps=2,
                               stop="error", clamp_scales=False)
    u1b, u2b = tvl1_multiscale(jnp.asarray(g["I0"]), jnp.asarray(g["I1"]),
                               nscales=3, zfactor=0.5, warps=2,
                               stop="fixed", max_iterations=100,
                               clamp_scales=False)
    epe_err = _epe(u1a, u2a, g["true_u"], g["true_v"])
    epe_fix = _epe(u1b, u2b, g["true_u"], g["true_v"])
    assert np.isfinite(epe_fix)
    assert epe_fix < max(2.0 * epe_err, 0.5)


def test_hs_classic_batched_matches_per_sample():
    """hs_classic_batched (a vmap of the Jacobi loop, `niter` a runtime
    scalar) equals per-sample hs_classic."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    from tpuflow.models.hs_classic import hs_classic, hs_classic_batched

    rng = np.random.default_rng(2)
    base = gaussian_filter(rng.standard_normal((3, 40, 58)), (0, 2.5, 2.5))
    base = base * 100 + 128
    a = jnp.asarray(base[:, :, :56])
    b = jnp.asarray(base[:, :, 2:])
    u_b, v_b = hs_classic_batched(a, b, jnp.asarray(30, jnp.int32), 7.0)
    for k in range(3):
        u, v = hs_classic(a[k], b[k], 30, 7.0)
        np.testing.assert_allclose(np.asarray(u_b[k]), np.asarray(u),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(v_b[k]), np.asarray(v),
                                   rtol=0, atol=1e-12)
