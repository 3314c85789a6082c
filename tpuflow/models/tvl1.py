"""TV-L1 optical flow (Zach/Pock/Bischof duality, Sanchez et al. impl).

Vectorized re-design of reference src/tvl1flow.cpp:

  * the per-warp setup (3 warps of I1/I1x/I1y) becomes ONE fused
    3-plane bicubic gather (`warp_planes`) — the index/weight math is
    computed once instead of 3x (reference calls
    bicubic_interpolation_warp three times, src/tvl1flow.cpp:94-96)
  * the inner fixed point (thresholding TH -> u update -> Chambolle
    dual ascent, src/tvl1flow.cpp:113-181) runs as a
    `lax.while_loop` whose carry holds (u, p, error, n); the stopping
    rule replicates `error > eps^2 && n < 300` with error = mean
    squared flow update
  * everything per scale lives in one jit; the warp loop is unrolled
    (warps is small and static)

Two iteration modes:
  * `stop="error"` (default) — faithful data-dependent stopping
  * `stop="fixed"`  — fixed iteration count (for batching via vmap and
    for deterministic benchmarking); convergence-equivalent when the
    count is >= the reference's stopping iteration
"""

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.models.common import run_pyramid
from tpuflow.ops import (
    centered_gradient,
    clamp_nscales,
    divergence,
    forward_gradient,
    warp_planes,
)
from tpuflow.ops.interp import warp_planes_shift

MAX_ITERATIONS = 300  # reference src/tvl1flow.cpp:22
GRAD_IS_ZERO = 1e-10  # reference src/tvl1flow.cpp:24

# CLI defaults, reference src/tvl1flow_main.cpp:24-33
DEFAULT_TAU = 0.25
DEFAULT_LAMBDA = 0.15
DEFAULT_THETA = 0.3
DEFAULT_NSCALES = 100
DEFAULT_ZFACTOR = 0.5
DEFAULT_WARPS = 5
DEFAULT_EPSILON = 0.01


def _inner_step(u1, u2, p11, p12, p21, p22, I1wx, I1wy, rho_c, grad,
                l_t, theta, taut):
    """One TV-L1 fixed-point iteration (reference src/tvl1flow.cpp:113-181)."""
    # thresholding operator TH -> v
    rho = rho_c + I1wx * u1 + I1wy * u2
    fi = -rho / jnp.maximum(grad, GRAD_IS_ZERO)
    d1 = jnp.where(
        rho < -l_t * grad, l_t * I1wx,
        jnp.where(rho > l_t * grad, -l_t * I1wx,
                  jnp.where(grad < GRAD_IS_ZERO, 0.0, fi * I1wx)))
    d2 = jnp.where(
        rho < -l_t * grad, l_t * I1wy,
        jnp.where(rho > l_t * grad, -l_t * I1wy,
                  jnp.where(grad < GRAD_IS_ZERO, 0.0, fi * I1wy)))
    v1 = u1 + d1
    v2 = u2 + d2

    # primal update u = v + theta * div(p)
    u1_new = v1 + theta * divergence(p11, p12)
    u2_new = v2 + theta * divergence(p21, p22)
    error = jnp.mean((u1_new - u1) ** 2 + (u2_new - u2) ** 2)

    # Chambolle dual ascent
    u1x, u1y = forward_gradient(u1_new)
    u2x, u2y = forward_gradient(u2_new)
    g1 = jnp.hypot(u1x, u1y)
    g2 = jnp.hypot(u2x, u2y)
    ng1 = 1.0 + taut * g1
    ng2 = 1.0 + taut * g2
    p11 = (p11 + taut * u1x) / ng1
    p12 = (p12 + taut * u1y) / ng1
    p21 = (p21 + taut * u2x) / ng2
    p22 = (p22 + taut * u2y) / ng2
    return u1_new, u2_new, p11, p12, p21, p22, error


def tvl1_scale(I0, I1, u1, u2, tau=DEFAULT_TAU, lam=DEFAULT_LAMBDA,
               theta=DEFAULT_THETA, warps=DEFAULT_WARPS,
               epsilon=DEFAULT_EPSILON, max_iterations=MAX_ITERATIONS,
               stop="error", with_diag=False, warp_mode="exact", dmax=8):
    """Single-scale TV-L1 (reference Dual_TVL1_optic_flow,
    src/tvl1flow.cpp:46-212).  Inputs are assumed normalized+presmoothed
    (the multiscale driver does that).

    `with_diag=True` additionally returns a dict with per-warp stopping
    statistics — `iterations` (warps,) int32 and `error` (warps,) — the
    scalars the reference prints when verbose (src/tvl1flow.cpp:184-188).
    """
    dtype = I0.dtype
    l_t = lam * theta
    taut = tau / theta
    I1x, I1y = centered_gradient(I1)

    planes = jnp.stack([I1, I1x, I1y])
    zero = jnp.zeros_like(u1)

    def warp_body(carry, _):
        u1, u2, p11, p12, p21, p22 = carry
        if warp_mode == "fast":
            I1w, I1wx, I1wy = warp_planes_shift(planes, u1, u2, dmax)
        else:
            I1w, I1wx, I1wy = warp_planes(planes, u1, u2, border_out=True)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u1 - I1wy * u2 - I0

        if stop == "error":
            def cond(c):
                return (c[6] > epsilon * epsilon) & (c[7] < max_iterations)

            def body(c):
                out = _inner_step(c[0], c[1], c[2], c[3], c[4], c[5],
                                  I1wx, I1wy, rho_c, grad, l_t, theta, taut)
                return out + (c[7] + 1,)

            init = (u1, u2, p11, p12, p21, p22,
                    jnp.asarray(jnp.inf, dtype=dtype), jnp.asarray(0, jnp.int32))
            fin = jax.lax.while_loop(cond, body, init)
            return fin[:6], (fin[7], fin[6])

        def body(_, c):
            out = _inner_step(c[0], c[1], c[2], c[3], c[4], c[5],
                              I1wx, I1wy, rho_c, grad, l_t, theta, taut)
            return out[:6] + (out[6],)

        fin = jax.lax.fori_loop(
            0, max_iterations, body,
            (u1, u2, p11, p12, p21, p22, jnp.asarray(jnp.inf, dtype=dtype)))
        return fin[:6], (jnp.asarray(max_iterations, jnp.int32), fin[6])

    carry, (ns, errs) = jax.lax.scan(
        warp_body, (u1, u2, zero, zero, zero, zero), None, length=warps)
    u1, u2 = carry[0], carry[1]
    if with_diag:
        return u1, u2, {"iterations": ns, "error": errs}
    return u1, u2


@partial(jax.jit, static_argnames=("tau", "lam", "theta", "warps", "epsilon",
                                   "max_iterations", "stop", "with_diag",
                                   "warp_mode", "dmax"))
def _tvl1_scale_jit(I0, I1, u1, u2, tau, lam, theta, warps, epsilon,
                    max_iterations, stop, with_diag=False,
                    warp_mode="exact", dmax=8):
    return tvl1_scale(I0, I1, u1, u2, tau, lam, theta, warps, epsilon,
                      max_iterations, stop, with_diag=with_diag,
                      warp_mode=warp_mode, dmax=dmax)


def tvl1_multiscale(I0, I1, tau=DEFAULT_TAU, lam=DEFAULT_LAMBDA,
                    theta=DEFAULT_THETA, nscales=DEFAULT_NSCALES,
                    zfactor=DEFAULT_ZFACTOR, warps=DEFAULT_WARPS,
                    epsilon=DEFAULT_EPSILON, max_iterations=MAX_ITERATIONS,
                    stop="error", clamp_scales=True, level_callback=None,
                    resume=None, verbose=False, with_diag=False,
                    warp_mode="exact", max_motion=8):
    """Multiscale TV-L1 (reference Dual_TVL1_optic_flow_multiscale,
    src/tvl1flow.cpp:219-328).  Returns (u, v), or (u, v, diags) with
    `with_diag=True` where diags[s] is the per-warp stopping-statistic
    dict of scale s (finest first, None for levels skipped by resume).

    `clamp_scales` applies the CLI's auto-clamp so the coarsest level
    stays >= 16 px along the diagonal (src/tvl1flow_main.cpp:185-187).
    `level_callback`/`resume` are the checkpoint/observability hooks
    (tpuflow.utils.checkpoint; SURVEY.md §5.4).  `verbose` prints the
    reference binary's stderr lines: `Scale %d: %dx%d` per level
    (src/tvl1flow.cpp:284-286) and `Warping: %d, Iterations: %d,
    Error: %f` per warp (src/tvl1flow.cpp:184-188).

    `warp_mode` selects the warp implementation: "exact" (default) =
    the reference's full bicubic gather; "fast" = the
    displacement-bounded shift warp (`warp_planes_shift`) with
    per-level bound max(3, ceil(max_motion * zfactor**s)) (flows beyond
    the bound produce 0, the border_out failure class), which GSPMD
    partitions with tile-local halos (tpuflow.parallel.spatial).
    """
    import math
    import sys

    ny, nx = I0.shape[-2:]
    if clamp_scales:
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=True)

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(images, u1, u2, scale=None):
        lvl_I0, lvl_I1 = images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = _tvl1_scale_jit(lvl_I0, lvl_I1, u1, u2, tau, lam, theta,
                              warps, epsilon, max_iterations, stop,
                              with_diag=diag, warp_mode=warp_mode,
                              dmax=dmax)
        if diag:
            u1, u2, d = out
            diags[scale] = d
            if verbose:
                lny, lnx = lvl_I0.shape[-2:]
                print(f"Scale {scale}: {lnx}x{lny}", file=sys.stderr)
                for w in range(warps):
                    print(f"Warping: {w}, Iterations: {int(d['iterations'][w])}, "
                          f"Error: {float(d['error'][w]):f}", file=sys.stderr)
            return u1, u2
        return out

    u1, u2, _ = run_pyramid((I0, I1), nscales, zfactor, solve,
                            level_callback=level_callback, resume=resume,
                            trace_name="tvl1")
    if with_diag:
        return u1, u2, diags
    return u1, u2
