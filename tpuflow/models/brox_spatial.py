"""Brox et al. 2004 robust optical flow, spatial smoothness.

Reference: src/brox_optic_flow_spatial.cpp + src/brox_spatial_mask.cpp
(IPOL 2013.21, Sánchez et al.).  Structure per scale
(brox_optic_flow, src/brox_optic_flow_spatial.cpp:179-444):

  outer loop (<= outer_iter):
    warp I2 and its 5 derivative planes by the current flow (:246-251)
    psi_smooth from the flow gradient (:101-122)
    psi1..psi4 half-sum divergence coefficients, zero across the image
      boundary (src/brox_spatial_mask.cpp:16-93)
    div_u/div_v: psi-weighted divergence of the current flow (:100-171)
    inner loop (<= inner_iter, lagged nonlinearity):
      psi_data / psi_gradient robustness weights (:33-92)
      assemble Au/Av/Du/Dv/D incl. gradient-constancy Hessian terms
        (:283-309)
      SOR on the increment (du, dv) until sqrt(err/size) <= TOL or
        300 sweeps (:315-390, omega = 1.9)
    u += du (:398-401)

Design: all pointwise passes fuse under jit; the SOR sweep uses
RED-BLACK ordering — valid multicolor Gauss-Seidel here because the
divergence stencil is 5-point (no diagonal neighbors, unlike pyramidal
HS), so every neighbor of a red pixel is black.  Within a color the
dv update reads the just-updated du at the same pixel, matching the
reference's per-pixel ordering (:167-168).  Red-black and lexicographic
SOR converge to the same fixed point of each inner linear system;
tests validate EPE agreement against single-threaded reference runs.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.models.common import run_pyramid
from tpuflow.ops import centered_gradient, dxx, dxy, dyy, warp_planes
from tpuflow.ops.gradients import _shift_clamp
from tpuflow.ops.interp import warp_planes_shift

EPSILON = 0.001     # reference src/brox_optic_flow_spatial.cpp:23
MAXITER_SOR = 300   # :24
SOR_OMEGA = 1.9     # :25

# CLI defaults, reference src/brox_spatial_main.cpp:26-36 (2013 v2)
DEFAULT_ALPHA = 50.0
DEFAULT_GAMMA = 10.0
DEFAULT_NSCALES = 10
DEFAULT_ZFACTOR = 0.5
DEFAULT_TOL = 1e-4
DEFAULT_INNER = 1
DEFAULT_OUTER = 15


def psi_divergence(psi):
    """Half-sum divergence coefficients psi1..psi4 of the robustness
    weight, zeroed across the image boundary (reference
    src/brox_spatial_mask.cpp:16-93: psi1 down, psi2 up, psi3 right,
    psi4 left)."""
    psi1 = (0.5 * (_shift_clamp(psi, 1, -2) + psi)).at[..., -1, :].set(0.0)
    psi2 = (0.5 * (_shift_clamp(psi, -1, -2) + psi)).at[..., 0, :].set(0.0)
    psi3 = (0.5 * (_shift_clamp(psi, 1, -1) + psi)).at[..., :, -1].set(0.0)
    psi4 = (0.5 * (_shift_clamp(psi, -1, -1) + psi)).at[..., :, 0].set(0.0)
    return psi1, psi2, psi3, psi4


def psi_weighted_divergence(f, psi1, psi2, psi3, psi4):
    """sum_i psi_i * (f[neighbor_i] - f): the psi-weighted graph
    Laplacian (reference src/brox_spatial_mask.cpp:100-171).  The psi_i
    are already zero across the boundary, so clamped neighbor shifts
    reproduce the reference's boundary cases exactly."""
    return (psi1 * (_shift_clamp(f, 1, -2) - f)
            + psi2 * (_shift_clamp(f, -1, -2) - f)
            + psi3 * (_shift_clamp(f, 1, -1) - f)
            + psi4 * (_shift_clamp(f, -1, -1) - f))


def _red_black(shape):
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    par = (ii + jj) % 2
    return par == 0, par == 1


def _sor_sweep(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors):
    """One red-black SOR sweep on the coupled (du, dv) system
    (reference sor_iteration, src/brox_optic_flow_spatial.cpp:129-172);
    returns (du, dv, sum of squared updates)."""
    psi1, psi2, psi3, psi4 = psis
    w = SOR_OMEGA
    err = jnp.zeros((), dtype=du.dtype)
    for mask in colors:
        div_du = (psi1 * _shift_clamp(du, 1, -2) + psi2 * _shift_clamp(du, -1, -2)
                  + psi3 * _shift_clamp(du, 1, -1) + psi4 * _shift_clamp(du, -1, -1))
        du_cand = (1.0 - w) * du + w * (Au - D * dv + alpha * div_du) / Du
        du_new = jnp.where(mask, du_cand, du)
        div_dv = (psi1 * _shift_clamp(dv, 1, -2) + psi2 * _shift_clamp(dv, -1, -2)
                  + psi3 * _shift_clamp(dv, 1, -1) + psi4 * _shift_clamp(dv, -1, -1))
        dv_cand = (1.0 - w) * dv + w * (Av - D * du_new + alpha * div_dv) / Dv
        dv_new = jnp.where(mask, dv_cand, dv)
        err = err + jnp.sum((du_new - du) ** 2 + (dv_new - dv) ** 2)
        du, dv = du_new, dv_new
    return du, dv, err


def _sor_solve(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors, tol, size,
               stop, maxiter=MAXITER_SOR):
    """Run SOR sweeps with the reference stopping rule
    `sqrt(err/size) > TOL && nsor < 300`
    (src/brox_optic_flow_spatial.cpp:315-389).  Returns
    (du, dv, nsor, err) — the sweep count and final error are the
    scalars the reference prints when verbose (`Iterations: nsor`,
    :392-394; robust_expo also prints the error,
    src/robust_expo_methods.cpp:402-404)."""
    dtype = du.dtype
    if stop == "error":
        def cond(c):
            return (c[2] > tol) & (c[3] < maxiter)

        def body(c):
            du, dv, _, n = c
            du, dv, err = _sor_sweep(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors)
            return du, dv, jnp.sqrt(err / size), n + 1

        init = (du, dv, jnp.asarray(1000.0, dtype), jnp.asarray(0, jnp.int32))
        du, dv, err, nsor = jax.lax.while_loop(cond, body, init)
    else:
        def body(_, c):
            du, dv, _ = c
            du, dv, err = _sor_sweep(du, dv, Au, Av, Du, Dv, D, alpha, psis, colors)
            return du, dv, jnp.sqrt(err / size)

        du, dv, err = jax.lax.fori_loop(
            0, maxiter, body, (du, dv, jnp.asarray(1000.0, dtype)))
        nsor = jnp.asarray(maxiter, jnp.int32)
    return du, dv, nsor, err


def brox_scale(I1, I2, u, v, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
               tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
               outer_iter=DEFAULT_OUTER, stop="error",
               maxiter=MAXITER_SOR, with_diag=False, warp_mode="exact",
               dmax=8):
    """Single-scale Brox spatial flow (reference brox_optic_flow,
    src/brox_optic_flow_spatial.cpp:179-444).

    `with_diag=True` additionally returns {"iterations": (outer, inner)
    int32} — the SOR sweep counts the reference prints when verbose
    (src/brox_optic_flow_spatial.cpp:392-394)."""
    dtype = I1.dtype
    size = I1.size
    eps2 = EPSILON * EPSILON
    colors = _red_black(I1.shape)

    I1x, I1y = centered_gradient(I1)
    I2x, I2y = centered_gradient(I2)
    planes = jnp.stack([I2, I2x, I2y, dxx(I2), dxy(I2), dyy(I2)])

    def outer_body(uv, _):
        u, v = uv
        if warp_mode == "fast":
            warped = warp_planes_shift(planes, u, v, dmax)
        else:
            warped = warp_planes(planes, u, v, border_out=True)
        I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = warped

        ux, uy = centered_gradient(u)
        vx, vy = centered_gradient(v)
        psis_s = 1.0 / jnp.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + eps2)
        psi1, psi2, psi3, psi4 = psi_divergence(psis_s)
        div_u = psi_weighted_divergence(u, psi1, psi2, psi3, psi4)
        div_v = psi_weighted_divergence(v, psi1, psi2, psi3, psi4)
        div_d = alpha * (psi1 + psi2 + psi3 + psi4)

        du = jnp.zeros_like(u)
        dv = jnp.zeros_like(v)

        def inner_body(dudv, _):
            du, dv = dudv
            dI = I2w - I1 + I2wx * du + I2wy * dv
            psid = 1.0 / jnp.sqrt(dI * dI + eps2)
            dIx = I2wx - I1x + I2wxx * du + I2wxy * dv
            dIy = I2wy - I1y + I2wxy * du + I2wyy * dv
            psig = 1.0 / jnp.sqrt(dIx * dIx + dIy * dIy + eps2)

            g = gamma * psig
            dif = I2w - I1
            dx = I2wx - I1x
            dy = I2wy - I1y
            Au = -psid * dif * I2wx - g * (dx * I2wxx + dy * I2wxy) + alpha * div_u
            Av = -psid * dif * I2wy - g * (dx * I2wxy + dy * I2wyy) + alpha * div_v
            Du = psid * I2wx * I2wx + g * (I2wxx * I2wxx + I2wxy * I2wxy) + div_d
            Dv = psid * I2wy * I2wy + g * (I2wyy * I2wyy + I2wxy * I2wxy) + div_d
            D = psid * I2wy * I2wx + g * (I2wxx + I2wyy) * I2wxy

            du, dv, nsor, _err = _sor_solve(du, dv, Au, Av, Du, Dv, D, alpha,
                                            (psi1, psi2, psi3, psi4), colors,
                                            tol, size, stop, maxiter)
            return (du, dv), nsor

        (du, dv), nsors = jax.lax.scan(inner_body, (du, dv), None,
                                       length=inner_iter)
        return (u + du, v + dv), nsors

    (u, v), nsors = jax.lax.scan(outer_body, (u, v), None,
                                 length=outer_iter)
    if with_diag:
        return u, v, {"iterations": nsors}
    return u, v


@partial(jax.jit, static_argnames=("alpha", "gamma", "tol", "inner_iter",
                                   "outer_iter", "stop", "maxiter",
                                   "with_diag", "warp_mode", "dmax"))
def _brox_scale_jit(I1, I2, u, v, alpha, gamma, tol, inner_iter, outer_iter,
                    stop, maxiter, with_diag=False, warp_mode="exact",
                    dmax=8):
    return brox_scale(I1, I2, u, v, alpha, gamma, tol, inner_iter,
                      outer_iter, stop, maxiter, with_diag=with_diag,
                      warp_mode=warp_mode, dmax=dmax)


def brox_spatial(I1, I2, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                 nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                 tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                 outer_iter=DEFAULT_OUTER, stop="error",
                 maxiter=MAXITER_SOR, clamp_scales=True, verbose=False,
                 with_diag=False, warp_mode="exact", max_motion=8,
                 _whole=True):
    """Multiscale Brox spatial flow (reference brox_optic_flow_spatial,
    src/brox_optic_flow_spatial.cpp:451-549).

    The plain (non-verbose, non-diag) call runs the WHOLE pyramid as
    one jitted program, with no host round-trip between levels; the
    per-level host loop (`_whole=False`) computes the same result and
    serves the verbose and diagnostic outputs.  `warp_mode`/`max_motion`
    as in `tpuflow.models.tvl1.tvl1_multiscale`.

    `verbose` prints the reference binary's stdout lines: `Scale: %d`
    per level (src/brox_optic_flow_spatial.cpp:517-519) and
    `Iterations: %d` per outer*inner iteration (:392-394).
    `with_diag=True` returns (u, v, diags) with diags[s] =
    {"iterations": (outer, inner) int32} per scale, finest first."""
    import math
    import sys

    from tpuflow.ops import clamp_nscales

    if _whole and not verbose and not with_diag:
        return _brox_spatial_whole(I1, I2, alpha, gamma, nscales, zfactor,
                                   tol, inner_iter, outer_iter, stop,
                                   maxiter, clamp_scales, warp_mode,
                                   max_motion)
    ny, nx = I1.shape[-2:]
    if clamp_scales:
        # reference main clamps on min(nx, ny) >= 16
        # (src/brox_spatial_main.cpp:151-157)
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(images, u, v, scale=None):
        lvl1, lvl2 = images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = _brox_scale_jit(lvl1, lvl2, u, v, alpha, gamma, tol,
                              inner_iter, outer_iter, stop, maxiter,
                              with_diag=diag, warp_mode=warp_mode,
                              dmax=dmax)
        if diag:
            u, v, d = out
            diags[scale] = d
            if verbose:
                print(f"Scale: {scale}", file=sys.stdout)
                for o in range(outer_iter):
                    for i in range(inner_iter):
                        print(f"Iterations: {int(d['iterations'][o, i])}",
                              file=sys.stdout)
            return u, v
        return out

    u, v, _ = run_pyramid((I1, I2), nscales, zfactor, solve)
    if with_diag:
        return u, v, diags
    return u, v


@partial(jax.jit, static_argnames=("alpha", "gamma", "nscales", "zfactor",
                                   "tol", "inner_iter", "outer_iter",
                                   "stop", "maxiter", "clamp_scales",
                                   "warp_mode", "max_motion"))
def _brox_spatial_whole(I1, I2, alpha, gamma, nscales, zfactor, tol,
                        inner_iter, outer_iter, stop, maxiter,
                        clamp_scales, warp_mode, max_motion):
    """The whole coarse-to-fine solve as ONE device program (the
    throughput configuration tvl1/hs batched engines already use)."""
    return brox_spatial(I1, I2, alpha=alpha, gamma=gamma, nscales=nscales,
                        zfactor=zfactor, tol=tol, inner_iter=inner_iter,
                        outer_iter=outer_iter, stop=stop, maxiter=maxiter,
                        clamp_scales=clamp_scales, warp_mode=warp_mode,
                        max_motion=max_motion, _whole=False)
