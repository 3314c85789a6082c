"""Brox et al. 2004 robust optical flow with SPATIO-TEMPORAL smoothness
over a frame sequence.

Reference: src/brox_optic_flow_temporal.cpp + src/brox_temporal_mask.cpp.
Given `frames` input images there are nz = frames-1 flow fields, one per
consecutive pair, coupled by two temporal psi-terms to the neighboring
fields (psi5 previous frame, psi6 next frame;
src/brox_temporal_mask.cpp:108-133).  Structure per scale
(brox_optic_flow, src/brox_optic_flow_temporal.cpp:282-513):

  outer loop: warp each frame f+1 (and 5 derivative planes) by flow f
    (:357-364); 3D flow gradient via centered_gradient3 (:367-368);
    psi_smooth includes the temporal derivative (:94-113);
    6 divergence coefficients (4 spatial, zeroed across the image
    border + 2 temporal, zeroed at the first/last field);
    inner loop: psi_data/psi_gradient + Au/Av/Du/Dv/D (identical
    pointwise math to Brox spatial, :397-423);
    SOR sweeps over the whole (field, y, x) volume until
    sqrt(err/size1) <= TOL or 300 sweeps (:429-457).

Design: the flow volume is a (T-1, H, W) array; all stencils are
clamped shifts along the last three axes.  The SOR sweep uses 3D
red-black ordering — parity (f + i + j) % 2 — under which every one of
the 6 stencil neighbors (4 spatial + 2 temporal) has the opposite
color, giving a true multicolor Gauss-Seidel at omega = 1.9.  The
reference instead sweeps frames sequentially (interior frames, then
first, then last; :434-454); both orderings converge to the same fixed
point of each inner linear system.

This is the framework's sequence-axis method: the temporal coupling is
nearest-neighbor only, so under frame-axis sharding each SOR sweep
needs a 1-field halo exchange (a ring of `ppermute`s between devices)
— see tpuflow/parallel.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.models.brox_spatial import (
    EPSILON,
    MAXITER_SOR,
    SOR_OMEGA,
    psi_divergence,
    psi_weighted_divergence,
)
from tpuflow.models.common import run_pyramid_state
from tpuflow.ops import (
    centered_gradient,
    centered_gradient3,
    clamp_nscales,
    dxx,
    dxy,
    dyy,
    gaussian,
    warp_planes,
)
from tpuflow.ops.gradients import _shift_clamp
from tpuflow.ops.interp import warp_planes_shift

# CLI defaults, reference src/brox_temporal_main.cpp:19-27 (v1 2012
# defaults: alpha=18 gamma=7)
DEFAULT_ALPHA = 18.0
DEFAULT_GAMMA = 7.0
DEFAULT_NSCALES = 100
DEFAULT_ZFACTOR = 0.75
DEFAULT_TOL = 1e-4
DEFAULT_INNER = 1
DEFAULT_OUTER = 15
PRESMOOTH_SIGMA = 0.8  # src/brox_optic_flow_temporal.cpp:26


def temporal_psi_divergence(psis):
    """psi5/psi6 temporal half-sum coefficients, zeroed at the first and
    last flow field (src/brox_temporal_mask.cpp:108-133)."""
    psi5 = (0.5 * (_shift_clamp(psis, -1, 0) + psis)).at[0].set(0.0)
    psi6 = (0.5 * (_shift_clamp(psis, 1, 0) + psis)).at[-1].set(0.0)
    return psi5, psi6


def _red_black_3d(shape):
    ff = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    par = (ff + ii + jj) % 2
    return par == 0, par == 1


def _div6(f, psi1, psi2, psi3, psi4, psi5, psi6):
    """6-neighbor psi-weighted sum over (field, y, x); the psi_i vanish
    across every boundary so clamped shifts are exact."""
    return (psi1 * _shift_clamp(f, 1, -2) + psi2 * _shift_clamp(f, -1, -2)
            + psi3 * _shift_clamp(f, 1, -1) + psi4 * _shift_clamp(f, -1, -1)
            + psi5 * _shift_clamp(f, -1, 0) + psi6 * _shift_clamp(f, 1, 0))


def brox_temporal_scale(I, u, v, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                        tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                        outer_iter=DEFAULT_OUTER, stop="error",
                        maxiter=MAXITER_SOR, with_diag=False,
                        warp_mode="exact", dmax=8):
    """Single-scale spatio-temporal Brox flow.

    I: (T, H, W) frame volume; u, v: (T-1, H, W) flow fields.
    Reference brox_optic_flow, src/brox_optic_flow_temporal.cpp:282-513.

    The reference warps 6 planes per frame pair per outer iteration
    (src/brox_optic_flow_temporal.cpp:357-364); "exact" (default) does
    so with the per-pixel bicubic gather, `warp_mode="fast"` with the
    displacement-bounded shift warp (`warp_planes_shift`, bound `dmax`),
    vmapped over the frame axis.

    `with_diag=True` additionally returns {"iterations": (outer, inner)
    int32} — the SOR sweep counts the reference prints when verbose
    (src/brox_optic_flow_temporal.cpp:459-461)."""
    frames, ny, nx = I.shape
    nz = frames - 1
    size1 = nz * ny * nx
    eps2 = EPSILON * EPSILON
    w = SOR_OMEGA
    colors = _red_black_3d((nz, ny, nx))

    Ix, Iy = centered_gradient(I)
    I0, Ix0, Iy0 = I[:nz], Ix[:nz], Iy[:nz]
    # derivative planes of frames 1..T-1, warped by flow field f
    tail = I[1:]
    planes = jnp.stack([tail, Ix[1:], Iy[1:], dxx(tail), dxy(tail), dyy(tail)])

    def _warp6(p, uu, vv):
        # one field's 6 planes; vmapped over the field axis below
        if warp_mode == "fast":
            return warp_planes_shift(p, uu, vv, dmax)
        return warp_planes(p, uu, vv, border_out=True)

    def outer_body(uv, _):
        u, v = uv
        # warp the 6 derivative planes of frame f+1 by flow f
        warped = jax.vmap(_warp6, in_axes=(1, 0, 0))(planes, u, v)
        Iw, Iwx, Iwy, Iwxx, Iwxy, Iwyy = jnp.moveaxis(warped, 1, 0)

        ux, uy, ut = centered_gradient3(u)
        vx, vy, vt = centered_gradient3(v)
        psis = 1.0 / jnp.sqrt(ux * ux + uy * uy + ut * ut
                              + vx * vx + vy * vy + vt * vt + eps2)
        psi1, psi2, psi3, psi4 = psi_divergence(psis)
        psi5, psi6 = temporal_psi_divergence(psis)
        div_u = (psi_weighted_divergence(u, psi1, psi2, psi3, psi4)
                 + psi5 * (_shift_clamp(u, -1, 0) - u)
                 + psi6 * (_shift_clamp(u, 1, 0) - u))
        div_v = (psi_weighted_divergence(v, psi1, psi2, psi3, psi4)
                 + psi5 * (_shift_clamp(v, -1, 0) - v)
                 + psi6 * (_shift_clamp(v, 1, 0) - v))
        div_d = alpha * (psi1 + psi2 + psi3 + psi4 + psi5 + psi6)

        du = jnp.zeros_like(u)
        dv = jnp.zeros_like(v)

        def inner_body(dudv, _):
            du, dv = dudv
            dI = Iw - I0 + Iwx * du + Iwy * dv
            psid = 1.0 / jnp.sqrt(dI * dI + eps2)
            dIx = Iwx - Ix0 + Iwxx * du + Iwxy * dv
            dIy = Iwy - Iy0 + Iwxy * du + Iwyy * dv
            psig = 1.0 / jnp.sqrt(dIx * dIx + dIy * dIy + eps2)

            g = gamma * psig
            dif = Iw - I0
            dx = Iwx - Ix0
            dy = Iwy - Iy0
            Au = -psid * dif * Iwx - g * (dx * Iwxx + dy * Iwxy) + alpha * div_u
            Av = -psid * dif * Iwy - g * (dx * Iwxy + dy * Iwyy) + alpha * div_v
            Du = psid * Iwx * Iwx + g * (Iwxx * Iwxx + Iwxy * Iwxy) + div_d
            Dv = psid * Iwy * Iwy + g * (Iwyy * Iwyy + Iwxy * Iwxy) + div_d
            D = psid * Iwy * Iwx + g * (Iwxx + Iwyy) * Iwxy

            def sweep(du, dv):
                err = jnp.zeros((), dtype=du.dtype)
                for mask in colors:
                    div_du = _div6(du, psi1, psi2, psi3, psi4, psi5, psi6)
                    du_c = (1.0 - w) * du + w * (Au - D * dv + alpha * div_du) / Du
                    du_n = jnp.where(mask, du_c, du)
                    div_dv = _div6(dv, psi1, psi2, psi3, psi4, psi5, psi6)
                    dv_c = (1.0 - w) * dv + w * (Av - D * du_n + alpha * div_dv) / Dv
                    dv_n = jnp.where(mask, dv_c, dv)
                    err = err + jnp.sum((du_n - du) ** 2 + (dv_n - dv) ** 2)
                    du, dv = du_n, dv_n
                return du, dv, err

            if stop == "error":
                def cond(c):
                    return (c[2] > tol) & (c[3] < maxiter)

                def body(c):
                    du, dv, _, n = c
                    du, dv, err = sweep(du, dv)
                    return du, dv, jnp.sqrt(err / size1), n + 1

                init = (du, dv, jnp.asarray(1000.0, du.dtype),
                        jnp.asarray(0, jnp.int32))
                du, dv, _, nsor = jax.lax.while_loop(cond, body, init)
            else:
                def body(_, c):
                    du, dv = c
                    du, dv, _ = sweep(du, dv)
                    return du, dv

                du, dv = jax.lax.fori_loop(0, maxiter, body, (du, dv))
                nsor = jnp.asarray(maxiter, jnp.int32)
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
def _brox_temporal_scale_jit(I, u, v, alpha, gamma, tol, inner_iter,
                             outer_iter, stop, maxiter, with_diag=False,
                             warp_mode="exact", dmax=8):
    return brox_temporal_scale(I, u, v, alpha, gamma, tol, inner_iter,
                               outer_iter, stop, maxiter, with_diag=with_diag,
                               warp_mode=warp_mode, dmax=dmax)


def brox_temporal(I, alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                  nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                  tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                  outer_iter=DEFAULT_OUTER, stop="error",
                  maxiter=MAXITER_SOR, clamp_scales=True,
                  level_callback=None, resume=None, verbose=False,
                  with_diag=False, warp_mode="exact", max_motion=8,
                  _whole=True):
    """Multiscale spatio-temporal Brox flow (reference
    brox_optic_flow_temporal, src/brox_optic_flow_temporal.cpp:520-626).

    I: (T, H, W) with T >= 3; returns (T-1, H, W) u and v.

    `level_callback` / `resume` are the shared run_pyramid_state
    checkpoint hooks (state keys u1/u2, each (T-1, h, w)).

    The plain call (no hooks, verbose or diagnostics) runs the whole
    pyramid as one jitted program.  `warp_mode`/`max_motion` as in
    `tpuflow.models.tvl1.tvl1_multiscale`.

    `verbose` prints the reference's stdout lines: `Scale: %d` per level
    (src/brox_optic_flow_temporal.cpp:592-594) and `Iterations: %d` per
    outer*inner iteration (:459-461).  `with_diag=True` returns
    (u, v, diags), diags[s] = {"iterations": (outer, inner)}."""
    import math
    import sys

    frames, ny, nx = I.shape
    if frames <= 2:
        raise ValueError("The method needs more than two frames "
                         "(src/brox_optic_flow_temporal.cpp:537)")
    if (_whole and not verbose and not with_diag and level_callback is None
            and resume is None):
        return _brox_temporal_whole(I, alpha, gamma, nscales, zfactor, tol,
                                    inner_iter, outer_iter, stop, maxiter,
                                    clamp_scales, warp_mode, max_motion)
    if clamp_scales:
        # reference main clamps on min(nx, ny) >= 16
        # (src/brox_temporal_main.cpp:141-147)
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    def preprocess(images):
        # global [0,255] normalization over the whole volume
        # (image_normalization_1, src/utils.cpp:251-276) — NOT the
        # per-leading-index normalize_joint
        (vol,) = images
        mn, mx = jnp.min(vol), jnp.max(vol)
        den = mx - mn
        von = jnp.where(den > 0,
                        255.0 * (vol - mn) / jnp.where(den > 0, den, 1.0),
                        vol)
        return (gaussian(von, PRESMOOTH_SIGMA),)

    def state_init(size, dtype):
        cnx, cny = size
        z = jnp.zeros((frames - 1, cny, cnx), dtype=dtype)
        return {"u1": z, "u2": z}

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(level_images, state, scale):
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = _brox_temporal_scale_jit(level_images[0], state["u1"],
                                       state["u2"], alpha, gamma, tol,
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
        else:
            u, v = out
        return {"u1": u, "u2": v}

    state = run_pyramid_state(
        (I,), nscales, zfactor, solve,
        presmooth=None, preprocess=preprocess, state_init=state_init,
        level_callback=level_callback, resume=resume,
        trace_name="brox_temporal")
    if with_diag:
        return state["u1"], state["u2"], diags
    return state["u1"], state["u2"]


@partial(jax.jit, static_argnames=("alpha", "gamma", "nscales", "zfactor",
                                   "tol", "inner_iter", "outer_iter",
                                   "stop", "maxiter", "clamp_scales",
                                   "warp_mode", "max_motion"))
def _brox_temporal_whole(I, alpha, gamma, nscales, zfactor, tol, inner_iter,
                         outer_iter, stop, maxiter, clamp_scales, warp_mode,
                         max_motion):
    """The whole coarse-to-fine solve as ONE device program."""
    return brox_temporal(I, alpha=alpha, gamma=gamma, nscales=nscales,
                         zfactor=zfactor, tol=tol, inner_iter=inner_iter,
                         outer_iter=outer_iter, stop=stop, maxiter=maxiter,
                         clamp_scales=clamp_scales, warp_mode=warp_mode,
                         max_motion=max_motion, _whole=False)
