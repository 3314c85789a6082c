"""Joint TV-L1 optical flow + occlusion estimation (Ballester, Garrido,
Lazcano, Caselles 2012; Garamendi's IPOL implementation).

Reference: src/tvl1occflow.cpp, src/tvl1occflow_solvers.cpp,
src/tvl1occflow_constants.h.  Uses THREE frames (I-1, I0, I1) plus a
smoothed copy of I0 for the edge indicator
g = 1/(1 + 0.05*|grad filtI0|) (choosed_g, src/tvl1occflow.cpp:102-136;
G_CHOICE=2, G_FACTOR=0.05).  Per warp (src/tvl1occflow.cpp:217-297):

  warp I1 forward by +u and I-1 backward by -u (6 bicubic warps,
  border_out = false), then alternate until the L2 flow change drops
  below epsilon or 20 iterations (EXT_MAX_ITERATIONS):

  1. Solver_wrt_v — closed-form thresholding with separate
     non-occluded (forward rho1) and occluded (backward rho3) branches,
     selected per pixel by chi >= 0.75 (tvl1occflow_solvers.cpp:55-147)
  2. Solver_wrt_u — two scalar ROF problems solved by the staggered
     box scheme (tpuflow.models.tvl1occ_rof), 10 sweeps each, dual
     state carried across iterations/warps within a scale (the
     reference keeps it in function-static buffers, solvers.cpp:164);
     followed by 3x3 median filtering of u (tvl1occflow.cpp:280-281)
  3. Solver_wrt_chi — 100 primal-dual iterations on the occlusion map
     with g-weighted TV; eta projected onto the unit ball, chi clamped
     to [0,1] (solvers.cpp:217-337).  The reference's eta buffers are
     used UNINITIALIZED on first call (#warning at solvers.cpp:262);
     we initialize them to zero per scale — the behavior of a fresh
     allocation — and carry them across calls like the reference.

Multiscale driver (src/tvl1occflow.cpp:335-481): NOTE the reference
computes image_normalization_4 and then immediately OVERWRITES the
normalized buffers with the raw inputs (:383-397), so normalization is
effectively disabled; we replicate (no normalization).  Presmooth
sigma = 0.8, pyramid via zoom_out, flow upscaled by 1/zfactor, chi
upsampled WITHOUT rescale, chi thresholded at 0.75 only at the finest
scale (:458-460).
"""

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.models.common import run_pyramid_state, upsample_flow
from tpuflow.models.tvl1occ_rof import rof_box_cell_centered
from tpuflow.ops import (
    centered_gradient,
    clamp_nscales,
    divergence,
    forward_gradient,
    median_filter,
    warp_planes,
    zoom_in,
)
from tpuflow.ops.interp import warp_planes_shift

# src/tvl1occflow_constants.h
DEFAULT_LAMBDA = 0.15
DEFAULT_ALPHA = 0.01
DEFAULT_BETA = 0.15
DEFAULT_THETA = 0.3
DEFAULT_NSCALES = 100
DEFAULT_ZFACTOR = 0.5
DEFAULT_WARPS = 2
DEFAULT_EPSILON = 0.01
EXT_MAX_ITERATIONS = 20
OMEGA = 1.25
IS_ZERO = 1e-10
THR_CHI = 0.75
MAX_ITERATIONS_CHI = 100
MAX_ITERATIONS_U = 10
PRESMOOTHING_SIGMA = 0.8
G_FACTOR = 0.05
TAU_ETA = 0.15
TAU_CHI = 0.15


def edge_indicator(filt_i0):
    """g = 1/(1 + G_FACTOR*|grad filtI0|) (choosed_g with G_CHOICE=2,
    src/tvl1occflow.cpp:122-132)."""
    ix, iy = centered_gradient(filt_i0)
    return 1.0 / (1.0 + G_FACTOR * jnp.sqrt(ix * ix + iy * iy))


def solver_wrt_v(u1, u2, chi, I1wx, I1wy, Im1wx, Im1wy, rho1_c, rho3_c,
                 grad1, grad3, alpha, theta, lam):
    """Closed-form minimization wrt the auxiliary variable v
    (Solver_wrt_v, src/tvl1occflow_solvers.cpp:55-147).  Returns
    (v1, v2, vfwd1, vfwd2, vbck1, vbck2)."""
    l_t = lam * theta
    one_pat = 1.0 + alpha * theta
    at_d = alpha * theta / one_pat
    lt_d = 2.0 * lam * theta / one_pat

    # forward (non-occluded) branch: standard TV-L1 thresholding
    rho1 = rho1_c + I1wx * u1 + I1wy * u2
    d1 = jnp.where(
        rho1 < -l_t * grad1, l_t * I1wx,
        jnp.where(rho1 > l_t * grad1, -l_t * I1wx,
                  jnp.where(grad1 < IS_ZERO, 0.0,
                            -rho1 * I1wx / jnp.where(grad1 < IS_ZERO, 1.0, grad1))))
    d2 = jnp.where(
        rho1 < -l_t * grad1, l_t * I1wy,
        jnp.where(rho1 > l_t * grad1, -l_t * I1wy,
                  jnp.where(grad1 < IS_ZERO, 0.0,
                            -rho1 * I1wy / jnp.where(grad1 < IS_ZERO, 1.0, grad1))))
    vfwd1 = u1 + d1
    vfwd2 = u2 + d2

    # backward (occluded) branch against I_{-1}
    rho3 = rho3_c - (Im1wx * u1 + Im1wy * u2)
    A = rho3 + at_d * (Im1wx * u1 + Im1wy * u2)
    lo = A < -lt_d * grad3
    hi = A > lt_d * grad3
    mid_zero = grad3 < IS_ZERO
    safe3 = jnp.where(mid_zero, 1.0, grad3)
    b1 = jnp.where(lo, -lt_d * Im1wx,
                   jnp.where(hi, lt_d * Im1wx,
                             jnp.where(mid_zero, 0.0, rho3 * Im1wx / safe3)))
    b2 = jnp.where(lo, -lt_d * Im1wy,
                   jnp.where(hi, lt_d * Im1wy,
                             jnp.where(mid_zero, 0.0, rho3 * Im1wy / safe3)))
    # saturated branches start from u/(1+alpha*theta), the middle branch
    # from u (solvers.cpp:114-136)
    base1 = jnp.where(lo | hi, u1 / one_pat, u1)
    base2 = jnp.where(lo | hi, u2 / one_pat, u2)
    vbck1 = base1 + b1
    vbck2 = base2 + b2

    occluded = chi >= THR_CHI
    v1 = jnp.where(occluded, vbck1, vfwd1)
    v2 = jnp.where(occluded, vbck2, vfwd2)
    return v1, v2, vfwd1, vfwd2, vbck1, vbck2


def solver_wrt_u(v1, v2, chi, g, theta, beta, p11, p12, p21, p22):
    """Minimization wrt the flow u: two modified-ROF problems via the
    staggered box scheme (Solver_wrt_u, src/tvl1occflow_solvers.cpp
    :149-215).  Returns (u1, u2, p11, p12, p21, p22)."""
    chix, chiy = forward_gradient(chi)
    f1 = v1 / theta + beta * chix
    f2 = v2 / theta + beta * chiy
    u1 = v1 + theta * beta * chix
    u2 = v2 + theta * beta * chiy
    u1, p11, p12 = rof_box_cell_centered(u1, f1, p11, p12, g, theta,
                                         OMEGA, MAX_ITERATIONS_U)
    u2, p21, p22 = rof_box_cell_centered(u2, f2, p21, p22, g, theta,
                                         OMEGA, MAX_ITERATIONS_U)
    return u1, u2, p11, p12, p21, p22


def solver_wrt_chi(u1, u2, chi, I1wx, I1wy, Im1wx, Im1wy, rho1_c, rho3_c,
                   vfwd1, vfwd2, vbck1, vbck2, g, lam, theta, alpha, beta,
                   eta1, eta2):
    """100 primal-dual iterations on the occlusion map chi
    (Solver_wrt_chi, src/tvl1occflow_solvers.cpp:217-337)."""
    rho1 = rho1_c + I1wx * vfwd1 + I1wy * vfwd2
    rho3 = rho3_c - (Im1wx * vbck1 + Im1wy * vbck2)
    abs_rho1 = jnp.abs(rho1)
    abs_rho3 = jnp.abs(rho3)
    div_u = divergence(u1, u2)

    def body(_, carry):
        chi, eta1, eta2 = carry
        chix, chiy = forward_gradient(chi)
        eta1 = eta1 + TAU_ETA * g * chix
        eta2 = eta2 + TAU_ETA * g * chiy
        norm2 = eta1 * eta1 + eta2 * eta2
        small = norm2 < IS_ZERO
        norm = jnp.sqrt(jnp.where(small, 1.0, norm2))
        eta1 = jnp.where(small, 0.0, eta1 / norm)
        eta2 = jnp.where(small, 0.0, eta2 / norm)

        div_eta = divergence(g * eta1, g * eta2)
        non_occ = chi < 0.5
        F = jnp.where(non_occ, -lam * abs_rho1, lam * abs_rho3)
        G = jnp.where(
            non_occ,
            -(0.5 / theta) * ((vfwd1 - u1) ** 2 + (vfwd2 - u2) ** 2),
            (0.5 / theta) * ((vbck1 - u1) ** 2 + (vbck2 - u2) ** 2)
            + alpha * theta * (vbck1 * vbck1 + vbck2 * vbck2))
        chi = jnp.clip(chi + TAU_CHI * (div_eta - F - G - beta * div_u),
                       0.0, 1.0)
        return chi, eta1, eta2

    return jax.lax.fori_loop(0, MAX_ITERATIONS_CHI, body, (chi, eta1, eta2))


def tvl1occ_scale(Im1, I0, I1, filt_i0, u1, u2, chi, lam=DEFAULT_LAMBDA,
                  alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA, theta=DEFAULT_THETA,
                  warps=DEFAULT_WARPS, epsilon=DEFAULT_EPSILON, stop="error",
                  max_iterations=EXT_MAX_ITERATIONS, with_diag=False,
                  warp_mode="exact", dmax=8):
    """Single-scale joint flow + occlusion solver (Dual_TVL1_optic_flow,
    src/tvl1occflow.cpp:143-328).

    `with_diag=True` additionally returns {"iterations": (warps,) int32,
    "error": (warps,)} — the per-warp stopping scalars the reference
    prints to stderr when verbose (src/tvl1occflow.cpp:292-296)."""
    dtype = I0.dtype
    size = I0.size
    g = edge_indicator(filt_i0)
    I1x, I1y = centered_gradient(I1)
    Im1x, Im1y = centered_gradient(Im1)
    fwd_planes = jnp.stack([I1, I1x, I1y])
    bck_planes = jnp.stack([Im1, Im1x, Im1y])

    zero = jnp.zeros_like(u1)
    # dual states carried across iterations AND warps within the scale
    # (function-static in the reference, solvers.cpp:164,243)
    state0 = dict(u1=u1, u2=u2, chi=chi, p11=zero, p12=zero, p21=zero,
                  p22=zero, eta1=zero, eta2=zero, u1prev=u1, u2prev=u2)

    def warp_body(st, _):
        if warp_mode == "fast":
            I1w, I1wx, I1wy = warp_planes_shift(
                fwd_planes, st["u1"], st["u2"], dmax, border_out=False)
            Im1w, Im1wx, Im1wy = warp_planes_shift(
                bck_planes, -st["u1"], -st["u2"], dmax, border_out=False)
        else:
            I1w, I1wx, I1wy = warp_planes(fwd_planes, st["u1"], st["u2"],
                                          border_out=False)
            Im1w, Im1wx, Im1wy = warp_planes(bck_planes, -st["u1"],
                                             -st["u2"], border_out=False)
        grad1 = I1wx * I1wx + I1wy * I1wy
        grad3 = Im1wx * Im1wx + Im1wy * Im1wy
        rho1_c = I1w - I1wx * st["u1"] - I1wy * st["u2"] - I0
        rho3_c = Im1w + Im1wx * st["u1"] + Im1wy * st["u2"] - I0

        def iteration(st):
            v1, v2, vf1, vf2, vb1, vb2 = solver_wrt_v(
                st["u1"], st["u2"], st["chi"], I1wx, I1wy, Im1wx, Im1wy,
                rho1_c, rho3_c, grad1, grad3, alpha, theta, lam)
            u1, u2, p11, p12, p21, p22 = solver_wrt_u(
                v1, v2, st["chi"], g, theta, beta,
                st["p11"], st["p12"], st["p21"], st["p22"])
            u1 = median_filter(u1, 3)
            u2 = median_filter(u2, 3)
            chi, eta1, eta2 = solver_wrt_chi(
                u1, u2, st["chi"], I1wx, I1wy, Im1wx, Im1wy, rho1_c, rho3_c,
                vf1, vf2, vb1, vb2, g, lam, theta, alpha, beta,
                st["eta1"], st["eta2"])
            err = jnp.sum((u1 - st["u1prev"]) ** 2
                          + (u2 - st["u2prev"]) ** 2) / size
            return dict(u1=u1, u2=u2, chi=chi, p11=p11, p12=p12, p21=p21,
                        p22=p22, eta1=eta1, eta2=eta2,
                        u1prev=u1, u2prev=u2), err

        if stop == "error":
            def cond(c):
                return (c[1] > epsilon) & (c[2] < max_iterations)

            def body(c):
                st, _, n = c
                st, err = iteration(st)
                return st, err, n + 1

            st, err, n = jax.lax.while_loop(
                cond, body, (st, jnp.asarray(jnp.inf, dtype),
                             jnp.asarray(0, jnp.int32)))
        else:
            def body(_, c):
                return iteration(c[0])

            st, err = jax.lax.fori_loop(
                0, max_iterations, body, (st, jnp.asarray(jnp.inf, dtype)))
            n = jnp.asarray(max_iterations, jnp.int32)
        return st, (n, err)

    st, (ns, errs) = jax.lax.scan(warp_body, state0, None, length=warps)
    if with_diag:
        return st["u1"], st["u2"], st["chi"], {"iterations": ns,
                                               "error": errs}
    return st["u1"], st["u2"], st["chi"]


@partial(jax.jit, static_argnames=("lam", "alpha", "beta", "theta", "warps",
                                   "epsilon", "stop", "max_iterations",
                                   "with_diag", "warp_mode", "dmax"))
def _tvl1occ_scale_jit(Im1, I0, I1, filt_i0, u1, u2, chi, lam, alpha, beta,
                       theta, warps, epsilon, stop, max_iterations,
                       with_diag=False, warp_mode="exact", dmax=8):
    return tvl1occ_scale(Im1, I0, I1, filt_i0, u1, u2, chi, lam, alpha,
                         beta, theta, warps, epsilon, stop, max_iterations,
                         with_diag=with_diag, warp_mode=warp_mode, dmax=dmax)


def tvl1occflow(Im1, I0, I1, filt_i0=None, lam=DEFAULT_LAMBDA,
                alpha=DEFAULT_ALPHA, beta=DEFAULT_BETA, theta=DEFAULT_THETA,
                nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                warps=DEFAULT_WARPS, epsilon=DEFAULT_EPSILON, stop="error",
                max_iterations=EXT_MAX_ITERATIONS, clamp_scales=True,
                level_callback=None, resume=None, verbose=False,
                with_diag=False, warp_mode="exact", max_motion=8,
                _whole=True):
    """Multiscale joint flow + occlusion estimation
    (Dual_TVL1_optic_flow_multiscale, src/tvl1occflow.cpp:335-481).

    Returns (u1, u2, chi) at the finest scale, chi already thresholded
    at 0.75 into {0, 1}.  `filt_i0` defaults to I0 (the reference CLI
    falls back to the source image when no smoothed version is given,
    src/tvl1occflow_main.cpp:100-110).

    `level_callback(scale, state)` / `resume=(scale, state)` are the
    shared run_pyramid_state checkpoint hooks; state carries u1/u2/chi.

    `verbose` replicates the reference's output: `verbose` on stdout
    once per scale (src/tvl1occflow.cpp:192-194) and per-warp
    `Warping: %d, Iterations: %d, Error: %e` on STDERR (:292-296).
    `with_diag=True` returns (u1, u2, chi, diags), diags[s] =
    {"iterations": (warps,), "error": (warps,)}, finest first.

    The plain call (no hooks, verbose or diagnostics) runs the whole
    pyramid as one jitted program.  `warp_mode="fast"` (the GSPMD lane,
    tpuflow.parallel.spatial) uses the bounded shift warp, whose
    border_out=False taps differ from the reference by a sub-pixel
    amount on the one-cell image rim (`warp_planes_shift`)."""
    import math
    import sys

    if filt_i0 is None:
        filt_i0 = I0
    if (_whole and not verbose and not with_diag and level_callback is None
            and resume is None):
        return _tvl1occflow_whole(Im1, I0, I1, filt_i0, lam, alpha, beta,
                                  theta, nscales, zfactor, warps, epsilon,
                                  stop, max_iterations, clamp_scales,
                                  warp_mode, max_motion)
    ny, nx = I0.shape[-2:]
    if clamp_scales:
        # reference main clamps on min(nx, ny) >= 16
        # (src/tvl1occflow_main.cpp:192-196)
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    def state_init(size, dtype):
        cnx, cny = size
        z = jnp.zeros((cny, cnx), dtype=dtype)
        return {"u1": z, "u2": z, "chi": z}

    def upsample(state, out_size, zfactor_):
        u1, u2 = upsample_flow(state["u1"], state["u2"], out_size, zfactor_)
        # chi upsampled WITHOUT magnitude rescale (src/tvl1occflow.cpp:470)
        return {"u1": u1, "u2": u2, "chi": zoom_in(state["chi"], out_size)}

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(level_images, state, scale):
        lm1, l0, l1, lf = level_images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = _tvl1occ_scale_jit(
            lm1, l0, l1, lf, state["u1"], state["u2"], state["chi"], lam,
            alpha, beta, theta, warps, epsilon, stop, max_iterations,
            with_diag=diag, warp_mode=warp_mode, dmax=dmax)
        if diag:
            u1, u2, chi, d = out
            diags[scale] = d
            if verbose:
                # the reference prints "verbose" at solver entry per
                # scale (src/tvl1occflow.cpp:192-194, stdout) and the
                # warp stats to stderr (:292-296)
                print("verbose", file=sys.stdout)
                for w in range(warps):
                    print(f"Warping: {w}, "
                          f"Iterations: {int(d['iterations'][w])}, "
                          f"Error: {float(d['error'][w]):e}",
                          file=sys.stderr)
        else:
            u1, u2, chi = out
        return {"u1": u1, "u2": u2, "chi": chi}

    # NO normalization: the reference overwrites the normalized buffers
    # with the raw images (src/tvl1occflow.cpp:383-397)
    state = run_pyramid_state(
        (Im1, I0, I1, filt_i0), nscales, zfactor, solve,
        presmooth=PRESMOOTHING_SIGMA, preprocess=None,
        state_init=state_init, upsample_state=upsample,
        level_callback=level_callback, resume=resume,
        trace_name="tvl1occflow")
    # chi thresholded at 0.75 only at the finest scale (:458-460)
    chi = (state["chi"] > THR_CHI).astype(I0.dtype)
    if with_diag:
        return state["u1"], state["u2"], chi, diags
    return state["u1"], state["u2"], chi


@partial(jax.jit, static_argnames=("lam", "alpha", "beta", "theta",
                                   "nscales", "zfactor", "warps",
                                   "epsilon", "stop", "max_iterations",
                                   "clamp_scales", "warp_mode",
                                   "max_motion"))
def _tvl1occflow_whole(Im1, I0, I1, filt_i0, lam, alpha, beta, theta,
                       nscales, zfactor, warps, epsilon, stop,
                       max_iterations, clamp_scales, warp_mode, max_motion):
    """The whole coarse-to-fine solve as ONE device program."""
    return tvl1occflow(Im1, I0, I1, filt_i0, lam=lam, alpha=alpha,
                       beta=beta, theta=theta, nscales=nscales,
                       zfactor=zfactor, warps=warps, epsilon=epsilon,
                       stop=stop, max_iterations=max_iterations,
                       clamp_scales=clamp_scales, warp_mode=warp_mode,
                       max_motion=max_motion, _whole=False)
