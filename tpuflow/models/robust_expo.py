"""Robust discontinuity-preserving TV methods with exponential
regularization (Monzón/Salgado/Sánchez, IEEE TIP 2016).

Reference: src/robust_expo_methods.cpp, src/robust_expo_smoothness.cpp,
src/robust_expo_generic_tensor.cpp.  Same skeleton as Brox spatial
(warp + lagged nonlinearity + SOR on the increment) with three changes:

  * multichannel (RGB) data/gradient psi terms are SUMMED over channels
    (src/robust_expo_methods.cpp:36-105, 273-318); images are (C, H, W)
    planes here (the reference is interleaved row-major);
  * the smoothness weight is modulated by a per-pixel EXPONENTIAL
    diffusivity computed ONCE per scale from image-1 gradients:
    expo = exp(-lambda * max_c |grad I1_c|) (+ beta), with
    method_type 1 = DF, 2 = DF-BETA (beta = 0.001), 3 = DF-AUTO
    (per-pixel lambda from the gradient histogram, xi = 0.05,
    tau = 0.94 percentile; src/robust_expo_smoothness.cpp:17-19,79-186);
    psi_smooth = expo / sqrt(expo*|grad w|^2 + eps^2) (:28-47);
  * alpha is scaled by the channel count before use and TRUNCATED TO
    INT, and the SOR error is normalized by nx*ny*nz
    (src/robust_expo_methods.cpp:527, :400).

The reference's psi1..psi4 labels are a permutation of Brox's
(1 = right, 2 = left, 3 = down, 4 = up;
src/robust_expo_generic_tensor.cpp:18-97) — the underlying graph
Laplacian is identical, so we reuse the Brox helpers.

Documented divergences from the reference (bugs we do NOT replicate,
all flagged in SURVEY.md §0):

  * presmoothing: the reference calls
    `gaussian(I1s[0], nxx, nyy, nzz, GAUSSIAN_SIGMA)` against signature
    `gaussian(I, xdim, ydim, sigma, bc, ...)`
    (src/robust_expo_methods.cpp:497-498 vs src/operators.h:128-134),
    i.e. sigma = nzz (the channel count!) and bc = (int)0.8 = 0
    (Dirichlet), applied to the first nx*ny values of the interleaved
    buffer.  `presmooth_mode="reference"` (default) replicates this
    exactly — it is deterministic, and for grayscale it is simply
    sigma = 1.0 with Dirichlet BC — so CLI outputs match the reference
    binary.  `presmooth_mode="clean"` applies the intended sigma = 0.8
    reflecting smooth per channel.
  * multichannel pyramid: reference zoom_out_color copies only nx*ny of
    the nx*ny*nz interleaved samples and then reads OUT OF BOUNDS when
    resampling (src/zoom.cpp:95-120) — undefined behavior, not
    reproducible.  We downsample each channel with the exact grayscale
    zoom_out.  (Grayscale runs are unaffected.)
  * multichannel Dxx/Dyy/Dxy edge handling reads cross-channel values
    (src/operators.cpp:189,228 use index+1 for index+nz); we compute
    the clean per-channel stencil, so RGB results differ slightly in
    the one-pixel image border.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.models.brox_spatial import (
    _red_black,
    _sor_solve,
    psi_divergence,
    psi_weighted_divergence,
)
from tpuflow.models.common import PRESMOOTHING_SIGMA, run_pyramid_state
from tpuflow.ops import (
    centered_gradient,
    clamp_nscales,
    dxx,
    dxy,
    dyy,
    gaussian,
    normalize_joint,
    warp_planes,
)
from tpuflow.ops.interp import warp_planes_shift

EPSILON = 0.001   # ROBUST_EXPO_EPSILON, src/robust_expo_smoothness.h:16
XI = 0.05         # src/robust_expo_smoothness.cpp:17
TAU = 0.94        # :18
BETA = 0.001      # :19
MAXITER_SOR = 300  # src/robust_expo_methods.cpp:24

# CLI defaults, src/robust_expo_methods_main.cpp PAR_DEFAULT_*
DEFAULT_METHOD = 1
DEFAULT_ALPHA = 50.0
DEFAULT_GAMMA = 10.0
DEFAULT_LAMBDA = 0.2
DEFAULT_NSCALES = 10
DEFAULT_ZFACTOR = 0.5
DEFAULT_TOL = 1e-4
DEFAULT_INNER = 1
DEFAULT_OUTER = 15


def exponential_diffusivity(I1x, I1y, method_type, alpha, lam):
    """Per-pixel diffusivity from image-1 gradients
    (robust_expo_exponential_calculation,
    src/robust_expo_smoothness.cpp:136-186).  I1x/I1y are (C, H, W);
    `alpha` is the channel-adapted integer alpha (used only by DF-AUTO).
    """
    maxgrad = jnp.max(jnp.sqrt(I1x * I1x + I1y * I1y), axis=0)
    if method_type in (1, 2):
        beta = BETA if method_type == 2 else 0.0
        return jnp.exp(-lam * maxgrad) + beta
    if method_type != 3:
        raise ValueError(f"method_type must be 1, 2 or 3, got {method_type}")
    # DF-AUTO: lambda_omega from the tau-percentile of the sorted
    # gradient histogram (lambda_optimum_using_maximum_gradient_per_pixel,
    # src/robust_expo_smoothness.cpp:79-130)
    size_flow = maxgrad.size
    c = -math.log(XI) + math.log(alpha)
    lambda_per_pixel = c / maxgrad
    sorted_g = jnp.sort(maxgrad.reshape(-1))
    pos_ref0 = int(TAU * size_flow)
    # the reference advances pos_ref while sorted[pos_ref-1] < c/2; the
    # first stopping index is searchsorted(c/2) + 1
    idx = jnp.searchsorted(sorted_g, jnp.asarray(c / 2.0, sorted_g.dtype),
                           side="left")
    pos_ref = jnp.minimum(jnp.maximum(pos_ref0, idx + 1), size_flow)
    lambda_omega = jnp.where(
        pos_ref == size_flow,
        jnp.asarray(0.0, sorted_g.dtype),
        c / sorted_g[jnp.minimum(pos_ref, size_flow) - 1],
    )
    lambda_pi = jnp.minimum(lambda_omega, lambda_per_pixel)
    return jnp.exp(-lambda_pi * maxgrad)


def robust_expo_scale(I1, I2, u, v, method_type=DEFAULT_METHOD,
                      alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                      lam=DEFAULT_LAMBDA, tol=DEFAULT_TOL,
                      inner_iter=DEFAULT_INNER, outer_iter=DEFAULT_OUTER,
                      stop="error", maxiter=MAXITER_SOR, with_diag=False,
                      warp_mode="exact", dmax=8):
    """Single-scale robust-expo flow on (C, H, W) image planes
    (reference robust_expo_methods single-scale overload,
    src/robust_expo_methods.cpp:161-455).  `alpha` must already be
    channel-adapted (int(alpha * nz)) as the multiscale driver does.

    `with_diag=True` additionally returns {"iterations": (outer, inner)
    int32, "error": (outer, inner)} — the SOR scalars the reference
    prints when verbose (src/robust_expo_methods.cpp:402-404)."""
    nz, ny, nx = I1.shape
    size = nx * ny * nz  # SOR error norm, src/robust_expo_methods.cpp:400
    eps2 = EPSILON * EPSILON
    colors = _red_black(I1.shape[-2:])

    I1x, I1y = centered_gradient(I1)
    I2x, I2y = centered_gradient(I2)
    # (6, C, H, W) derivative planes warped together per outer iteration
    planes = jnp.stack([I2, I2x, I2y, dxx(I2), dxy(I2), dyy(I2)])
    expo = exponential_diffusivity(I1x, I1y, method_type, alpha, lam)

    def outer_body(uv, _):
        u, v = uv
        flat = planes.reshape(6 * nz, ny, nx)
        if warp_mode == "fast":
            warped = warp_planes_shift(flat, u, v, dmax)
        else:
            warped = warp_planes(flat, u, v, border_out=True)
        I2w, I2wx, I2wy, I2wxx, I2wxy, I2wyy = warped.reshape(6, nz, ny, nx)

        ux, uy = centered_gradient(u)
        vx, vy = centered_gradient(v)
        # psi_smooth = expo / sqrt(expo*|grad w|^2 + eps^2)
        # (robust_expo_psi_smooth, src/robust_expo_smoothness.cpp:28-47)
        norm_flow = expo * (ux * ux + uy * uy + vx * vx + vy * vy)
        psis = expo / jnp.sqrt(norm_flow + eps2)
        psi1, psi2, psi3, psi4 = psi_divergence(psis)
        div_u = psi_weighted_divergence(u, psi1, psi2, psi3, psi4)
        div_v = psi_weighted_divergence(v, psi1, psi2, psi3, psi4)
        div_d = alpha * (psi1 + psi2 + psi3 + psi4)

        du = jnp.zeros_like(u)
        dv = jnp.zeros_like(v)

        def inner_body(dudv, _):
            du, dv = dudv
            # channel-summed robustness weights
            # (psi_data/psi_gradient, src/robust_expo_methods.cpp:36-105)
            dI = I2w + I2wx * du + I2wy * dv - I1
            psid = 1.0 / jnp.sqrt(jnp.sum(dI * dI, axis=0) + eps2)
            dIx = I2wx + I2wxx * du + I2wxy * dv - I1x
            dIy = I2wy + I2wxy * du + I2wyy * dv - I1y
            psig = 1.0 / jnp.sqrt(jnp.sum(dIx * dIx + dIy * dIy, axis=0) + eps2)

            # channel-summed system constants (:273-318)
            g = gamma * psig
            dif = I2w - I1
            dx = I2wx - I1x
            dy = I2wy - I1y
            Au = (-psid * jnp.sum(dif * I2wx, axis=0)
                  - g * jnp.sum(dx * I2wxx + dy * I2wxy, axis=0)
                  + alpha * div_u)
            Av = (-psid * jnp.sum(dif * I2wy, axis=0)
                  - g * jnp.sum(dx * I2wxy + dy * I2wyy, axis=0)
                  + alpha * div_v)
            Du = (psid * jnp.sum(I2wx * I2wx, axis=0)
                  + g * jnp.sum(I2wxx * I2wxx + I2wxy * I2wxy, axis=0)
                  + div_d)
            Dv = (psid * jnp.sum(I2wy * I2wy, axis=0)
                  + g * jnp.sum(I2wyy * I2wyy + I2wxy * I2wxy, axis=0)
                  + div_d)
            D = (psid * jnp.sum(I2wy * I2wx, axis=0)
                 + g * jnp.sum((I2wxx + I2wyy) * I2wxy, axis=0))

            du, dv, nsor, err = _sor_solve(du, dv, Au, Av, Du, Dv, D, alpha,
                                           (psi1, psi2, psi3, psi4), colors,
                                           tol, size, stop, maxiter)
            return (du, dv), (nsor, err)

        (du, dv), diag = jax.lax.scan(inner_body, (du, dv), None,
                                      length=inner_iter)
        return (u + du, v + dv), diag

    (u, v), (nsors, errs) = jax.lax.scan(outer_body, (u, v), None,
                                         length=outer_iter)
    if with_diag:
        return u, v, {"iterations": nsors, "error": errs}
    return u, v


@partial(jax.jit, static_argnames=("method_type", "alpha", "gamma", "lam",
                                   "tol", "inner_iter", "outer_iter", "stop",
                                   "maxiter", "with_diag", "warp_mode",
                                   "dmax"))
def _robust_expo_scale_jit(I1, I2, u, v, method_type, alpha, gamma, lam, tol,
                           inner_iter, outer_iter, stop, maxiter,
                           with_diag=False, warp_mode="exact", dmax=8):
    return robust_expo_scale(I1, I2, u, v, method_type, alpha, gamma, lam,
                             tol, inner_iter, outer_iter, stop, maxiter,
                             with_diag=with_diag, warp_mode=warp_mode,
                             dmax=dmax)


def _presmooth_reference(im):
    """Replicate the reference's buggy presmooth
    (src/robust_expo_methods.cpp:497-498): Gaussian with sigma = channel
    count and DIRICHLET boundary, applied to the first ny*nx values of
    the INTERLEAVED (H, W, C) buffer viewed as an (H, W) image.  For
    grayscale this is an ordinary sigma=1.0 Dirichlet smooth."""
    nz, ny, nx = im.shape
    if nz == 1:
        return gaussian(im, float(nz), bc="dirichlet")
    inter = jnp.moveaxis(im, 0, -1).reshape(-1)  # interleaved row-major
    head = gaussian(inter[: ny * nx].reshape(ny, nx), float(nz),
                    bc="dirichlet").reshape(-1)
    inter = inter.at[: ny * nx].set(head)
    return jnp.moveaxis(inter.reshape(ny, nx, nz), -1, 0)


def robust_expo(I1, I2, method_type=DEFAULT_METHOD, alpha=DEFAULT_ALPHA,
                gamma=DEFAULT_GAMMA, lam=DEFAULT_LAMBDA,
                nscales=DEFAULT_NSCALES, zfactor=DEFAULT_ZFACTOR,
                tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                outer_iter=DEFAULT_OUTER, stop="error",
                maxiter=MAXITER_SOR, clamp_scales=True,
                presmooth_mode="reference", level_callback=None,
                resume=None, verbose=False, with_diag=False,
                warp_mode="exact", max_motion=8, _whole=True):
    """Multiscale robust-expo flow (reference robust_expo_methods
    multiscale overload, src/robust_expo_methods.cpp:462-566).

    I1/I2: (H, W) grayscale or (C, H, W) channel planes.

    `level_callback` / `resume` are the shared run_pyramid_state
    checkpoint hooks (state keys u1/u2).

    `verbose` prints the reference's stdout lines: `Scale: %d` per
    level (src/robust_expo_methods.cpp:534-536) and
    `Iterations: %d Error: %g` per outer*inner iteration (:402-404,
    cout default float formatting).  `with_diag=True` returns
    (u, v, diags), diags[s] = {"iterations": (outer, inner),
    "error": (outer, inner)}, finest first.

    The plain call (no hooks, verbose or diagnostics) runs the whole
    pyramid as one jitted program; `warp_mode`/`max_motion` as in
    `tpuflow.models.tvl1.tvl1_multiscale`."""
    import sys

    if (_whole and not verbose and not with_diag and level_callback is None
            and resume is None):
        return _robust_expo_whole(I1, I2, method_type, alpha, gamma, lam,
                                  nscales, zfactor, tol, inner_iter,
                                  outer_iter, stop, maxiter, clamp_scales,
                                  presmooth_mode, warp_mode, max_motion)

    if I1.ndim == 2:
        I1 = I1[None]
        I2 = I2[None]
    nz, ny, nx = I1.shape
    if clamp_scales:
        # reference main clamps on min(nx, ny) >= 16
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    # alpha adapted for channels and truncated to int
    # (src/robust_expo_methods.cpp:527)
    alpha_adapted = float(int(alpha * nz))

    def preprocess(images):
        # per-channel joint [0,255] normalization
        # (image_normalization_2_color, src/utils.cpp:334-404)
        I1n, I2n = normalize_joint(*images)
        if presmooth_mode == "reference":
            return _presmooth_reference(I1n), _presmooth_reference(I2n)
        if presmooth_mode == "clean":
            return (gaussian(I1n, PRESMOOTHING_SIGMA),
                    gaussian(I2n, PRESMOOTHING_SIGMA))
        raise ValueError(f"unknown presmooth_mode {presmooth_mode!r}")

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(level_images, state, scale):
        l1, l2 = level_images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = _robust_expo_scale_jit(l1, l2, state["u1"], state["u2"],
                                     method_type, alpha_adapted, gamma, lam,
                                     tol, inner_iter, outer_iter, stop,
                                     maxiter, with_diag=diag,
                                     warp_mode=warp_mode, dmax=dmax)
        if diag:
            u, v, d = out
            diags[scale] = d
            if verbose:
                print(f"Scale: {scale}", file=sys.stdout)
                for o in range(outer_iter):
                    for i in range(inner_iter):
                        print(f"Iterations: {int(d['iterations'][o, i])} "
                              f"Error: {float(d['error'][o, i]):g}",
                              file=sys.stdout)
        else:
            u, v = out
        return {"u1": u, "u2": v}

    state = run_pyramid_state(
        (I1, I2), nscales, zfactor, solve,
        presmooth=None, preprocess=preprocess,
        level_callback=level_callback, resume=resume,
        trace_name="robust_expo")
    if with_diag:
        return state["u1"], state["u2"], diags
    return state["u1"], state["u2"]


@partial(jax.jit, static_argnames=("method_type", "alpha", "gamma", "lam",
                                   "nscales", "zfactor", "tol",
                                   "inner_iter", "outer_iter", "stop",
                                   "maxiter", "clamp_scales",
                                   "presmooth_mode", "warp_mode",
                                   "max_motion"))
def _robust_expo_whole(I1, I2, method_type, alpha, gamma, lam, nscales,
                       zfactor, tol, inner_iter, outer_iter, stop, maxiter,
                       clamp_scales, presmooth_mode, warp_mode, max_motion):
    """The whole coarse-to-fine solve as ONE device program."""
    return robust_expo(I1, I2, method_type=method_type, alpha=alpha,
                       gamma=gamma, lam=lam, nscales=nscales,
                       zfactor=zfactor, tol=tol, inner_iter=inner_iter,
                       outer_iter=outer_iter, stop=stop, maxiter=maxiter,
                       clamp_scales=clamp_scales,
                       presmooth_mode=presmooth_mode, warp_mode=warp_mode,
                       max_motion=max_motion, _whole=False)
