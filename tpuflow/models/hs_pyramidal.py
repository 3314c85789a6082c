"""Pyramidal (warping) Horn-Schunck with 4-color SOR.

Reference: src/horn_schunck_pyramidal.cpp.  Per warp the linearized
system constants are (src/horn_schunck_pyramidal.cpp:128-137):

    Au = (I1 - I2w + I2wx*u + I2wy*v) * I2wx      Du = I2wx^2 + alpha^2
    Av = (...same...) * I2wy                      Dv = I2wy^2 + alpha^2
    D  = I2wx * I2wy

and the SOR update with the 12-point weighted Laplacian
(sor_iteration, :32-71, omega = 1.9):

    u <- (1-w)u + w(Au - D v + alpha^2 * ula)/Du
    v <- (1-w)v + w(Av - D u_new + alpha^2 * vla)/Dv

Design: the reference's in-place Gauss-Seidel sweep cannot
vectorize (and its OpenMP version already races on neighbor reads, so
reference results are thread-count-dependent).  We use 4-COLOR
ordering on the 2x2 parity grid: four masked quarter-updates per
sweep.  Under this coloring every one of the 8 stencil neighbors has a
different color than the center, so each update reads either
already-updated (earlier color) or previous-sweep (later color) values
— a true multicolor Gauss-Seidel, stable at omega=1.9.  (Plain
red-black is NOT usable here: the diagonal neighbors share the center
color, degenerating a third of the stencil to over-relaxed Jacobi,
which diverges at 1.9 — verified experimentally.)  Multicolor and
lexicographic SOR converge to the same fixed point of each warp's
linear system, so results agree with the reference up to the stopping
tolerance; tests validate this empirically.

The warp loop and SOR loop both run inside one jit per pyramid level;
the SOR loop is a `lax.while_loop` carrying (u, v, error, n) with the
reference's stopping rule `sqrt(err/size) > TOL && n < maxiter`.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.models.common import run_pyramid
from tpuflow.ops import centered_gradient, warp_planes
from tpuflow.ops.gradients import _shift_clamp
from tpuflow.ops.interp import warp_planes_shift

SOR_OMEGA = 1.9  # reference src/horn_schunck_pyramidal.cpp:21

# CLI defaults, reference src/horn_schunck_pyramidal_main.cpp:24-33
DEFAULT_ALPHA = 7.0
DEFAULT_NSCALES = 10
DEFAULT_ZFACTOR = 0.5
DEFAULT_WARPS = 10
DEFAULT_TOL = 1e-4
DEFAULT_MAXITER = 150


def _weighted_laplacian(f):
    """12-point neighborhood average: 1/12 diagonals + 1/6 direct,
    Neumann-clamped (reference sor_iteration neighbor lists,
    src/horn_schunck_pyramidal.cpp:148-228)."""
    l = _shift_clamp(f, -1, -1)
    r = _shift_clamp(f, 1, -1)
    up = _shift_clamp(f, -1, -2)
    dn = _shift_clamp(f, 1, -2)
    ul = _shift_clamp(up, -1, -1)
    ur = _shift_clamp(up, 1, -1)
    dl = _shift_clamp(dn, -1, -1)
    dr = _shift_clamp(dn, 1, -1)
    return (ul + ur + dl + dr) / 12.0 + (l + r + up + dn) / 6.0


def _four_colors(shape):
    """2x2-block coloring: colors 0..3 by (row parity, col parity).

    The 12-point stencil touches the 8 surrounding pixels; under this
    coloring every neighbor has a DIFFERENT color than the center, so a
    4-phase masked update is a true multicolor Gauss-Seidel ordering —
    it converges for omega=1.9 exactly like the reference's sequential
    sweep, unlike red-black (where diagonal neighbors share the color
    and the scheme degenerates to over-relaxed Jacobi, which diverges).
    """
    ii = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    c = (ii % 2) * 2 + (jj % 2)
    return tuple(c == k for k in range(4))


def _sor_sweep(u, v, Au, Av, Du, Dv, D, al, colors):
    """One 4-color SOR sweep (four masked quarter-updates); returns
    (u, v, sum of squared updates)."""
    w = SOR_OMEGA
    err = jnp.zeros((), dtype=u.dtype)
    for mask in colors:
        ula = _weighted_laplacian(u)
        u_cand = (1.0 - w) * u + w * (Au - D * v + al * ula) / Du
        u_new = jnp.where(mask, u_cand, u)
        vla = _weighted_laplacian(v)
        v_cand = (1.0 - w) * v + w * (Av - D * u_new + al * vla) / Dv
        v_new = jnp.where(mask, v_cand, v)
        err = err + jnp.sum((u_new - u) ** 2 + (v_new - v) ** 2)
        u, v = u_new, v_new
    return u, v, err


def hs_scale(I1, I2, u, v, alpha=DEFAULT_ALPHA, warps=DEFAULT_WARPS,
             tol=DEFAULT_TOL, maxiter=DEFAULT_MAXITER, stop="error",
             with_diag=False, warp_mode="exact", dmax=8):
    """Single-scale warping Horn-Schunck (reference
    horn_schunck_optical_flow, src/horn_schunck_pyramidal.cpp:78-249).

    `with_diag=True` additionally returns a dict of per-warp stopping
    stats (`iterations` (warps,) int32, `error` (warps,)) — the scalars
    the reference prints when verbose
    (src/horn_schunck_pyramidal.cpp:233-235)."""
    dtype = I1.dtype
    size = I1.size
    alpha2 = alpha * alpha
    I2x, I2y = centered_gradient(I2)
    planes = jnp.stack([I2, I2x, I2y])
    colors = _four_colors(I1.shape)

    def warp_body(uv, _):
        u, v = uv
        if warp_mode == "fast":
            I2w, I2wx, I2wy = warp_planes_shift(planes, u, v, dmax)
        else:
            I2w, I2wx, I2wy = warp_planes(planes, u, v, border_out=True)
        dif = I1 - I2w + I2wx * u + I2wy * v
        Au = dif * I2wx
        Av = dif * I2wy
        Du = I2wx * I2wx + alpha2
        Dv = I2wy * I2wy + alpha2
        D = I2wx * I2wy

        if stop == "error":
            def cond(c):
                return (c[2] > tol) & (c[3] < maxiter)

            def body(c):
                u, v, _, n = c
                u, v, err = _sor_sweep(u, v, Au, Av, Du, Dv, D, alpha2, colors)
                return u, v, jnp.sqrt(err / size), n + 1

            init = (u, v, jnp.asarray(1000.0, dtype), jnp.asarray(0, jnp.int32))
            u, v, err, n = jax.lax.while_loop(cond, body, init)
        else:
            def body(_, c):
                u, v, _ = c
                u, v, e = _sor_sweep(u, v, Au, Av, Du, Dv, D, alpha2, colors)
                return u, v, jnp.sqrt(e / size)

            u, v, err = jax.lax.fori_loop(
                0, maxiter, body, (u, v, jnp.asarray(1000.0, dtype)))
            n = jnp.asarray(maxiter, jnp.int32)
        return (u, v), (n, err)

    (u, v), (ns, errs) = jax.lax.scan(warp_body, (u, v), None, length=warps)
    if with_diag:
        return u, v, {"iterations": ns, "error": errs}
    return u, v


@partial(jax.jit, static_argnames=("alpha", "warps", "tol", "maxiter", "stop",
                                   "with_diag", "warp_mode", "dmax"))
def _hs_scale_jit(I1, I2, u, v, alpha, warps, tol, maxiter, stop,
                  with_diag=False, warp_mode="exact", dmax=8):
    return hs_scale(I1, I2, u, v, alpha, warps, tol, maxiter, stop,
                    with_diag=with_diag, warp_mode=warp_mode, dmax=dmax)


def hs_pyramidal(I1, I2, alpha=DEFAULT_ALPHA, nscales=DEFAULT_NSCALES,
                 zfactor=DEFAULT_ZFACTOR, warps=DEFAULT_WARPS,
                 tol=DEFAULT_TOL, maxiter=DEFAULT_MAXITER, stop="error",
                 clamp_scales=True, verbose=False, with_diag=False,
                 warp_mode="exact", max_motion=8):
    """Multiscale warping Horn-Schunck (reference horn_schunck_pyramidal,
    src/horn_schunck_pyramidal.cpp:258-370).

    `verbose` prints the reference binary's stderr lines: the multiscale
    header (src/horn_schunck_pyramidal.cpp:274-277), `Scale: %d %dx%d`
    per level (:326-328), and per warp `Warping %d: Iterations %d (%g)`
    (:118-120, :233-235).  `with_diag=True` returns (u, v, diags) with
    diags[s] the per-warp stats dict of scale s (finest first).
    `warp_mode`/`max_motion` as in `tpuflow.models.tvl1.tvl1_multiscale`."""
    import math
    import sys

    from tpuflow.ops import clamp_nscales

    ny, nx = I1.shape[-2:]
    if clamp_scales:
        # reference main clamps so the coarsest pyramid diagonal stays
        # >= 16 px (src/horn_schunck_pyramidal_main.cpp:141-144)
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=True)

    if verbose:
        print(f"Multiscale Horn-Schunck of a {nx}x{ny} pair\n"
              f"\ta={alpha:g} ns={nscales} zf={zfactor:g} nw={warps} "
              f"eps={tol:g} mi={maxiter}", file=sys.stderr)

    diag = with_diag or verbose
    diags = [None] * nscales

    def solve(images, u, v, scale=None):
        lvl1, lvl2 = images
        dmax = max(3, math.ceil(max_motion * (zfactor ** scale)))
        out = _hs_scale_jit(lvl1, lvl2, u, v, alpha, warps, tol, maxiter,
                            stop, with_diag=diag, warp_mode=warp_mode,
                            dmax=dmax)
        if diag:
            u, v, d = out
            diags[scale] = d
            if verbose:
                lny, lnx = lvl1.shape[-2:]
                print(f"Scale: {scale} {lnx}x{lny}", file=sys.stderr)
                for w in range(warps):
                    print(f"Warping {w}: Iterations {int(d['iterations'][w])} "
                          f"({float(d['error'][w]):g})", file=sys.stderr)
            return u, v
        return out

    u, v, _ = run_pyramid((I1, I2), nscales, zfactor, solve)
    if with_diag:
        return u, v, diags
    return u, v
