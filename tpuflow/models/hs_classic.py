"""Classic (1981) Horn-Schunck — single scale, no warping, no pyramid.

Vectorized version of reference src/horn_schunck_classic.cpp: the
derivative stencils (2x2x2 cube averages, src/horn_schunck_classic.cpp
:47-75), the 12-point neighborhood average (compute_bar, :79-95) and the
Jacobi-style iteration (hs_iteration, :99-122) are pure shift/pad
expressions; the fixed iteration count runs under `lax.fori_loop`
inside one jit.  All boundary handling is Neumann clamping
(extend_float_image_constant, :22-44).
"""

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.ops.gradients import _shift_clamp


def _input_derivatives(a, b):
    """Ex, Ey, Et via 2x2x2 cube averaging (reference
    src/horn_schunck_classic.cpp:47-75)."""
    ar = _shift_clamp(a, 1, -1)      # a(i+1, j)
    ad = _shift_clamp(a, 1, -2)      # a(i, j+1)
    adr = _shift_clamp(ad, 1, -1)    # a(i+1, j+1)
    br = _shift_clamp(b, 1, -1)
    bd = _shift_clamp(b, 1, -2)
    bdr = _shift_clamp(bd, 1, -1)
    Ey = 0.25 * ((ad - a) + (adr - ar) + (bd - b) + (bdr - br))
    Ex = 0.25 * ((ar - a) + (adr - ad) + (br - b) + (bdr - bd))
    Et = 0.25 * ((b - a) + (br - ar) + (bd - ad) + (bdr - adr))
    return Ex, Ey, Et


def _bar(u):
    """12-point weighted neighborhood average (reference
    src/horn_schunck_classic.cpp:79-95)."""
    l = _shift_clamp(u, -1, -1)
    r = _shift_clamp(u, 1, -1)
    up = _shift_clamp(u, -1, -2)
    dn = _shift_clamp(u, 1, -2)
    ul = _shift_clamp(up, -1, -1)
    ur = _shift_clamp(up, 1, -1)
    dl = _shift_clamp(dn, -1, -1)
    dr = _shift_clamp(dn, 1, -1)
    return (l + r + up + dn) / 6.0 + (ul + ur + dl + dr) / 12.0


def hs_classic(a, b, niter, alpha):
    """n iterations of classic Horn-Schunck (reference `hs`,
    src/horn_schunck_classic.cpp:125-149).  Returns (u, v).  `niter`
    may be a traced scalar."""
    Ex, Ey, Et = _input_derivatives(a, b)
    den = alpha * alpha + Ex * Ex + Ey * Ey

    def body(_, uv):
        u, v = uv
        ubar = _bar(u)
        vbar = _bar(v)
        t = (Ex * ubar + Ey * vbar + Et) / den
        return ubar - Ex * t, vbar - Ey * t

    u = jnp.zeros_like(a)
    v = jnp.zeros_like(a)
    return jax.lax.fori_loop(0, niter, body, (u, v))


@partial(jax.jit, static_argnames=("niter", "alpha"))
def hs_classic_jit(a, b, niter, alpha):
    return hs_classic(a, b, niter, alpha)


@partial(jax.jit, static_argnames=("alpha",))
def hs_classic_batched(a, b, niter, alpha):
    """Batched classic HS: (B, H, W) pairs -> (B, H, W) flows; `niter`
    is a runtime scalar, so iteration-count changes never recompile."""
    return jax.vmap(lambda x, y: hs_classic(x, y, niter, alpha))(a, b)
