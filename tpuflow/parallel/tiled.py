"""Spatially-tiled (halo-exchanged) versions of the core ops and the
TV-L1 scale solver.

Each function here runs INSIDE `jax.shard_map` over a mesh with axes
(y_axis, x_axis): arguments are the local (h, w) tile of a global
(h*Y, w*X) image.  The tiled results are numerically identical to the
full-image ops (same dtype, same operations — the halo pad reconstructs
exactly the neighborhood the full-image op sees), which tests assert
on an 8-device CPU mesh.

Communication pattern: `lax.ppermute` neighbor shifts (point-to-point),
one exchange of width-1 halos per stencil application, width-`halo`
exchange per warp, and `lax.psum` for the scalar convergence error —
exactly the scaling recipe in SURVEY.md §5.8.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from tpuflow.ops import centered_gradient, divergence, forward_gradient, gaussian
from tpuflow.ops.interp import warp_stack
from tpuflow.parallel.halo import crop, exchange_1d, exchange_2d


class TileGeom:
    """Static geometry of a 2D tiling: mesh axis names/sizes and the
    local tile shape (all Python ints/strs — safe to close over)."""

    def __init__(self, y_axis, y_size, x_axis, x_size, tile_h, tile_w):
        self.y_axis = y_axis
        self.y_size = y_size
        self.x_axis = x_axis
        self.x_size = x_size
        self.h = tile_h
        self.w = tile_w
        self.global_ny = y_size * tile_h
        self.global_nx = x_size * tile_w

    def pad(self, a, halo, fill="edge"):
        return exchange_2d(a, halo, self.x_axis, self.x_size,
                           self.y_axis, self.y_size, fill)

    def origins(self):
        """Traced (origin_y, origin_x) of this tile in global coords."""
        yi = lax.axis_index(self.y_axis) if self.y_size > 1 else 0
        xi = lax.axis_index(self.x_axis) if self.x_size > 1 else 0
        return yi * self.h, xi * self.w

    def psum(self, value):
        """Sum a scalar over all tiles."""
        if self.y_size > 1:
            value = lax.psum(value, self.y_axis)
        if self.x_size > 1:
            value = lax.psum(value, self.x_axis)
        return value


def centered_gradient_tiled(I, geom):
    """Tiled centered gradient: edge-fill halo reproduces the clamped
    one-sided boundary differences exactly."""
    p = geom.pad(I, 1, "edge")
    dx, dy = centered_gradient(p)
    return crop(dx, 1), crop(dy, 1)


def forward_gradient_tiled(f, geom):
    """Tiled forward gradient: edge fill makes the difference vanish at
    the global last row/column, matching the reference's explicit zero."""
    p = geom.pad(f, 1, "edge")
    fx, fy = forward_gradient(p)
    return crop(fx, 1), crop(fy, 1)


def divergence_tiled(v1, v2, geom):
    """Tiled backward-difference divergence.

    The Chambolle boundary rule (first col: +v1; last col: -v1[p-1])
    equals plain backward differencing of v1 with its global last
    column zeroed and a zero halo on the leading side; same for v2 in
    y.  We mask the global-boundary tiles' trailing cells, zero-fill
    the halos, and difference."""
    oy, ox = geom.origins()
    jj = ox + lax.broadcasted_iota(jnp.int32, v1.shape, 1)
    ii = oy + lax.broadcasted_iota(jnp.int32, v2.shape, 0)
    v1m = jnp.where(jj == geom.global_nx - 1, 0.0, v1)
    v2m = jnp.where(ii == geom.global_ny - 1, 0.0, v2)
    p1 = geom.pad(v1m, 1, "zero")
    p2 = geom.pad(v2m, 1, "zero")
    div_x = p1[1:-1, 1:-1] - p1[1:-1, :-2]
    div_y = p2[1:-1, 1:-1] - p2[:-2, 1:-1]
    return div_x + div_y


def gaussian_tiled(I, sigma, geom, window=5):
    """Tiled separable Gaussian with the reference's asymmetric
    reflecting pad at global boundaries ('gaussian' fill mode)."""
    from tpuflow.ops.gaussian import gaussian_kernel_1d

    if sigma <= 0:
        return I
    _, size = gaussian_kernel_1d(sigma, window)
    halo = size  # kernel reaches size-1; pad size for parity with ref buffers
    p = geom.pad(I, halo, "gaussian")
    out = gaussian(p, sigma, bc="reflecting", window=window)
    return crop(out, halo)


def warp_planes_tiled(planes, u, v, geom, halo, border_out=True):
    """Tiled fused bicubic warp of an (N, h, w) plane stack.

    Halo width must cover the worst-case displacement + 2 bicubic taps;
    the coarse-to-fine scheme bounds per-level displacements, so the
    caller picks `halo` per level.  Out-of-GLOBAL-domain detection and
    border_out zeroing are exact; taps beyond the halo clamp to the
    padded rim (inexact only when |flow| > halo - 2)."""
    n, h, w = planes.shape
    dtype = planes.dtype
    oy, ox = geom.origins()
    padded = geom.pad(planes, halo, "edge")
    jj = ox + lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ii = oy + lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jj.astype(dtype) + u
    yy = ii.astype(dtype) + v
    return warp_stack(padded, xx, yy, border_out,
                      window=(oy - halo, ox - halo,
                              geom.global_ny, geom.global_nx))


def tvl1_scale_tiled(I0, I1, u1, u2, geom, warp_halo,
                     tau=0.25, lam=0.15, theta=0.3, warps=5,
                     epsilon=0.01, max_iterations=300):
    """Tiled single-scale TV-L1 (cf. tpuflow.models.tvl1.tvl1_scale).

    Identical math to the single-device solver with halo exchanges at
    every stencil/warp; the convergence error is psum'd over tiles so
    all tiles stop together — matching the global stopping rule of the
    reference (src/tvl1flow.cpp:113,150-162)."""
    from tpuflow.models.tvl1 import GRAD_IS_ZERO

    dtype = I0.dtype
    l_t = lam * theta
    taut = tau / theta
    size = geom.global_nx * geom.global_ny

    I1x, I1y = centered_gradient_tiled(I1, geom)
    planes = jnp.stack([I1, I1x, I1y])
    zero = jnp.zeros_like(u1)

    def inner_step(u1, u2, p11, p12, p21, p22, I1wx, I1wy, rho_c, grad):
        rho = rho_c + I1wx * u1 + I1wy * u2
        fi = -rho / jnp.maximum(grad, GRAD_IS_ZERO)
        d1 = jnp.where(rho < -l_t * grad, l_t * I1wx,
                       jnp.where(rho > l_t * grad, -l_t * I1wx,
                                 jnp.where(grad < GRAD_IS_ZERO, 0.0, fi * I1wx)))
        d2 = jnp.where(rho < -l_t * grad, l_t * I1wy,
                       jnp.where(rho > l_t * grad, -l_t * I1wy,
                                 jnp.where(grad < GRAD_IS_ZERO, 0.0, fi * I1wy)))
        v1 = u1 + d1
        v2 = u2 + d2
        u1n = v1 + theta * divergence_tiled(p11, p12, geom)
        u2n = v2 + theta * divergence_tiled(p21, p22, geom)
        err = geom.psum(jnp.sum((u1n - u1) ** 2 + (u2n - u2) ** 2)) / size
        u1x, u1y = forward_gradient_tiled(u1n, geom)
        u2x, u2y = forward_gradient_tiled(u2n, geom)
        ng1 = 1.0 + taut * jnp.hypot(u1x, u1y)
        ng2 = 1.0 + taut * jnp.hypot(u2x, u2y)
        return (u1n, u2n, (p11 + taut * u1x) / ng1, (p12 + taut * u1y) / ng1,
                (p21 + taut * u2x) / ng2, (p22 + taut * u2y) / ng2, err)

    def warp_body(_, carry):
        u1, u2, p11, p12, p21, p22 = carry
        I1w, I1wx, I1wy = warp_planes_tiled(planes, u1, u2, geom, warp_halo)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u1 - I1wy * u2 - I0

        def cond(c):
            return (c[6] > epsilon * epsilon) & (c[7] < max_iterations)

        def body(c):
            out = inner_step(c[0], c[1], c[2], c[3], c[4], c[5],
                             I1wx, I1wy, rho_c, grad)
            return out + (c[7] + 1,)

        # derive the init error from the data so its sharding "varying"
        # axes match the loop-computed error under shard_map+vmap
        err0 = jnp.asarray(jnp.inf, dtype=dtype) + 0.0 * geom.psum(jnp.sum(u1))
        init = (u1, u2, p11, p12, p21, p22, err0, jnp.asarray(0, jnp.int32))
        return jax.lax.while_loop(cond, body, init)[:6]

    u1, u2, _, _, _, _ = jax.lax.fori_loop(
        0, warps, warp_body, (u1, u2, zero, zero, zero, zero))
    return u1, u2
