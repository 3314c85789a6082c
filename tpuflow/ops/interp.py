"""Bicubic interpolation and backward warping.

Vectorized re-design of the reference's per-pixel interpolation
(reference src/bicubic_interpolation.cpp).  Semantics are replicated
EXACTLY, including two reference quirks that affect results:

  * coordinates are truncated toward zero, not floored
    (`(int) uu` at src/bicubic_interpolation.cpp:170), so for
    -1 < uu < 0 the cell anchor is 0 and the fraction is negative;
  * the y "minus" neighbor uses the X sign: `my = (int)vv - sx`
    (src/bicubic_interpolation.cpp:173 — a latent reference bug kept
    for bit-parity);
  * the out-of-domain flag is set iff any of the 8 tap indices clamps
    (neumann_bc, src/bicubic_interpolation.cpp:24-39); with
    `border_out=True` such pixels return 0 (warp semantics at
    src/bicubic_interpolation.cpp:352-374).

The default compile-time BC in the reference is Neumann
(BOUNDARY_CONDITION 0, src/bicubic_interpolation.cpp:14); that is the
only one any shipped solver uses, and the only one implemented here.

`warp_stack` fuses the warp of N planes (image + derivative planes) that
share one flow field: the 16 tap indices and cubic weights are computed
once and reused for every plane — the vectorized answer to the reference
calling bicubic_interpolation_warp 3-6 times per warp iteration
(e.g. src/tvl1flow.cpp:94-96).
"""

import jax
import jax.numpy as jnp


def _cubic(v0, v1, v2, v3, x):
    """Keys cubic interpolation cell (reference src/bicubic_interpolation.cpp:108-123)."""
    return v1 + 0.5 * x * (
        v2 - v0 + x * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3 + x * (3.0 * (v1 - v2) + v3 - v0))
    )


def _tap_indices(coord, n):
    """Integer tap indices + clamped versions + out flag for one axis.

    Returns (anchor_clamped, [m, c, d, dd] clamped indices, out).
    """
    s = jnp.where(coord < 0, -1, 1).astype(jnp.int32)
    i = jnp.trunc(coord).astype(jnp.int32)
    raw = (i - s, i, i + s, i + 2 * s)
    out = jnp.zeros(coord.shape, dtype=bool)
    clamped = []
    for r in raw:
        out = out | (r < 0) | (r >= n)
        clamped.append(jnp.clip(r, 0, n - 1))
    return clamped[1], clamped, out, s


def bicubic_at(img, xx, yy, border_out=False):
    """Bicubic sample of `img` (H, W) at coordinates (xx, yy) (any shape).

    Equivalent to calling reference bicubic_interpolation_at
    (src/bicubic_interpolation.cpp:153-245) at every (xx, yy).
    """
    return warp_stack(img[None], xx, yy, border_out)[0]


def warp_stack(planes, xx, yy, border_out=False, window=None):
    """Bicubic-sample a stack of planes (N, H, W) at shared coordinates.

    The tap-index/weight computation is shared across planes; each plane
    costs only its 16 gathers.  Returns (N,) + xx.shape.

    `window=(origin_y, origin_x, global_ny, global_nx)` supports tiled
    execution: `planes` then holds only the window starting at the given
    global origin, while coordinates/clamping/out-of-domain detection
    use the GLOBAL extent (tpuflow.parallel feeds halo-padded tiles
    through this).  Taps falling outside the window clamp to its rim —
    exact whenever the halo covers the displacement.
    """
    n_planes, wny, wnx = planes.shape
    dtype = planes.dtype
    if window is None:
        oy = ox = 0
        ny, nx = wny, wnx
    else:
        oy, ox, ny, nx = window

    cx, xs, out_x, sx = _tap_indices(xx, nx)
    # reference bug: the y minus-neighbor offset uses sx, replicate it
    sy = jnp.where(yy < 0, -1, 1).astype(jnp.int32)
    yi = jnp.trunc(yy).astype(jnp.int32)
    raw_y = (yi - sx, yi, yi + sy, yi + 2 * sy)
    out_y = jnp.zeros(yy.shape, dtype=bool)
    ys = []
    for r in raw_y:
        out_y = out_y | (r < 0) | (r >= ny)
        ys.append(jnp.clip(r, 0, ny - 1))
    cy = ys[1]

    out = out_x | out_y
    fx = (xx - cx.astype(dtype)).astype(dtype)
    fy = (yy - cy.astype(dtype)).astype(dtype)

    if window is not None:
        xs = [jnp.clip(x - ox, 0, wnx - 1) for x in xs]
        ys = [jnp.clip(y - oy, 0, wny - 1) for y in ys]

    flat = planes.reshape(n_planes, wny * wnx)
    # linear indices for the 16 taps, shared by all planes
    lin = [[(ys[m] * wnx + xs[l]).ravel() for m in range(4)] for l in range(4)]

    results = []
    for p in range(n_planes):
        fp = flat[p]
        cols = []
        for l in range(4):  # x-offset l: interpolate along y first
            t0 = jnp.take(fp, lin[l][0]).reshape(xx.shape)
            t1 = jnp.take(fp, lin[l][1]).reshape(xx.shape)
            t2 = jnp.take(fp, lin[l][2]).reshape(xx.shape)
            t3 = jnp.take(fp, lin[l][3]).reshape(xx.shape)
            cols.append(_cubic(t0, t1, t2, t3, fy))
        val = _cubic(cols[0], cols[1], cols[2], cols[3], fx)
        if border_out:
            val = jnp.where(out, jnp.zeros((), dtype=dtype), val)
        results.append(val)
    return jnp.stack(results)


def warp(img, u, v, border_out=True):
    """Backward-warp `img` by flow (u, v): out(x) = img(x + u(x)).

    Matches reference bicubic_interpolation_warp
    (src/bicubic_interpolation.cpp:352-374).
    """
    ny, nx = img.shape[-2:]
    dtype = img.dtype
    jj = jnp.arange(nx, dtype=dtype)[None, :]
    ii = jnp.arange(ny, dtype=dtype)[:, None]
    xx = jj + u
    yy = ii + v
    if img.ndim == 2:
        return warp_stack(img[None], xx, yy, border_out)[0]
    return warp_stack(img, xx, yy, border_out)


def warp_planes(planes, u, v, border_out=True):
    """Warp a (N, H, W) stack by one flow field, sharing tap computation."""
    ny, nx = planes.shape[-2:]
    dtype = planes.dtype
    jj = jnp.arange(nx, dtype=dtype)[None, :]
    ii = jnp.arange(ny, dtype=dtype)[:, None]
    return warp_stack(planes, jj + u, ii + v, border_out)


def warp_planes_shift(planes, u, v, dmax, border_out=True):
    """Gather-free bicubic warp for displacement-bounded flows.

    For |u|inf, |v|inf <= dmax this evaluates the same 16-tap bicubic
    as a sum over (2*dmax+4)^2 STATIC shifts with per-pixel one-hot
    weights: elementwise multiply-adds with no data-dependent indexing,
    so under GSPMD every tile needs only a halo of width dmax+2 from
    its neighbours, where the gather would need the whole frame.  This
    is `warp_mode="fast"`; coarse-to-fine drivers bound the per-level
    flow as max(3, ceil(max_motion * zfactor**s)).

    Semantics match `warp_planes(..., border_out=True)` for in-bound
    flows up to summation order (weights are expanded algebraically
    instead of Horner-nested; f32 differences ~1e-6).  Pixels whose
    flow exceeds dmax produce 0 -- the same failure class as the
    border_out zeroing.

    With `border_out=False` (tvl1occflow's mode) out-of-domain pixels
    keep the bicubic value at clamped tap indices, replicating the
    reference's neumann_bc clamping for non-negative coordinates
    (src/bicubic_interpolation.cpp:24-39); coordinates < 0 use the
    floor anchor instead of the reference's trunc anchor, a sub-pixel
    difference confined to the one-cell image rim.
    """
    np_, ny, nx = planes.shape
    dtype = planes.dtype
    D = int(dmax)

    jj = jnp.arange(nx, dtype=dtype)[None, :]
    ii = jnp.arange(ny, dtype=dtype)[:, None]
    xx = jj + u
    yy = ii + v
    x0 = jnp.floor(xx)
    y0 = jnp.floor(yy)
    fx = (xx - x0).astype(dtype)
    fy = (yy - y0).astype(dtype)
    relx = x0.astype(jnp.int32) - jnp.arange(nx, dtype=jnp.int32)[None, :]
    rely = y0.astype(jnp.int32) - jnp.arange(ny, dtype=jnp.int32)[:, None]

    # out-of-domain rule for non-negative coords (reference
    # neumann_bc + trunc anchor, src/bicubic_interpolation.cpp:153-245):
    # out iff floor < 1 or floor > n-3; negative coords are always out
    out = ((xx < 1) | (x0 > nx - 3) | (yy < 1) | (y0 > ny - 3))

    def cubic_weights(t):
        # Keys cell expanded per tap (reference _cubic above):
        # w0 = 0.5*(-t^3 + 2t^2 - t), w1 = 0.5*(3t^3 - 5t^2 + 2),
        # w2 = 0.5*(-3t^3 + 4t^2 + t), w3 = 0.5*(t^3 - t^2)
        t2 = t * t
        t3 = t2 * t
        return (0.5 * (-t3 + 2 * t2 - t),
                0.5 * (3 * t3 - 5 * t2 + 2),
                0.5 * (-3 * t3 + 4 * t2 + t),
                0.5 * (t3 - t2))

    cx = cubic_weights(fx)
    cy = cubic_weights(fy)

    def axis_weight(c, rel, off):
        # weight of the tap at static offset `off`: tap index
        # m = off - rel + 1 must land in [0, 4)
        m = off - rel + 1
        w = jnp.zeros_like(c[0])
        for t in range(4):
            w = jnp.where(m == t, c[t], w)
        return w

    offsets = range(-D - 1, D + 3)
    wxs = {kx: axis_weight(cx, relx, kx) for kx in offsets}

    def ky_step(acc, ky):
        # all planes' taps at row offset ky: planes[(i+ky), (j+kx)],
        # indices clamped (clamping never triggers for in-domain
        # pixels: their taps are inside by the `out` rule)
        wy = axis_weight(cy, rely, ky)
        sy = planes[:, jnp.clip(jnp.arange(ny) + ky, 0, ny - 1)]
        for kx in offsets:
            sxy = sy[:, :, jnp.clip(jnp.arange(nx) + kx, 0, nx - 1)]
            acc = acc + (wy * wxs[kx])[None] * sxy
        return acc, None

    acc = jnp.zeros((np_, ny, nx), dtype=dtype)
    if ny * nx >= 512 * 512:
        # large frames (the 1080p/4K configs): the fully unrolled
        # (2D+4)^2-term graph can make XLA materialize one shifted temp
        # per term; sequence the row-offset axis through lax.scan so
        # only one ky-slab of temps is live at a time — identical
        # accumulation order (ky outer, kx inner), bounded memory
        acc, _ = jax.lax.scan(ky_step, acc, jnp.arange(-D - 1, D + 3))
    else:
        for ky in offsets:
            acc, _ = ky_step(acc, ky)
    if not border_out:
        return acc
    return jnp.where(out[None], jnp.zeros((), dtype=dtype), acc)


def interpolate_bilinear(img, xx, yy):
    """Vectorized bilinear sampling (reference me_interpolate_bilinear,
    src/bicubic_interpolation.cpp:407-446).

    The reference's exact-integer-coordinate branches only avoid
    reading out-of-bounds neighbors whose weight is zero; clamping the
    +1 tap indices yields identical values for every in-domain
    coordinate (the only use, me_image_restriction, stays in-domain).
    """
    ny, nx = img.shape[-2:]
    dtype = img.dtype
    l = jnp.floor(xx).astype(jnp.int32)
    k = jnp.floor(yy).astype(jnp.int32)
    a = (xx - l).astype(dtype)
    b = (yy - k).astype(dtype)
    l0 = jnp.clip(l, 0, nx - 1)
    l1 = jnp.clip(l + 1, 0, nx - 1)
    k0 = jnp.clip(k, 0, ny - 1)
    k1 = jnp.clip(k + 1, 0, ny - 1)
    x0 = img[..., k0, l0]
    x1 = img[..., k0, l1]
    x2 = img[..., k1, l0]
    x3 = img[..., k1, l1]
    return ((1 - b) * ((1 - a) * x0 + a * x1)
            + b * ((1 - a) * x2 + a * x3))


def image_restriction(img, out_size):
    """Bilinear cell-centered restriction to `out_size` = (new_nx,
    new_ny) (reference me_image_restriction,
    src/bicubic_interpolation.cpp:653-688): output sample (i, j) reads
    the input at gamma/2 - 0.5 + index*gamma per axis."""
    ny, nx = img.shape[-2:]
    new_nx, new_ny = out_size
    dtype = img.dtype
    gx = nx / new_nx
    gy = ny / new_ny
    xs = (gx / 2.0 - 0.5) + gx * jnp.arange(new_nx, dtype=dtype)
    ys = (gy / 2.0 - 0.5) + gy * jnp.arange(new_ny, dtype=dtype)
    xx = jnp.broadcast_to(xs[None, :], (new_ny, new_nx))
    yy = jnp.broadcast_to(ys[:, None], (new_ny, new_nx))
    return interpolate_bilinear(img, xx, yy)
