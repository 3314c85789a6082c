"""Finite-difference stencils (gradients, divergence, 3x3 masks).

Vectorized formulation of the reference's per-pixel loops
(reference src/operators.cpp): every stencil is expressed as padded
shifts so XLA fuses the whole expression into one elementwise pass.  Boundary
semantics replicate the reference exactly:

  * `centered_gradient`  — central differences, one-sided at the borders
    (clamp-pad; reference src/operators.cpp:335-406)
  * `forward_gradient`   — forward differences, zero at last row/col
    (reference src/operators.cpp:86-125)
  * `divergence`         — backward differences, the adjoint: first
    row/col uses +v, last row/col uses -v[previous]
    (reference src/operators.cpp:35-78, Chambolle's discretization)
  * `mask3x3` and Dxx/Dyy/Dxy — 3x3 convolution with out-of-range mask
    weights folded onto the clamped edge pixel, i.e. edge padding
    (reference src/operators.cpp:132-328).  NOTE: for multi-channel
    images the reference's edge handling reads cross-channel values in
    two places (src/operators.cpp:189,228 use `index+1` where `index+nz`
    is meant) — a latent bug we do NOT replicate; we compute the clean
    per-channel stencil.
  * `centered_gradient3` — central differences over (x, y, frame) for
    the Brox temporal method (reference src/operators.cpp:413-499)

All functions take (H, W) or (..., H, W) arrays (leading axes broadcast)
and return arrays of the same shape/dtype.
"""

import jax.numpy as jnp


def _take(a, sl, axis):
    idx = [slice(None)] * a.ndim
    idx[axis] = sl
    return a[tuple(idx)]


def _shift_clamp(a, off, axis):
    """a evaluated at index i+off along `axis`, edge-clamped (Neumann).

    Only |off| == 1 is needed by the stencils here.
    """
    assert off in (-1, 1)
    if off == 1:
        return jnp.concatenate(
            [_take(a, slice(1, None), axis), _take(a, slice(-1, None), axis)], axis=axis
        )
    return jnp.concatenate(
        [_take(a, slice(None, 1), axis), _take(a, slice(None, -1), axis)], axis=axis
    )


def centered_gradient(I):
    """Central-difference gradient, one-sided at image borders.

    Returns (dx, dy).  Matches reference src/operators.cpp:335-406 for
    every border and corner: dx = 0.5*(I[:, j+1] - I[:, j-1]) with j+-1
    clamped to the valid range (so borders become half one-sided diffs).
    """
    dx = 0.5 * (_shift_clamp(I, 1, -1) - _shift_clamp(I, -1, -1))
    dy = 0.5 * (_shift_clamp(I, 1, -2) - _shift_clamp(I, -1, -2))
    return dx, dy


def centered_gradient3(vol):
    """Central-difference gradient of a (T, H, W) volume over (x, y, t).

    Spatial part is `centered_gradient` per frame; the temporal part is
    0.5*(f[t+1]-f[t-1]) with one-sided halves at the first/last frame,
    and zero when T == 1 (reference src/operators.cpp:413-499).
    """
    dx = 0.5 * (_shift_clamp(vol, 1, -1) - _shift_clamp(vol, -1, -1))
    dy = 0.5 * (_shift_clamp(vol, 1, -2) - _shift_clamp(vol, -1, -2))
    if vol.shape[0] > 1:
        dt = 0.5 * (_shift_clamp(vol, 1, 0) - _shift_clamp(vol, -1, 0))
    else:
        dt = jnp.zeros_like(vol)
    return dx, dy, dt


def forward_gradient(f):
    """Forward-difference gradient; zero at the last column/row.

    Matches reference src/operators.cpp:86-125.
    """
    zx = jnp.zeros_like(f[..., :, :1])
    zy = jnp.zeros_like(f[..., :1, :])
    fx = jnp.concatenate([f[..., :, 1:] - f[..., :, :-1], zx], axis=-1)
    fy = jnp.concatenate([f[..., 1:, :] - f[..., :-1, :], zy], axis=-2)
    return fx, fy


def divergence(v1, v2):
    """Backward-difference divergence (adjoint of `forward_gradient`).

    div[p] = (v1[p]-v1[p-1]) + (v2[p]-v2[p-nx]) in the interior, with
    the Chambolle boundary rule: at the first column the x-term is
    +v1[p], at the last column it is -v1[p-1] (same for rows in y).
    Matches reference src/operators.cpp:35-78.
    """
    # zero out the last column of v1 (its value never contributes), then
    # backward-difference against a zero-padded left neighbor
    a = v1.at[..., :, -1].set(0.0)
    zx = jnp.zeros_like(a[..., :, :1])
    div_x = a - jnp.concatenate([zx, a[..., :, :-1]], axis=-1)

    b = v2.at[..., -1, :].set(0.0)
    zy = jnp.zeros_like(b[..., :1, :])
    div_y = b - jnp.concatenate([zy, b[..., :-1, :]], axis=-2)
    return div_x + div_y


def mask3x3(I, mask):
    """3x3 convolution with edge-fold boundary handling (= edge padding).

    `mask` is a 3x3 array laid out as in the reference (row-major,
    mask[0..8]); the output pixel is sum_{l,m} I[i+l-1, j+m-1]*mask[l,m]
    with out-of-range taps clamped to the edge (reference
    src/operators.cpp:132-256 folds out-of-range mask weights onto the
    edge pixel, which is exactly edge padding).
    """
    mask = jnp.asarray(mask, dtype=I.dtype).reshape(3, 3)
    up = _shift_clamp(I, -1, -2)
    down = _shift_clamp(I, 1, -2)
    rows = (up, I, down)
    out = jnp.zeros_like(I)
    for l in range(3):
        row = rows[l]
        out = out + mask[l, 0] * _shift_clamp(row, -1, -1)
        out = out + mask[l, 1] * row
        out = out + mask[l, 2] * _shift_clamp(row, 1, -1)
    return out


def dxx(I):
    """Second x-derivative, [1 -2 1] horizontal (reference src/operators.cpp:263-280)."""
    return _shift_clamp(I, -1, -1) - 2.0 * I + _shift_clamp(I, 1, -1)


def dyy(I):
    """Second y-derivative, [1 -2 1] vertical (reference src/operators.cpp:283-304)."""
    return _shift_clamp(I, -1, -2) - 2.0 * I + _shift_clamp(I, 1, -2)


def dxy(I):
    """Mixed second derivative via the 4-point diagonal mask
    (reference src/operators.cpp:307-328)."""
    ul = _shift_clamp(_shift_clamp(I, -1, -2), -1, -1)
    ur = _shift_clamp(_shift_clamp(I, -1, -2), 1, -1)
    dl = _shift_clamp(_shift_clamp(I, 1, -2), -1, -1)
    dr = _shift_clamp(_shift_clamp(I, 1, -2), 1, -1)
    return 0.25 * (ul - ur - dl + dr)
