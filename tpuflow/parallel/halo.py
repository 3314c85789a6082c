"""Halo exchange for spatially-tiled stencil computation.

Runs inside `jax.shard_map`: each device holds one (h, w) tile of the
global image; `exchange_1d/2d` pads the tile with `halo` cells fetched
from ring neighbors via `lax.ppermute` (nearest-neighbor shifts, which
XLA lowers to point-to-point collectives between devices), while tiles at the global boundary fill their
outward halo according to the op's boundary condition:

  * "edge"     — replicate the boundary cell (Neumann clamp; matches
                 `_shift_clamp`-based stencils and forward_gradient's
                 zero-at-last-column once differenced)
  * "zero"     — zeros (for backward-difference divergence, whose
                 Chambolle boundary rule becomes plain differencing of
                 a pre-masked field; see tiled.divergence_tiled)
  * "gaussian" — the reference Gaussian's asymmetric reflecting pad:
                 mirror WITHOUT the edge cell on the leading side,
                 mirror WITH the edge cell on the trailing side
                 (reference src/operators.cpp:557-561)
  * "symmetric"— mirror with edge on both sides (median filter,
                 me_sepconvol; reference src/utils.cpp:79-87,178-192)

After padding, the ordinary full-image ops from `tpuflow.ops` run on
the padded tile and the result is cropped: boundary-special cases land
in the cropped halo region, interior cells see true neighbor data, and
global-boundary cells see exactly the pad the full-image op would have
synthesized — so tiled results are bitwise-identical to single-device
results (asserted by tests on an 8-device CPU mesh).
"""

import jax
import jax.numpy as jnp
from jax import lax


def _take(a, sl, axis):
    idx = [slice(None)] * a.ndim
    idx[axis] = sl
    return a[tuple(idx)]


def _fill(block, halo, axis, mode, side):
    """Boundary fill for a tile at the global edge. `side` is 'lead'
    (low-index side) or 'trail' (high-index side)."""
    if mode == "zero":
        shape = list(block.shape)
        shape[axis] = halo
        return jnp.zeros(shape, dtype=block.dtype)
    if mode == "edge":
        cell = _take(block, slice(0, 1) if side == "lead" else slice(-1, None), axis)
        reps = [1] * block.ndim
        reps[axis] = halo
        return jnp.tile(cell, reps)
    if mode in ("gaussian", "symmetric"):
        if side == "lead":
            if mode == "gaussian":
                # indices halo, halo-1, ..., 1  (mirror, no edge repeat)
                strip = _take(block, slice(1, halo + 1), axis)
            else:
                # indices halo-1, ..., 0  (mirror with edge repeat)
                strip = _take(block, slice(0, halo), axis)
            return jnp.flip(strip, axis=axis)
        strip = _take(block, slice(-halo, None), axis)
        return jnp.flip(strip, axis=axis)
    raise ValueError(f"unknown fill mode {mode!r}")


def exchange_1d(block, halo, axis_name, axis_size, fill="edge", axis=-1):
    """Pad `block` with `halo` cells on both sides of `axis`, sourcing
    interior halos from ring neighbors over mesh axis `axis_name` and
    boundary halos from `fill`.  Must be called inside shard_map."""
    if axis_size == 1:
        lead = _fill(block, halo, axis, fill, "lead")
        trail = _fill(block, halo, axis, fill, "trail")
        return jnp.concatenate([lead, block, trail], axis=axis)

    idx = lax.axis_index(axis_name)
    # strip I send rightward becomes my right neighbor's lead halo
    send_fwd = _take(block, slice(-halo, None), axis)
    send_bwd = _take(block, slice(None, halo), axis)
    from_prev = lax.ppermute(send_fwd, axis_name,
                             [(i, i + 1) for i in range(axis_size - 1)])
    from_next = lax.ppermute(send_bwd, axis_name,
                             [(i + 1, i) for i in range(axis_size - 1)])
    lead_fill = _fill(block, halo, axis, fill, "lead")
    trail_fill = _fill(block, halo, axis, fill, "trail")
    lead = jnp.where(idx == 0, lead_fill, from_prev)
    trail = jnp.where(idx == axis_size - 1, trail_fill, from_next)
    return jnp.concatenate([lead, block, trail], axis=axis)


def exchange_2d(block, halo, x_axis_name, x_size, y_axis_name, y_size,
                fill="edge"):
    """2D halo pad: exchange along x (last axis) then y (second-to-last).

    The y pass runs on the already-x-padded block, so corner halos are
    correctly sourced from the diagonal neighbor via two hops.
    """
    padded = exchange_1d(block, halo, x_axis_name, x_size, fill, axis=-1)
    return exchange_1d(padded, halo, y_axis_name, y_size, fill, axis=-2)


def crop(padded, halo, axes=(-2, -1)):
    """Remove `halo` cells from both ends of each axis in `axes`."""
    idx = [slice(None)] * padded.ndim
    for ax in axes:
        idx[ax] = slice(halo, -halo)
    return padded[tuple(idx)]
