"""Frame-axis (sequence) sharding for the Brox temporal solver.

The reference couples each flow field only to its two frame neighbors
(psi5/psi6 terms, src/brox_temporal_mask.cpp:108-133), so the flow
volume shards cleanly over a "t" mesh axis with a ONE-FIELD halo
exchanged per SOR half-sweep — a ring `lax.ppermute` between devices, the same
communication shape as ring attention but carrying a stencil slab
(SURVEY.md §5.7).  Memory per device drops from O(T·H·W) to O(T/n·H·W),
which is the reference's scaling limit
(src/brox_optic_flow_temporal.cpp:305-340).

All math is the models.brox_temporal code with frame shifts routed
through the halo exchange; results on an n-device mesh match the
single-device solver to float tolerance (tests use the 8-device CPU
mesh).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from tpuflow.models.brox_spatial import (
    EPSILON,
    SOR_OMEGA,
    psi_divergence,
    psi_weighted_divergence,
)
from tpuflow.models.brox_temporal import DEFAULT_ALPHA, DEFAULT_GAMMA, DEFAULT_INNER, DEFAULT_OUTER, DEFAULT_TOL
from tpuflow.ops import centered_gradient, dxx, dxy, dyy, warp_planes
from tpuflow.ops.gradients import _shift_clamp
from tpuflow.parallel.halo import exchange_1d


def _frame_shifts(f, axis_name, axis_size, first=None, last=None):
    """(f[t-1], f[t+1]) with edge clamp at the global sequence ends,
    interior neighbors over the ring.

    `first`/`last` are (tl, 1, 1) masks of the global sequence ends by
    GLOBAL field index.  They matter when the field axis is padded up to
    a multiple of the mesh axis (uneven T): the clamp must happen at the
    last REAL field, not at the ring end, so real fields never read
    padded neighbors."""
    padded = exchange_1d(f, 1, axis_name, axis_size, fill="edge", axis=0)
    prev, nxt = padded[:-2], padded[2:]
    if first is not None:
        prev = jnp.where(first, f, prev)
    if last is not None:
        nxt = jnp.where(last, f, nxt)
    return prev, nxt


def brox_temporal_scale_sharded(I, u, v, axis_name, axis_size,
                                alpha=DEFAULT_ALPHA, gamma=DEFAULT_GAMMA,
                                tol=DEFAULT_TOL, inner_iter=DEFAULT_INNER,
                                outer_iter=DEFAULT_OUTER, maxiter=300,
                                total_fields=None, stop="error"):
    """models.brox_temporal.brox_temporal_scale with the frame axis
    sharded over `axis_name`.  Runs inside shard_map.

    I: local (Tl+1, H, W) frame slab INCLUDING one lookahead frame (the
    first frame of the next shard; the last shard duplicates its final
    frame, unused).  u, v: local (Tl, H, W) flow fields.
    """
    tl, ny, nx = u.shape
    nz_total = total_fields if total_fields is not None else axis_size * tl
    size1 = nz_total * ny * nx
    eps2 = EPSILON * EPSILON
    w = SOR_OMEGA

    t_idx = lax.axis_index(axis_name)
    g_idx = (t_idx * tl
             + lax.broadcasted_iota(jnp.int32, (tl, 1, 1), 0))
    first = g_idx == 0
    last = g_idx == nz_total - 1
    valid = g_idx < nz_total  # False on fields padded for uneven T

    ii = lax.broadcasted_iota(jnp.int32, (tl, ny, nx), 1)
    jj = lax.broadcasted_iota(jnp.int32, (tl, ny, nx), 2)
    gf = t_idx * tl + lax.broadcasted_iota(jnp.int32, (tl, ny, nx), 0)
    colors = (((gf + ii + jj) % 2 == 0) & valid,
              ((gf + ii + jj) % 2 == 1) & valid)

    Ix, Iy = centered_gradient(I)
    I0, Ix0, Iy0 = I[:tl], Ix[:tl], Iy[:tl]
    tail = I[1:]
    planes = jnp.stack([tail, Ix[1:], Iy[1:], dxx(tail), dxy(tail), dyy(tail)])

    def grad3(f):
        fx = 0.5 * (_shift_clamp(f, 1, -1) - _shift_clamp(f, -1, -1))
        fy = 0.5 * (_shift_clamp(f, 1, -2) - _shift_clamp(f, -1, -2))
        prev, nxt = _frame_shifts(f, axis_name, axis_size, first, last)
        ft = 0.5 * (nxt - prev)
        return fx, fy, ft

    def div6(f, psis6):
        psi1, psi2, psi3, psi4, psi5, psi6 = psis6
        prev, nxt = _frame_shifts(f, axis_name, axis_size)
        return (psi1 * _shift_clamp(f, 1, -2) + psi2 * _shift_clamp(f, -1, -2)
                + psi3 * _shift_clamp(f, 1, -1) + psi4 * _shift_clamp(f, -1, -1)
                + psi5 * prev + psi6 * nxt)

    def outer_body(_, uv):
        u, v = uv
        warped = jax.vmap(
            lambda p, uu, vv: warp_planes(p, uu, vv, border_out=True),
            in_axes=(1, 0, 0))(planes, u, v)
        Iw, Iwx, Iwy, Iwxx, Iwxy, Iwyy = jnp.moveaxis(warped, 1, 0)

        ux, uy, ut = grad3(u)
        vx, vy, vt = grad3(v)
        psis = 1.0 / jnp.sqrt(ux * ux + uy * uy + ut * ut
                              + vx * vx + vy * vy + vt * vt + eps2)
        psi1, psi2, psi3, psi4 = psi_divergence(psis)
        ps_prev, ps_next = _frame_shifts(psis, axis_name, axis_size)
        psi5 = jnp.where(first, 0.0, 0.5 * (ps_prev + psis))
        psi6 = jnp.where(last, 0.0, 0.5 * (ps_next + psis))
        psis6 = (psi1, psi2, psi3, psi4, psi5, psi6)

        u_prev, u_next = _frame_shifts(u, axis_name, axis_size)
        v_prev, v_next = _frame_shifts(v, axis_name, axis_size)
        div_u = (psi_weighted_divergence(u, psi1, psi2, psi3, psi4)
                 + psi5 * (u_prev - u) + psi6 * (u_next - u))
        div_v = (psi_weighted_divergence(v, psi1, psi2, psi3, psi4)
                 + psi5 * (v_prev - v) + psi6 * (v_next - v))
        div_d = alpha * (psi1 + psi2 + psi3 + psi4 + psi5 + psi6)

        du = jnp.zeros_like(u)
        dv = jnp.zeros_like(v)

        def inner_body(_, dudv):
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
                    # one-field ring halo per half-sweep (the sequence-
                    # parallel communication step)
                    div_du = div6(du, psis6)
                    du_c = (1.0 - w) * du + w * (Au - D * dv + alpha * div_du) / Du
                    du_n = jnp.where(mask, du_c, du)
                    div_dv = div6(dv, psis6)
                    dv_c = (1.0 - w) * dv + w * (Av - D * du_n + alpha * div_dv) / Dv
                    dv_n = jnp.where(mask, dv_c, dv)
                    err = err + jnp.sum((du_n - du) ** 2 + (dv_n - dv) ** 2)
                    du, dv = du_n, dv_n
                return du, dv, lax.psum(err, axis_name)

            if stop == "error":
                def cond(c):
                    return (c[2] > tol) & (c[3] < maxiter)

                def body(c):
                    du, dv, _, n = c
                    du, dv, err = sweep(du, dv)
                    return du, dv, jnp.sqrt(err / size1), n + 1

                init = (du, dv, jnp.asarray(1000.0, du.dtype),
                        jnp.asarray(0, jnp.int32))
                du, dv, _, _ = lax.while_loop(cond, body, init)
            else:
                def body(_, c):
                    du, dv = c
                    du, dv, _ = sweep(du, dv)
                    return du, dv

                du, dv = lax.fori_loop(0, maxiter, body, (du, dv))
            return du, dv

        du, dv = lax.fori_loop(0, inner_iter, inner_body, (du, dv))
        return u + du, v + dv

    return lax.fori_loop(0, outer_iter, outer_body, (u, v))


def brox_temporal_sharded(I, mesh, axis_name="t", u0=None, v0=None, **kw):
    """Single-scale temporal Brox with the frame axis sharded over
    `mesh[axis_name]`.  I: (T, H, W), any T >= 3.  Returns (T-1, H, W)
    u, v (replicated gather at the end).  `u0`/`v0` optionally seed the
    flow fields (the coarse-to-fine wrapper passes the upsampled
    coarser-level flow); default zeros.

    When (T-1) is not divisible by the axis size, the field axis is
    padded with copies of the last frame; padded fields are frozen at
    zero inside the solver (their color masks are AND-ed with the
    global-index validity mask) and real fields clamp their temporal
    neighbors by GLOBAL index, so results are identical to the even
    case — the padding costs compute on the last shard only.
    """
    frames, ny, nx = I.shape
    nz = frames - 1
    axis_size = mesh.shape[axis_name]
    tl = -(-nz // axis_size)
    pad_frames = tl * axis_size + 1 - frames
    if pad_frames:
        I = jnp.concatenate([I, jnp.repeat(I[-1:], pad_frames, axis=0)])

    # local slabs: fields [k*tl, (k+1)*tl), frames [k*tl, (k+1)*tl + 1)
    # = the sharded frame volume plus a one-frame lookahead
    slabs = jnp.stack([I[k * tl:(k + 1) * tl + 1]
                       for k in range(axis_size)])  # (n, tl+1, H, W)

    def flow_slabs(f):
        if f is None:
            return jnp.zeros((axis_size, tl, ny, nx), dtype=I.dtype)
        pad = tl * axis_size - nz
        if pad:
            f = jnp.concatenate([f, jnp.zeros((pad, ny, nx), dtype=f.dtype)])
        return f.reshape(axis_size, tl, ny, nx)

    spec = P(axis_name, None, None, None)

    def local(slab, u, v):
        return brox_temporal_scale_sharded(
            slab[0], u[0], v[0], axis_name, axis_size,
            total_fields=nz, **kw)

    fn = jax.shard_map(
        lambda s, u, v: tuple(x[None] for x in local(s, u, v)),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=(spec, spec))
    sharding = NamedSharding(mesh, spec)
    args = [jax.device_put(x, sharding)
            for x in (slabs, flow_slabs(u0), flow_slabs(v0))]
    u, v = jax.jit(fn)(*args)
    return (u.reshape(tl * axis_size, ny, nx)[:nz],
            v.reshape(tl * axis_size, ny, nx)[:nz])


def brox_temporal_multiscale_sharded(I, mesh, axis_name="t",
                                     alpha=DEFAULT_ALPHA,
                                     gamma=DEFAULT_GAMMA, nscales=100,
                                     zfactor=0.75, tol=DEFAULT_TOL,
                                     inner_iter=DEFAULT_INNER,
                                     outer_iter=DEFAULT_OUTER,
                                     maxiter=300, stop="error",
                                     clamp_scales=True):
    """MULTISCALE frame-axis-sharded Brox temporal flow: the same
    coarse-to-fine pyramid as models.brox_temporal.brox_temporal
    (reference src/brox_optic_flow_temporal.cpp:566-601) with every
    scale solved by the ring-halo sharded solver.  Pyramid construction
    and the between-level flow upsample are per-frame ops with no
    temporal coupling, so they run on the replicated volume (cheap next
    to the SOR sweeps).  Returns (T-1, H, W) u, v."""
    from tpuflow.models.brox_temporal import PRESMOOTH_SIGMA
    from tpuflow.models.common import run_pyramid_state
    from tpuflow.ops import clamp_nscales, gaussian

    frames, ny, nx = I.shape
    if frames <= 2:
        raise ValueError("The method needs more than two frames "
                         "(src/brox_optic_flow_temporal.cpp:537)")
    if clamp_scales:
        nscales = clamp_nscales(nx, ny, zfactor, nscales, use_hypot=False)

    def preprocess(images):
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

    def solve(level_images, state, scale):
        u, v = brox_temporal_sharded(
            level_images[0], mesh, axis_name, u0=state["u1"],
            v0=state["u2"], alpha=alpha, gamma=gamma, tol=tol,
            inner_iter=inner_iter, outer_iter=outer_iter, maxiter=maxiter,
            stop=stop)
        return {"u1": u, "u2": v}

    state = run_pyramid_state(
        (I,), nscales, zfactor, solve,
        presmooth=None, preprocess=preprocess, state_init=state_init,
        trace_name="brox_temporal_sharded")
    return state["u1"], state["u2"]
