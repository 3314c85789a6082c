"""Batched solvers — the throughput path.

The reference processes one frame pair per process (OpenMP threads
inside one pair); here the throughput axis is BATCH: many pairs per
device, data-parallel across devices (SURVEY.md §2 parallelism table).

Two stopping modes share ONE compiled program per batch geometry:
  * stop="error" — the reference CLI's operating point: per-sample
    data-dependent stopping (src/tvl1flow.cpp:113,150-162;
    src/horn_schunck_pyramidal.cpp:143,230): a sample whose update
    falls below the threshold is frozen while the others iterate, so
    each sample stops at exactly its own iteration.
  * stop="fixed" — a fixed per-warp iteration schedule calibrated as an
    upper envelope of the reference's observed stopping iterations.
Mode differences (stopping threshold, per-warp iteration caps) are
RUNTIME scalars threaded through the jit, so switching modes never
recompiles.

Each warp is the exact bicubic gather (`warp_planes`, the reference's
border_out warp) vmapped over the batch, followed by the inner fixed
point as a lax.while_loop; the warp loop is a lax loop, so each level
appears once in the program.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tpuflow.models.tvl1 import _inner_step
from tpuflow.ops import centered_gradient, clamp_nscales, warp_planes

# per-warp inner-iteration schedule: upper envelope of the reference's
# observed data-dependent stopping at default params (epsilon=0.01);
# used when the caller pins one schedule for every level
DEFAULT_ITER_SCHEDULE = (30, 20, 10, 6, 6)


def tvl1_iter_schedule(ny, nx):
    """Per-warp iteration schedule for stop="fixed", calibrated as a
    1.3x envelope of the reference binary's observed data-dependent
    stopping iterations at default params (tau=.25 lambda=.15 theta=.3
    nwarps=5 epsilon=.01) over bench-geometry pairs — raw data in
    tools/tvl1_calibration.json (tools/calibrate_tvl1.py).  Like the HS
    analog (hs_sweep_schedule), convergence tracks the LEVEL SIZE:
    coarse levels iterate longest (their stopping threshold
    epsilon^2*size is smallest) and fine levels collapse after the
    first warp."""
    px = ny * nx
    if px <= 32 * 64:
        return (30, 20, 10, 8, 8)
    if px <= 55 * 128:
        return (30, 16, 8, 6, 8)
    if px <= 109 * 256:
        return (16, 7, 4, 4, 4)
    if px <= 218 * 512:
        return (8, 3, 3, 3, 3)
    return (20, 3, 6, 3, 3)


def _normalize_pair_batched(I0, I1):
    """Joint [0,255] normalization per batch sample
    (image_normalization_2 semantics, reference src/utils.cpp:283-326,
    applied per sample)."""
    mn = jnp.minimum(jnp.min(I0, axis=(-2, -1), keepdims=True),
                     jnp.min(I1, axis=(-2, -1), keepdims=True))
    mx = jnp.maximum(jnp.max(I0, axis=(-2, -1), keepdims=True),
                     jnp.max(I1, axis=(-2, -1), keepdims=True))
    den = mx - mn
    ok = den > 0
    den = jnp.where(ok, den, 1.0)
    return (jnp.where(ok, 255.0 * (I0 - mn) / den, I0),
            jnp.where(ok, 255.0 * (I1 - mn) / den, I1))


def _warp3(I1, I1x, I1y, u1, u2):
    """Batched 3-plane exact warp: (B, H, W) images and flows."""
    planes = jnp.stack([I1, I1x, I1y], axis=1)  # (B, 3, H, W)
    w = jax.vmap(lambda p, a, b: warp_planes(p, a, b, border_out=True))(
        planes, u1, u2)
    return w[:, 0], w[:, 1], w[:, 2]


def tvl1_scale_batched(I0, I1, u1, u2, tau, lam, theta, thresh, caps,
                       ee=None):
    """Batched single-scale TV-L1.

    `thresh` (runtime scalar) is the reference's stopping threshold
    epsilon^2 * size (src/tvl1flow.cpp:113,150-162); thresh < 0
    disables stopping so each warp runs exactly its cap.  `caps` is a
    (warps,) int32 array of per-warp iteration caps.

    `ee` (runtime int32 scalar, default 2) is the warp-level early-exit
    iteration threshold: when stopping is enabled and every sample's
    inner fixed point converged within `ee` iterations, the remaining
    warps are skipped — the reference's own operating data
    (tools/tvl1_calibration.json) shows warps 2-5 converging in 1-2
    iterations at every level size.  The skipped relinearizations are
    a parity-budget-level deviation, not a bitwise no-op: EPE vs the
    full schedule is ~0.017 on adversarial constant-shift synthetics
    and ~0.007 end-to-end vs the reference binary on smooth content
    (budget: 0.05).  ee <= 0 disables the exit (strictly
    reference-faithful warp count).

    Returns (u1, u2)."""
    l_t = lam * theta
    taut = tau / theta
    warps = caps.shape[0]
    I1x, I1y = centered_gradient(I1)
    zero = jnp.zeros_like(u1)
    state = jnp.stack([u1, u2, zero, zero, zero, zero], axis=1)
    B = I0.shape[0]
    if ee is None:
        ee = jnp.asarray(2, jnp.int32)

    def warp_cond(c):
        return (c[1] < warps) & jnp.logical_not(c[2])

    def warp_body(c):
        state, wi, _ = c
        u1, u2 = state[:, 0], state[:, 1]
        I1w, I1wx, I1wy = _warp3(I1, I1x, I1y, u1, u2)
        grad = I1wx * I1wx + I1wy * I1wy
        rho_c = I1w - I1wx * u1 - I1wy * u2 - I0

        def cond(c):
            return jnp.any(c[1] > thresh) & (c[2] < caps[wi])

        def body(c):
            state, err, n = c
            parts = _inner_step(*(state[:, k] for k in range(6)),
                                I1wx, I1wy, rho_c, grad, l_t, theta,
                                taut)
            new_state = jnp.stack(parts[:6], axis=1)
            new_err = jnp.sum(
                (new_state[:, 0] - state[:, 0]) ** 2
                + (new_state[:, 1] - state[:, 1]) ** 2, axis=(-2, -1))
            active = err > thresh
            state = jnp.where(active[:, None, None, None], new_state,
                              state)
            err = jnp.where(active, new_err, err)
            return state, err, n + 1

        init = (state, jnp.full((B,), jnp.inf, dtype=I0.dtype),
                jnp.asarray(0, jnp.int32))
        state, _, n = jax.lax.while_loop(cond, body, init)
        done = (n <= ee) & (thresh > 0) & (ee > 0)
        return state, wi + 1, done

    state, _, _ = jax.lax.while_loop(
        warp_cond, warp_body,
        (state, jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return state[:, 0], state[:, 1]


def _tvl1_pyramid(I0, I1, tau, lam, theta, nscales, zfactor, thresh_base,
                  caps_all, ee, level_callback=None, resume=None):
    """Shared batched TV-L1 pyramid over run_pyramid_state (SURVEY §5.4:
    one driver = uniform checkpoint/resume/trace hooks).

    thresh_base: runtime scalar — epsilon^2 (error mode) or -1 (fixed);
    per level thresh = thresh_base * level_size.
    caps_all: (nscales, warps) runtime int32 per-warp iteration caps."""
    from tpuflow.models.common import run_pyramid_state

    B, ny, nx = I0.shape

    def state_init(size, dtype):
        cnx, cny = size
        z = jnp.zeros((B, cny, cnx), dtype=dtype)
        return {"u1": z, "u2": z}

    def solve(level_images, state, scale):
        l0, l1 = level_images
        cny, cnx = l0.shape[-2:]
        thresh = thresh_base * (cny * cnx)
        u1, u2 = tvl1_scale_batched(l0, l1, state["u1"], state["u2"],
                                    tau=tau, lam=lam, theta=theta,
                                    thresh=thresh, caps=caps_all[scale],
                                    ee=ee)
        return {"u1": u1, "u2": u2}

    state = run_pyramid_state(
        (I0, I1), nscales, zfactor, solve, presmooth=0.8,
        preprocess=lambda ims: _normalize_pair_batched(*ims),
        state_init=state_init, level_callback=level_callback,
        resume=resume, trace_name="tvl1_batched")
    return state["u1"], state["u2"]


@partial(jax.jit, static_argnames=("tau", "lam", "theta", "nscales",
                                   "zfactor"))
def _tvl1_batched_jit(I0, I1, tau, lam, theta, nscales, zfactor,
                      thresh_base, caps_all, ee):
    return _tvl1_pyramid(I0, I1, tau, lam, theta, nscales, zfactor,
                         thresh_base, caps_all, ee)


def _tvl1_mode_scalars(stop, epsilon, max_iterations, iter_schedule,
                       warps, nscales, zfactor, ny, nx, dtype):
    """Map a stopping mode onto the two runtime values that distinguish
    it — the whole point being that BOTH modes share one compiled
    program (the scalars ride through the jit as inputs)."""
    if stop == "error":
        thresh_base = jnp.asarray(epsilon * epsilon, dtype)
        caps = jnp.full((nscales, warps), max_iterations, jnp.int32)
    elif stop == "fixed":
        from tpuflow.ops.pyramid import zoom_size

        thresh_base = jnp.asarray(-1.0, dtype)
        if iter_schedule is None:
            # calibrated per-level schedule (tvl1_iter_schedule)
            rows = []
            cnx, cny = nx, ny
            for _ in range(nscales):
                sched = tvl1_iter_schedule(cny, cnx)
                rows.append(sched[:warps]
                            + sched[-1:] * max(0, warps - len(sched)))
                cnx, cny = zoom_size(cnx, cny, zfactor)
            caps = jnp.asarray(rows, jnp.int32)
        else:
            caps = jnp.broadcast_to(
                jnp.asarray(iter_schedule, jnp.int32)[None, :],
                (nscales, len(iter_schedule))).copy()
    else:
        raise ValueError(f"unknown stop mode {stop!r}")
    return thresh_base, caps


def tvl1_batched(I0, I1, tau=0.25, lam=0.15, theta=0.3, nscales=None,
                 zfactor=0.5, iter_schedule=None, stop="error", warps=5,
                 epsilon=0.01, max_iterations=300, level_callback=None,
                 resume=None, warp_early_exit=True):
    """Batched multiscale TV-L1: (B, H, W) pairs -> (B, H, W) flows.

    One jit covers the whole pyramid (static level shapes), so a call is
    a single device program — no host sync between levels.

    stop="error" (default) reproduces the reference CLI's operating
    point: per-sample data-dependent stopping at epsilon, exact to the
    iteration.
    stop="fixed" runs a fixed per-warp iteration budget: the calibrated
    per-level-size schedule (`tvl1_iter_schedule`,
    tools/tvl1_calibration.json) by default, or `iter_schedule`
    verbatim for every level if given.  Both modes share one compiled
    program per batch geometry (the budgets are runtime inputs).

    `level_callback(scale, state)` / `resume=(scale, state)` enable
    per-level checkpointing; that path runs the pyramid level-by-level
    on the host (each level's solve still compiled) so flows are
    materialized between levels.

    DELIBERATE DEVIATION (default on): in stop="error" mode a
    level's warp loop exits early once every sample's inner fixed point
    converges within 2 iterations, whereas the reference always runs
    all `warps` warps (src/tvl1flow.cpp:92).  At the reference's own
    operating points warps 2-5 converge in 1-2 iterations at every
    level (tools/tvl1_calibration.json); skipping them is a
    parity-budget-level deviation (EPE ~0.007-0.017 vs the full
    schedule, budget 0.05 — tests/test_batch.py
    test_warp_early_exit_equivalence).  Pass
    `warp_early_exit=False` for the strictly reference-faithful
    schedule — a runtime scalar, so toggling never recompiles.
    """
    ny, nx = I0.shape[-2:]
    if nscales is None:
        nscales = clamp_nscales(nx, ny, zfactor, 100, use_hypot=True)
    if stop == "fixed" and iter_schedule is not None:
        warps = len(iter_schedule)
    thresh_base, caps_all = _tvl1_mode_scalars(
        stop, epsilon, max_iterations, iter_schedule, warps, nscales,
        zfactor, ny, nx,
        I0.dtype if hasattr(I0, "dtype") else jnp.float32)
    ee = jnp.asarray(2 if warp_early_exit else 0, jnp.int32)
    if level_callback is None and resume is None:
        return _tvl1_batched_jit(I0, I1, tau, lam, theta, nscales, zfactor,
                                 thresh_base, caps_all, ee)
    return _tvl1_pyramid(I0, I1, tau, lam, theta, nscales, zfactor,
                         thresh_base, caps_all, ee,
                         level_callback=level_callback, resume=resume)


def hs_sweep_schedule(ny, nx):
    """Per-warp sweep schedule for stop="fixed", calibrated as a ~1.3x
    envelope of the reference binary's observed per-warp stopping
    sweeps at default parameters (tol=1e-4, alpha=7, 10 warps) over
    bench-geometry pairs — raw data in tools/hs_calibration.json.
    Convergence counts track the LEVEL SIZE (the stopping threshold is
    tol^2 * size, so small levels need more sweeps); fine levels
    collapse after the first warp."""
    px = ny * nx
    if px <= 64 * 128:       # coarse levels (<= 55x128): nearly free
        return (104, 104, 96, 88, 80, 80, 80, 76, 76, 76)
    if px <= 109 * 256:
        return (96, 78, 60, 46, 35, 25, 16, 10, 7, 6)
    if px <= 218 * 512:
        return (80, 40, 11, 5, 3, 2, 3, 2, 2, 6)
    return (73, 12, 6, 4, 4, 3, 3, 4, 4, 4)


def hs_scale_batched(I1, I2, u, v, alpha, thresh, caps, ee=None):
    """Batched single-scale warping Horn-Schunck.

    `thresh` (runtime scalar) = TOL^2 * size
    (src/horn_schunck_pyramidal.cpp:143,230); thresh < 0 disables the
    stop so each warp runs exactly its cap.  `caps` is a (warps,) int32
    array of per-warp sweep caps.  `ee` (runtime int32 scalar, default
    2) is the warp-level early-exit sweep threshold: when stopping is
    enabled the warp loop exits once a warp's SOR converges within
    `ee` sweeps for every sample — the reference's own operating data
    (tools/hs_calibration.json) shows late warps converging in 1-4
    sweeps, at which point the remaining warps are numerical no-ops.
    ee <= 0 disables the exit (strictly reference-faithful: all warps
    always run).

    Returns (u, v).  Reference per-warp system constants:
    src/horn_schunck_pyramidal.cpp:128-137."""
    from tpuflow.models.hs_pyramidal import _four_colors, _sor_sweep

    alpha2 = alpha * alpha
    warps = caps.shape[0]
    I2x, I2y = centered_gradient(I2)
    B = I1.shape[0]
    if ee is None:
        ee = jnp.asarray(2, jnp.int32)

    colors = _four_colors(I1.shape[-2:])

    def warp_cond(c):
        return (c[2] < warps) & jnp.logical_not(c[3])

    def warp_body(c):
        u, v, wi, _ = c
        I2w, I2wx, I2wy = _warp3(I2, I2x, I2y, u, v)
        dif = I1 - I2w + I2wx * u + I2wy * v
        Au = dif * I2wx
        Av = dif * I2wy
        Du = I2wx * I2wx + alpha2
        Dv = I2wy * I2wy + alpha2
        D = I2wx * I2wy

        def cond(c):
            return jnp.any(c[2] > thresh) & (c[3] < caps[wi])

        def body(c):
            u, v, err, n = c
            u_n, v_n, errs = _sor_sweep(u, v, Au, Av, Du, Dv, D, alpha2,
                                        colors)
            # per-sample sum (the shared helper returns a global sum
            # for unbatched use; recompute per sample)
            new_err = jnp.sum((u_n - u) ** 2 + (v_n - v) ** 2,
                              axis=(-2, -1))
            active = err > thresh
            u = jnp.where(active[:, None, None], u_n, u)
            v = jnp.where(active[:, None, None], v_n, v)
            err = jnp.where(active, new_err, err)
            return u, v, err, n + 1

        init = (u, v, jnp.full((B,), jnp.inf, dtype=I1.dtype),
                jnp.asarray(0, jnp.int32))
        u, v, _, n = jax.lax.while_loop(cond, body, init)
        done = (n <= ee) & (thresh > 0) & (ee > 0)
        return u, v, wi + 1, done

    u, v, _, _ = jax.lax.while_loop(
        warp_cond, warp_body,
        (u, v, jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return u, v


def _hs_pyramid(I1, I2, alpha, nscales, zfactor, thresh_base, caps_all, ee,
                level_callback=None, resume=None):
    from tpuflow.models.common import run_pyramid_state

    B, ny, nx = I1.shape

    def state_init(size, dtype):
        cnx, cny = size
        z = jnp.zeros((B, cny, cnx), dtype=dtype)
        return {"u1": z, "u2": z}

    def solve(level_images, state, scale):
        l1, l2 = level_images
        cny, cnx = l1.shape[-2:]
        thresh = thresh_base * (cny * cnx)
        u, v = hs_scale_batched(l1, l2, state["u1"], state["u2"],
                                alpha=alpha, thresh=thresh,
                                caps=caps_all[scale], ee=ee)
        return {"u1": u, "u2": v}

    state = run_pyramid_state(
        (I1, I2), nscales, zfactor, solve, presmooth=0.8,
        preprocess=lambda ims: _normalize_pair_batched(*ims),
        state_init=state_init, level_callback=level_callback,
        resume=resume, trace_name="hs_batched")
    return state["u1"], state["u2"]


@partial(jax.jit, static_argnames=("alpha", "nscales", "zfactor"))
def _hs_batched_jit(I1, I2, alpha, nscales, zfactor, thresh_base, caps_all,
                    ee):
    return _hs_pyramid(I1, I2, alpha, nscales, zfactor, thresh_base,
                       caps_all, ee)


def _hs_mode_scalars(stop, tol, maxiter, warps, nscales, zfactor, ny, nx,
                     dtype):
    if stop == "error":
        thresh_base = jnp.asarray(tol * tol, dtype)
        caps = jnp.full((nscales, warps), maxiter, jnp.int32)
    elif stop == "fixed":
        thresh_base = jnp.asarray(-1.0, dtype)
        rows = []
        from tpuflow.ops.pyramid import zoom_size
        cnx, cny = nx, ny
        for s in range(nscales):
            sched = hs_sweep_schedule(cny, cnx)
            rows.append(sched[:warps] + sched[-1:] * max(0, warps
                                                         - len(sched)))
            cnx, cny = zoom_size(cnx, cny, zfactor)
        caps = jnp.asarray(rows, jnp.int32)
    else:
        raise ValueError(f"unknown stop mode {stop!r}")
    return thresh_base, caps


def hs_pyramidal_batched(I1, I2, alpha=7.0, nscales=None, zfactor=0.5,
                         warps=10, tol=1e-4, maxiter=150, stop="error",
                         level_callback=None, resume=None,
                         warp_early_exit=True):
    """Batched multiscale warping Horn-Schunck: (B, H, W) -> (B, H, W).

    The second throughput config of BASELINE.md (reference
    src/horn_schunck_pyramidal.cpp).  Same pyramid/driver design,
    checkpoint hooks, and one-program-for-both-modes stopping design as
    `tvl1_batched`.

    DELIBERATE DEVIATION (default on): in stop="error" mode the warp
    loop exits early once a warp's SOR converges within 2 sweeps for
    every sample, whereas the reference always runs all `warps` warps
    (src/horn_schunck_pyramidal.cpp:111-240).  The remaining warps are
    numerical no-ops at the reference's operating points
    (EPE-validated; tools/hs_calibration.json shows late warps
    converging in 1-4 sweeps).  Pass `warp_early_exit=False` for the
    strictly reference-faithful schedule — it is a runtime scalar, so
    toggling never recompiles."""
    ny, nx = I1.shape[-2:]
    if nscales is None:
        nscales = clamp_nscales(nx, ny, zfactor, 10, use_hypot=True)
    thresh_base, caps_all = _hs_mode_scalars(
        stop, tol, maxiter, warps, nscales, zfactor, ny, nx,
        I1.dtype if hasattr(I1, "dtype") else jnp.float32)
    ee = jnp.asarray(2 if warp_early_exit else 0, jnp.int32)
    if level_callback is None and resume is None:
        return _hs_batched_jit(I1, I2, alpha, nscales, zfactor, thresh_base,
                               caps_all, ee)
    return _hs_pyramid(I1, I2, alpha, nscales, zfactor, thresh_base,
                       caps_all, ee, level_callback=level_callback,
                       resume=resume)
