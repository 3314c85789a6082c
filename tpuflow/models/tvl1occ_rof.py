"""Staggered-grid box relaxation for the scalar ROF problem.

Reference: Scalar_ROF_BoxCellCentered
(src/tvl1occflow_tv_rof_box.cpp:22-644), the dual-ROF solver of
Garamendi et al. 2013 ("Box Relaxation Schemes in Staggered
Discretizations for the Dual Formulation of Total Variation
Minimization"), used by tvl1occflow's Solver_wrt_u.

Math of the reference, reverse-engineered and verified numerically:
each image cell owns four dual unknowns p on its edges (edges are
SHARED with the neighbor cells; boundary edges are fixed at 0).  One
sweep visits every cell and relaxes the cell's 4x4 linear system

    [ b0 -1  1  1 ] [pW]   [W]      b_k = -2 - alfa(edge_k),
    [ -1 b1  1  1 ] [pN] = [N],     alfa = |grad u| / (lambda * g),
    [  1  1 b2 -1 ] [pS]   [S]      W/N/S/E = neighbor-cell dual
    [  1  1 -1 b3 ] [pE]   [E]      values  -  edge gradient of f

with over-relaxation omega = 1.25 (OMEGA,
src/tvl1occflow_constants.h:26); rows of boundary edges are dropped
(the reference's corner/side special cases,
tv_rof_box.cpp:193-607).  After each sweep the primal is recovered as
u = lambda*(f + div p) (:609-635).  The 4x4 pattern above reproduces
the reference's inner-cell Gauss elimination (:428-453) to machine
precision (verified by direct comparison).

Design: cells are relaxed in RED-BLACK order over the cell
checkerboard (the reference sweeps lexicographically).  Same-color
cells share no edges, so each half-sweep is one batched masked 4x4
solve over the whole grid — fully vectorized.  Within a cell we relax
with the EXACT cell solution (the reference chains relaxed
back-substitutions for interior cells, an O((1-omega)) perturbation of
the same relaxation); both are convergent splittings of the same
per-cell optimality system with the same fixed point.  Since the
caller runs a fixed 10 sweeps (MAX_ITERATIONS_U), trajectories differ
at the fraction-of-a-percent level; tvl1occflow tests validate flow
EPE and occlusion-map agreement, not bitwise duals.
"""

import jax
import jax.numpy as jnp


def _zshift(a, off, axis):
    """a[index + off] with zero padding out of range (|off| == 1)."""
    pad = [(0, 0)] * a.ndim
    idx = [slice(None)] * a.ndim
    if off == 1:
        pad[axis] = (0, 1)
        idx[axis] = slice(1, None)
    else:
        pad[axis] = (1, 0)
        idx[axis] = slice(None, -1)
    return jnp.pad(a, pad)[tuple(idx)]


def rof_box_cell_centered(u, f, p1, p2, g, lam, omega=1.25, n_iter=10):
    """Run `n_iter` red-black box-relaxation sweeps on the dual ROF
    problem; returns (u, p1, p2).

    u, f, g: (H, W); p1/p2 are the south/east edge duals per cell (the
    reference's initialP1/initialP2, tv_rof_box.cpp:130-131) carried
    across calls by Solver_wrt_u.
    """
    ny, nx = u.shape
    dtype = u.dtype

    # edge-placed gradient of f (tv_rof_box.cpp:137-165): interior
    # edges only, boundary edges stay 0
    F_h = jnp.zeros((ny + 1, nx), dtype=dtype).at[1:ny].set(f[1:] - f[:-1])
    F_v = jnp.zeros((ny, nx + 1), dtype=dtype).at[:, 1:nx].set(f[:, 1:] - f[:, :-1])

    # ph[i]: horizontal edge above cell row i (N edge of cell (i, j) is
    # ph[i, j], S edge is ph[i+1, j]); pv likewise for vertical edges
    ph = jnp.zeros((ny + 1, nx), dtype=dtype).at[1:].set(p1)
    pv = jnp.zeros((ny, nx + 1), dtype=dtype).at[:, 1:].set(p2)

    ii = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1)
    colors = ((ii + jj) % 2 == 0, (ii + jj) % 2 == 1)
    has_w = jj > 0
    has_n = ii > 0
    has_s = ii < ny - 1
    has_e = jj < nx - 1
    present = [has_w, has_n, has_s, has_e]

    # fixed off-diagonal coupling pattern (derivation in module docstring)
    BASE = ((0.0, -1.0, 1.0, 1.0),
            (-1.0, 0.0, 1.0, 1.0),
            (1.0, 1.0, 0.0, -1.0),
            (1.0, 1.0, -1.0, 0.0))

    def _solve4(A, b):
        """Unrolled Gaussian elimination of the per-cell 4x4 systems
        held as sixteen (H, W) planes + four rhs planes — deliberately
        NOT a batched (H, W, 4, 4) `linalg.solve`: sixteen planes keep
        every step elementwise, so XLA fuses the solve with its
        neighbours and no small trailing (4, 4) axis is laid out in
        memory.  No pivoting needed: diagonals are
        -2-alfa <= -2 (diagonally dominant) or exactly 1 (masked
        identity rows)."""
        A = [list(row) for row in A]
        b = list(b)
        for k in range(4):
            inv = 1.0 / A[k][k]
            for i in range(k + 1, 4):
                f = A[i][k] * inv
                for j in range(k + 1, 4):
                    A[i][j] = A[i][j] - f * A[k][j]
                b[i] = b[i] - f * b[k]
        x = [None] * 4
        for k in range(3, -1, -1):
            s = b[k]
            for j in range(k + 1, 4):
                s = s - A[k][j] * x[j]
            x[k] = s / A[k][k]
        return x

    def sweep_color(ph, pv, alfa, mask):
        pW, pE = pv[:, :-1], pv[:, 1:]
        pN, pS = ph[:-1], ph[1:]

        b0 = jnp.where(has_w, -2.0 - _zshift(alfa, -1, 1), 0.0)
        b1 = jnp.where(has_n, -2.0 - _zshift(alfa, -1, 0), 0.0)
        b2 = jnp.where(has_s, -2.0 - alfa, 0.0)
        b3 = jnp.where(has_e, -2.0 - alfa, 0.0)
        betas = [b0, b1, b2, b3]

        # neighbor-cell contributions (tv_rof_box.cpp:395-402)
        W = (-_zshift(pW, -1, 1) + _zshift(pS, -1, 1) - _zshift(pN, -1, 1)
             - F_v[:, :-1])
        N = (-_zshift(pN, -1, 0) + _zshift(pE, -1, 0) - _zshift(pW, -1, 0)
             - F_h[:-1])
        S = (-_zshift(pS, 1, 0) - _zshift(pE, 1, 0) + _zshift(pW, 1, 0)
             - F_h[1:])
        E = (-_zshift(pE, 1, 1) - _zshift(pS, 1, 1) + _zshift(pN, 1, 1)
             - F_v[:, 1:])
        rhs = [jnp.where(p, r, 0.0)
               for p, r in zip(present, (W, N, S, E))]

        # masked-identity rows pin absent (boundary) edges to 0
        one = jnp.ones((), dtype)
        zero = jnp.zeros((), dtype)
        A = [[jnp.where(present[i],
                        BASE[i][j] + (betas[i] if i == j else zero),
                        one if i == j else zero)
              for j in range(4)] for i in range(4)]
        x = _solve4(A, rhs)

        old = [pW, pN, pS, pE]
        # boundary cells: relaxation of the exact reduced solve (the
        # reference's Cramer special cases, tv_rof_box.cpp:193-607)
        newp = [(1.0 - omega) * o + omega * xi for o, xi in zip(old, x)]

        # interior cells: the reference chains RELAXED values through
        # the Gauss back-substitution (tv_rof_box.cpp:428-453) — each
        # later component uses the already-relaxed earlier ones; we
        # replicate that exactly
        interior = has_w & has_n & has_s & has_e
        a = 1.0 / jnp.where(interior, b0, 1.0)
        bb = -(b0 + 1.0) / jnp.where(interior, b0 * b1 - 1.0, 1.0)
        alf = 1.0 + a
        gam = -a + bb * alf
        xx = N + a * W
        yy = -a * W + bb * xx
        cc = (1.0 - gam) / jnp.where(interior, b2 + gam, 1.0)
        pe_ch = (1.0 - omega) * pE + omega * (E + yy + cc * (S + yy)) / \
            jnp.where(interior, b3 + gam + cc * (gam - 1.0), 1.0)
        ps_ch = (1.0 - omega) * pS + omega * (S + yy + pe_ch * (1.0 - gam)) / \
            jnp.where(interior, b2 + gam, 1.0)
        pn_ch = (1.0 - omega) * pN + omega * (xx - alf * (pe_ch + ps_ch)) / \
            jnp.where(interior, b1 - a, 1.0)
        pw_ch = (1.0 - omega) * pW + omega * (W + pn_ch - ps_ch - pe_ch) / \
            jnp.where(interior, b0, 1.0)
        chained = [pw_ch, pn_ch, ps_ch, pe_ch]
        newp = [jnp.where(interior, c, n) for c, n in zip(chained, newp)]

        # scatter: same-color cells share no edges, so each edge gets at
        # most one masked write per half-sweep
        m = mask
        ph = jnp.where(jnp.pad(m, ((0, 1), (0, 0))),
                       jnp.pad(newp[1], ((0, 1), (0, 0))), ph)
        ph = jnp.where(jnp.pad(m, ((1, 0), (0, 0))),
                       jnp.pad(newp[2], ((1, 0), (0, 0))), ph)
        pv = jnp.where(jnp.pad(m, ((0, 0), (0, 1))),
                       jnp.pad(newp[0], ((0, 0), (0, 1))), pv)
        pv = jnp.where(jnp.pad(m, ((0, 0), (1, 0))),
                       jnp.pad(newp[3], ((0, 0), (1, 0))), pv)
        return ph, pv

    def body(_, carry):
        u, ph, pv = carry
        # alfa = |grad u| / (lambda g), forward differences
        # (tv_rof_box.cpp:175-190)
        ux = jnp.pad(u[:, 1:] - u[:, :-1], ((0, 0), (0, 1)))
        uy = jnp.pad(u[1:] - u[:-1], ((0, 1), (0, 0)))
        alfa = jnp.sqrt(ux * ux + uy * uy) / (lam * g)
        for mask in colors:
            ph, pv = sweep_color(ph, pv, alfa, mask)
        # primal recovery u = lambda*(f + div p) (tv_rof_box.cpp:609-635)
        u = lam * (f + ph[1:] - ph[:-1] + pv[:, 1:] - pv[:, :-1])
        return u, ph, pv

    u, ph, pv = jax.lax.fori_loop(0, n_iter, body, (u, ph, pv))
    return u, ph[1:], pv[:, 1:]
