"""Diagnostic (`with_diag`) and verbose parity for the four solvers that
gained them in round 3: brox_spatial, brox_temporal, tvl1occflow,
robust_expo (reference stderr/stdout lines:
src/brox_optic_flow_spatial.cpp:392-394,517-519;
src/brox_optic_flow_temporal.cpp:459-461,592-594;
src/tvl1occflow.cpp:192-194,292-296;
src/robust_expo_methods.cpp:402-404,534-536)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpuflow.models.brox_spatial import brox_spatial
from tpuflow.models.brox_temporal import brox_temporal
from tpuflow.models.robust_expo import robust_expo
from tpuflow.models.tvl1occflow import tvl1occflow


def _pair(ny=40, nx=56, seed=0):
    rng = np.random.default_rng(seed)
    base = 128 + 40 * rng.standard_normal((ny + 4, nx + 4))
    # shift by one pixel for simple motion
    return (jnp.asarray(base[1:ny + 1, 1:nx + 1]),
            jnp.asarray(base[2:ny + 2, 2:nx + 2]))


def test_brox_spatial_diag_shapes_and_equivalence():
    # with_diag instruments the per-level loop; the plain call's
    # whole-pyramid jit is checked against that loop in
    # test_whole_pyramid.py
    I1, I2 = _pair()
    u0, v0 = brox_spatial(I1, I2, nscales=2, outer_iter=3, _whole=False)
    u, v, diags = brox_spatial(I1, I2, nscales=2, outer_iter=3,
                               with_diag=True)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u0))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v0))
    assert len(diags) == 2
    for d in diags:
        assert d["iterations"].shape == (3, 1)
        assert int(d["iterations"].min()) >= 1


def test_brox_spatial_verbose_format(capsys):
    I1, I2 = _pair()
    brox_spatial(I1, I2, nscales=2, outer_iter=2, verbose=True)
    out = capsys.readouterr().out.splitlines()
    # per scale: "Scale: s" then outer*inner "Iterations: n" lines
    assert out[0] == "Scale: 1"
    assert out[1].startswith("Iterations: ")
    assert "Scale: 0" in out


def test_brox_temporal_diag(capsys):
    rng = np.random.default_rng(3)
    base = 128 + 40 * rng.standard_normal((46, 62))
    frames = jnp.asarray(np.stack([base[i:40 + i, i:52 + i]
                                   for i in range(4)]))
    u, v, diags = brox_temporal(frames, nscales=2, outer_iter=2,
                                with_diag=True, verbose=True)
    assert u.shape == (3, 40, 52)
    assert len(diags) == 2 and diags[0]["iterations"].shape == (2, 1)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Scale: 1" and out[1].startswith("Iterations: ")


def test_tvl1occflow_diag(capsys):
    I1, I0 = _pair(seed=5)
    Im1, _ = _pair(seed=5)
    u1, u2, chi, diags = tvl1occflow(Im1, I0, I1, nscales=2, warps=2,
                                     with_diag=True, verbose=True)
    assert len(diags) == 2
    assert diags[0]["iterations"].shape == (2,)
    assert diags[0]["error"].shape == (2,)
    cap = capsys.readouterr()
    # "verbose" on stdout per scale; warp stats on stderr (reference
    # streams, src/tvl1occflow.cpp:192-194,292-296)
    assert cap.out.splitlines()[0] == "verbose"
    err_lines = cap.err.splitlines()
    assert err_lines[0].startswith("Warping: 0, Iterations: ")
    assert ", Error: " in err_lines[0]


def test_robust_expo_diag(capsys):
    I1, I2 = _pair(seed=9)
    u0, v0 = robust_expo(I1, I2, nscales=2, outer_iter=3, _whole=False)
    u, v, diags = robust_expo(I1, I2, nscales=2, outer_iter=3,
                              with_diag=True, verbose=True)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u0))
    assert diags[0]["iterations"].shape == (3, 1)
    assert diags[0]["error"].shape == (3, 1)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Scale: 1"
    assert out[1].startswith("Iterations: ") and " Error: " in out[1]
