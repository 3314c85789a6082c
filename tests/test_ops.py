"""L3 op unit tests against reference-C oracles (double precision)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpuflow import ops

TAGS = ["a", "b"]


def _get(goldens, tag):
    return goldens[tag]


@pytest.mark.parametrize("tag", TAGS)
def test_centered_gradient(ops_goldens, tag):
    g = _get(ops_goldens, tag)
    dx, dy = ops.centered_gradient(jnp.asarray(g["I"]))
    np.testing.assert_allclose(dx, g["centered_dx"], atol=1e-12)
    np.testing.assert_allclose(dy, g["centered_dy"], atol=1e-12)


@pytest.mark.parametrize("tag", TAGS)
def test_forward_gradient(ops_goldens, tag):
    g = _get(ops_goldens, tag)
    fx, fy = ops.forward_gradient(jnp.asarray(g["I"]))
    np.testing.assert_allclose(fx, g["forward_dx"], atol=1e-12)
    np.testing.assert_allclose(fy, g["forward_dy"], atol=1e-12)


@pytest.mark.parametrize("tag", TAGS)
def test_divergence(ops_goldens, tag):
    g = _get(ops_goldens, tag)
    div = ops.divergence(jnp.asarray(g["V1"]), jnp.asarray(g["V2"]))
    np.testing.assert_allclose(div, g["divergence"], atol=1e-12)


def test_divergence_adjoint_of_forward_gradient(ops_goldens):
    """<grad f, (v1,v2)> == -<f, div(v1,v2)> — the Chambolle discretization
    pairs these as exact adjoints; guards both boundary treatments."""
    g = _get(ops_goldens, "a")
    f, v1, v2 = (jnp.asarray(g[k]) for k in ("I", "V1", "V2"))
    fx, fy = ops.forward_gradient(f)
    lhs = jnp.sum(fx * v1 + fy * v2)
    rhs = -jnp.sum(f * ops.divergence(v1, v2))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("op", ["dxx", "dyy", "dxy"])
def test_second_derivatives(ops_goldens, tag, op):
    g = _get(ops_goldens, tag)
    out = getattr(ops, op)(jnp.asarray(g["I"]))
    np.testing.assert_allclose(out, g[op], atol=1e-12)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize(
    "sigma", [0.8, 1.0392304845413263, 3.0], ids=["s0.8", "s1.04", "s3.0"]
)
@pytest.mark.parametrize("bc", [0, 1], ids=["dirichlet", "reflecting"])
def test_gaussian(ops_goldens, tag, sigma, bc):
    g = _get(ops_goldens, tag)
    name = f"gaussian_{sigma:.4f}_bc{bc}"
    out = ops.gaussian(
        jnp.asarray(g["I"]), sigma, bc="dirichlet" if bc == 0 else "reflecting"
    )
    np.testing.assert_allclose(out, g[name], atol=1e-10)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("border", [0, 1])
def test_warp(ops_goldens, tag, border):
    g = _get(ops_goldens, tag)
    out = ops.warp(
        jnp.asarray(g["I"]), jnp.asarray(g["U"]), jnp.asarray(g["V"]),
        border_out=bool(border),
    )
    np.testing.assert_allclose(out, g[f"warp_b{border}"], atol=1e-10)


@pytest.mark.parametrize("tag", TAGS)
def test_warp_large_displacement(ops_goldens, tag):
    g = _get(ops_goldens, tag)
    out = ops.warp(
        jnp.asarray(g["I"]), jnp.asarray(g["U"] * 8), jnp.asarray(g["V"] * 8),
        border_out=True,
    )
    np.testing.assert_allclose(out, g["warp_big_b1"], atol=1e-10)


@pytest.mark.parametrize("tag", TAGS)
def test_zoom_out(ops_goldens, tag):
    g = _get(ops_goldens, tag)
    out = ops.zoom_out(jnp.asarray(g["I"]), 0.5)
    assert out.shape == g["zoom_out_05"].shape
    np.testing.assert_allclose(out, g["zoom_out_05"], atol=1e-10)


@pytest.mark.parametrize("tag", TAGS)
def test_zoom_in(ops_goldens, tag):
    g = _get(ops_goldens, tag)
    ny, nx = g["I"].shape
    out = ops.zoom_in(jnp.asarray(g["zoom_out_05"]), (nx, ny))
    np.testing.assert_allclose(out, g["zoom_in_back"], atol=1e-10)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("wsize", [3, 5])
def test_median(ops_goldens, tag, wsize):
    g = _get(ops_goldens, tag)
    out = ops.median_filter(jnp.asarray(g["I"]), wsize)
    np.testing.assert_allclose(out, g[f"median{wsize}"], atol=0)


def test_normalize_joint(solver_goldens):
    g = solver_goldens
    n0, n1 = ops.normalize_joint(jnp.asarray(g["I0"]), jnp.asarray(g["I1"]))
    np.testing.assert_allclose(n0, g["n0"], atol=1e-12)
    np.testing.assert_allclose(n1, g["n1"], atol=1e-12)


def test_f32_path_close_to_f64():
    """The float32 path must track the double oracle closely on
    well-scaled inputs."""
    rng = np.random.default_rng(0)
    I = rng.standard_normal((40, 56)) * 100.0
    u = rng.standard_normal((40, 56)) * 2.0
    v = rng.standard_normal((40, 56)) * 2.0
    hi = ops.warp(jnp.asarray(I), jnp.asarray(u), jnp.asarray(v))
    lo = ops.warp(
        jnp.asarray(I, dtype=jnp.float32),
        jnp.asarray(u, dtype=jnp.float32),
        jnp.asarray(v, dtype=jnp.float32),
    )
    assert lo.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(lo), np.asarray(hi), atol=2e-3)


def test_interpolate_bilinear_matches_reference_loop():
    """Direct loop transcription of me_interpolate_bilinear
    (src/bicubic_interpolation.cpp:407-446) as oracle."""
    import jax.numpy as jnp

    from tpuflow.ops import interpolate_bilinear

    rng = np.random.default_rng(4)
    img = rng.standard_normal((9, 13))
    xs = rng.uniform(0, 11.9, 40)
    ys = rng.uniform(0, 7.9, 40)
    xs[:5] = np.round(xs[:5])  # exercise the exact-integer branches
    ys[2:7] = np.round(ys[2:7])

    def oracle(x, y):
        l, k = int(np.floor(x)), int(np.floor(y))
        a, b = x - l, y - k
        x0 = img[k, l]
        x1 = img[k, min(l + 1, 12)]
        x2 = img[min(k + 1, 8), l]
        x3 = img[min(k + 1, 8), min(l + 1, 12)]
        if a == 0 and b == 0:
            return x0
        if a == 0:
            return (1 - b) * x0 + b * x2
        if b == 0:
            return (1 - a) * x0 + a * x1
        return (1 - b) * ((1 - a) * x0 + a * x1) + b * ((1 - a) * x2 + a * x3)

    got = np.asarray(interpolate_bilinear(jnp.asarray(img),
                                          jnp.asarray(xs), jnp.asarray(ys)))
    want = np.array([oracle(x, y) for x, y in zip(xs, ys)])
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_image_restriction_matches_reference_loop():
    """me_image_restriction (src/bicubic_interpolation.cpp:653-688)."""
    import jax.numpy as jnp

    from tpuflow.ops import image_restriction, interpolate_bilinear

    rng = np.random.default_rng(5)
    img = rng.standard_normal((12, 20))
    new_nx, new_ny = 9, 5
    got = np.asarray(image_restriction(jnp.asarray(img), (new_nx, new_ny)))
    gx, gy = 20 / new_nx, 12 / new_ny
    want = np.zeros((new_ny, new_nx))
    for i in range(new_ny):
        for j in range(new_nx):
            want[i, j] = float(interpolate_bilinear(
                jnp.asarray(img), jnp.asarray(gx / 2 - 0.5 + j * gx),
                jnp.asarray(gy / 2 - 0.5 + i * gy)))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_pfm_roundtrip():
    import tempfile

    from tpuflow.io.image import read_pfm, write_pfm

    rng = np.random.default_rng(6)
    for shape in [(7, 11), (7, 11, 3)]:
        arr = rng.standard_normal(shape).astype(np.float32)
        with tempfile.NamedTemporaryFile(suffix=".pfm") as f:
            write_pfm(f.name, arr)
            back = read_pfm(f.name)
            np.testing.assert_allclose(back, arr, atol=0)
