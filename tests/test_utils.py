"""Checkpoint/resume and tracing hooks."""

import os

import jax.numpy as jnp
import numpy as np

from tpuflow.models.tvl1 import tvl1_multiscale
from tpuflow.utils.checkpoint import (
    checkpoint_callback,
    load_level_checkpoint,
)


def test_checkpoint_and_resume(solver_goldens, tmp_path):
    g = solver_goldens
    I0, I1 = jnp.asarray(g["I0"]), jnp.asarray(g["I1"])
    ckpt = str(tmp_path / "ckpt")
    u_full, v_full = tvl1_multiscale(I0, I1, nscales=3, clamp_scales=False,
                                     level_callback=checkpoint_callback(ckpt))
    assert sorted(os.listdir(ckpt)) == [
        "level_00.npz", "level_01.npz", "level_02.npz"]

    # resume from the coarsest saved level; must reproduce the full run
    state = load_level_checkpoint(ckpt, 2)
    u_res, v_res = tvl1_multiscale(I0, I1, nscales=3, clamp_scales=False,
                                   resume=(2, state["u1"], state["u2"]))
    np.testing.assert_allclose(np.asarray(u_res), np.asarray(u_full),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(v_res), np.asarray(v_full),
                               atol=1e-12)

    # auto-pick finest level
    scale, st = load_level_checkpoint(ckpt)
    assert scale == 0
    np.testing.assert_allclose(st["u1"], np.asarray(u_full), atol=1e-12)


def test_checkpoint_resume_occflow(solver_goldens, tmp_path):
    """occflow rides the shared run_pyramid_state hooks: resuming from
    a level checkpoint (u1/u2/chi) reproduces the uninterrupted run."""
    from tpuflow.models.tvl1occflow import tvl1occflow

    g = solver_goldens
    Im1 = jnp.asarray(np.roll(g["I0"], -1, axis=1))
    kw = dict(nscales=2, clamp_scales=False, warps=1, max_iterations=3,
              stop="fixed")
    ckpt = str(tmp_path / "occ")
    u_f, v_f, chi_f = tvl1occflow(Im1, jnp.asarray(g["I0"]),
                                  jnp.asarray(g["I1"]),
                                  level_callback=checkpoint_callback(ckpt),
                                  **kw)
    assert sorted(os.listdir(ckpt)) == ["level_00.npz", "level_01.npz"]
    state = load_level_checkpoint(ckpt, 1)
    assert set(state) == {"u1", "u2", "chi"}
    u_r, v_r, chi_r = tvl1occflow(Im1, jnp.asarray(g["I0"]),
                                  jnp.asarray(g["I1"]),
                                  resume=(1, state), **kw)
    np.testing.assert_allclose(np.asarray(u_r), np.asarray(u_f), atol=1e-12)
    np.testing.assert_allclose(np.asarray(chi_r), np.asarray(chi_f),
                               atol=1e-12)


def test_checkpoint_resume_brox_temporal(solver_goldens, tmp_path):
    from tpuflow.models.brox_temporal import brox_temporal

    g = solver_goldens
    vol = jnp.stack([jnp.asarray(np.roll(g["I0"], k, axis=1))
                     for k in range(3)])
    kw = dict(nscales=2, clamp_scales=False, outer_iter=1, stop="fixed",
              maxiter=3)
    ckpt = str(tmp_path / "bt")
    u_f, v_f = brox_temporal(vol, level_callback=checkpoint_callback(ckpt),
                             **kw)
    state = load_level_checkpoint(ckpt, 1)
    u_r, v_r = brox_temporal(vol, resume=(1, state), **kw)
    np.testing.assert_allclose(np.asarray(u_r), np.asarray(u_f), atol=1e-12)
    np.testing.assert_allclose(np.asarray(v_r), np.asarray(v_f), atol=1e-12)


def test_checkpoint_resume_batched(solver_goldens, tmp_path):
    """The batched TV-L1 driver shares the same hooks (hook path runs
    level-by-level; result must match the whole-pyramid-jit path)."""
    from tpuflow.models.batch import tvl1_batched

    g = solver_goldens
    I0 = jnp.asarray(np.stack([g["I0"]] * 2), dtype=jnp.float32)
    I1 = jnp.asarray(np.stack([g["I1"]] * 2), dtype=jnp.float32)
    kw = dict(nscales=2, stop="fixed", iter_schedule=(4, 2))
    u_jit, v_jit = tvl1_batched(I0, I1, **kw)
    ckpt = str(tmp_path / "bat")
    u_f, v_f = tvl1_batched(I0, I1,
                            level_callback=checkpoint_callback(ckpt), **kw)
    # hook path runs level-by-level jits vs one whole-pyramid jit; f32
    # fusion/reassociation differences reach ~2e-5 (5.7e-14 in f64)
    np.testing.assert_allclose(np.asarray(u_f), np.asarray(u_jit), atol=1e-4)
    state = load_level_checkpoint(ckpt, 1)
    u_r, v_r = tvl1_batched(I0, I1, resume=(1, state), **kw)
    np.testing.assert_allclose(np.asarray(u_r), np.asarray(u_f), atol=1e-12)


def test_cache_honours_jax_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, no code sets a cache."""
    import jax

    from tpuflow.utils import cache

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    assert cache.configure_cache() == str(tmp_path)
    assert calls == []


def test_cache_default_is_checkout_path(monkeypatch):
    """Without it, the cache is the fixed `<checkout>/.jax_cache`."""
    import jax

    from tpuflow.utils import cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d = cache.configure_cache()
        assert d == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        assert os.path.isdir(d)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
