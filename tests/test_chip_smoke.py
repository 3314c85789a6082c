"""chip_smoke.py: it refuses to run without a GPU, and its phases,
rehearsed here at a tiny size on the CPU, drive the code paths and
comparisons the one-card and four-card runs use."""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


@pytest.fixture
def failures(monkeypatch):
    out = []
    monkeypatch.setattr(chip_smoke, "FAILURES", out)
    return out


def test_rehearse_batched_and_trace(failures):
    program = chip_smoke.phase_batched("cpu", B=2, ny=40, nx=56, reps=1)
    assert program is not None and program[1].shape == (2, 40, 56)
    chip_smoke.phase_trace("cpu", program, require_device=False)
    assert failures == []


def test_rehearse_clis(failures):
    chip_smoke.phase_clis("cpu", ny=40, nx=56)
    assert failures == []


def test_rehearse_multicard_dp_and_temporal(failures):
    """Data parallelism and frame sharding on four virtual CPU devices
    (the GSPMD spatial lane is rehearsed by tests/test_spatial.py)."""
    devs = jax.devices()[:4]
    chip_smoke.lane_dp("cpu", devs, B=4, ny=40, nx=56)
    chip_smoke.lane_temporal("cpu", devs, frames=5, ny=40, nx=56)
    assert failures == []


def test_reduce_trace_idle_share(tmp_path):
    """The trace reduction finds the annotated window and the top
    operations of a recorded CPU trace (no device plane: idle None)."""
    import glob

    import jax.numpy as jnp

    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        with jax.profiler.TraceAnnotation("smoke_window"):
            f(x).block_until_ready()
    path = glob.glob(str(tmp_path / "plugins" / "profile" / "*" /
                         "*.xplane.pb"))[0]
    tops, idle = chip_smoke.reduce_trace(path)
    assert idle is None and tops == []
