#!/usr/bin/env python3
"""tpuflow benchmark driver.

Prints ONE JSON line (the LAST line of stdout is the authoritative
result; a partial headline line is flushed early as insurance against
hard timeouts):
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, "extra": {...}}

Headline metric (BASELINE.json): TV-L1 flow fields/sec/GPU at 1024x436
with the reference CLI's default parameters (tau=0.25 lambda=0.15
theta=0.3 nscales auto-clamped to 7, zfactor=0.5, 5 warps,
epsilon=0.01, data-dependent stopping).  The `extra` field carries the
second north-star config — pyramidal Horn-Schunck at the reference
defaults (alpha=7, 10 warps, tol=1e-4) — plus the fixed-schedule TV-L1
number.

`vs_baseline` compares against the reference C++/OpenMP binary measured
on a CPU by tools/bench_reference.py, read from the checked-in artifact
tools/baseline_measured.json.

Every result names the device it ran on (platform, device_kind, device
count); the script exits non-zero when JAX finds no GPU.  Both stopping
modes of each method share one compiled program (runtime stopping
scalars), so the first timed call of each method is its only compile.
"""

import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _ROOT)

_ARTIFACT = os.path.join(_ROOT, "tools", "baseline_measured.json")

B = 128
NY, NX = 436, 1024


def _device():
    """{"platform", "kind", "count"} of the default backend; exits
    non-zero unless it is a GPU."""
    import jax

    from tpuflow.utils.cache import configure_cache

    configure_cache()
    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    if dev["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev}", file=sys.stderr)
        raise SystemExit(2)
    return dev


def _baseline():
    """Measured reference-binary throughput (fields/s) per method."""
    try:
        with open(_ARTIFACT) as f:
            return json.load(f)["fields_per_sec"]
    except (OSError, KeyError, ValueError):
        print("WARNING: tools/baseline_measured.json missing/unreadable; "
              "run tools/bench_reference.py — reporting vs_baseline=null",
              file=sys.stderr)
        return {}


def _synth_base(ny, nx, seed):
    """Band-limited random image in about [28, 228] and the smooth drift
    flow (|u| <= 2, |v| <= 1.5 px) the synthetic frames move by."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((ny, nx))
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    base = np.real(np.fft.ifft2(np.fft.fft2(noise) * np.exp(-(fx**2 + fy**2) * 800.0)))
    base = 128 + 100 * base / np.abs(base).max()
    u = 2.0 * np.sin(np.linspace(0, 3, nx))[None, :] * np.ones((ny, 1))
    v = 1.5 * np.cos(np.linspace(0, 2, ny))[:, None] * np.ones((1, nx))
    return base, u, v


def _bilinear_warp(img, u, v):
    """img sampled at (x + u, y + v), clamped to the frame (float64)."""
    ny, nx = img.shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    sx = np.clip(xx + u, 0, nx - 1)
    sy = np.clip(yy + v, 0, ny - 1)
    x0 = np.clip(np.floor(sx).astype(int), 0, nx - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, ny - 2)
    fx_ = sx - x0
    fy_ = sy - y0
    return (img[y0, x0] * (1 - fx_) * (1 - fy_) + img[y0, x0 + 1] * fx_ * (1 - fy_)
            + img[y0 + 1, x0] * (1 - fx_) * fy_ + img[y0 + 1, x0 + 1] * fx_ * fy_)


def synth_pair(ny=NY, nx=NX, seed=7):
    """(I0, I1) float32: a band-limited image and its warp by the drift
    flow."""
    base, u, v = _synth_base(ny, nx, seed)
    return base.astype(np.float32), _bilinear_warp(base, u, v).astype(np.float32)


def synth_triplet(ny=NY, nx=NX, seed=7):
    """(I_-1, I0, I1) float32: temporally consistent frames under the
    drift flow (backward and forward warps of the same image), so the
    occlusion-aware problem is well-posed."""
    base, u, v = _synth_base(ny, nx, seed)
    return (_bilinear_warp(base, -u, -v).astype(np.float32),
            base.astype(np.float32),
            _bilinear_warp(base, u, v).astype(np.float32))


def synth_sequence(frames, ny=NY, nx=NX, seed=7):
    """(frames, H, W) float32 sequence: each frame the drift-flow warp
    of the previous one."""
    base, u, v = _synth_base(ny, nx, seed)
    seq = [base]
    for _ in range(frames - 1):
        seq.append(_bilinear_warp(seq[-1], u, v))
    return np.stack(seq).astype(np.float32)


def _time(run, n=5):
    """Mean seconds over n reps (after one compiling call) plus the raw
    per-rep list, so ~10%-level comparisons don't rest on one mean."""
    run()  # compile
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return sum(times) / n, times


def main():
    dev = _device()
    import jax
    import jax.numpy as jnp

    from tpuflow.models.batch import hs_pyramidal_batched, tvl1_batched

    # batch of distinct synthetic pairs; stop="error" reproduces the
    # reference CLI's data-dependent stopping per sample, so throughput
    # is measured at the reference operating point
    I0s, I1s = [], []
    for s in range(B):
        a, b = synth_pair(seed=100 + s)
        I0s.append(a)
        I1s.append(b)
    I0 = jnp.asarray(np.stack(I0s), dtype=jnp.float32)
    I1 = jnp.asarray(np.stack(I1s), dtype=jnp.float32)

    def run_tvl1():
        return jax.block_until_ready(tvl1_batched(I0, I1, stop="error"))

    def run_tvl1_fixed():
        return jax.block_until_ready(tvl1_batched(I0, I1, stop="fixed"))

    def run_hs():
        return jax.block_until_ready(
            hs_pyramidal_batched(I0, I1, stop="error"))

    base = _baseline()
    base_tvl1 = base.get("tvl1flow")
    base_hs = base.get("horn_schunck_pyramidal")

    t_mean, t_reps = _time(run_tvl1)
    fps = B / t_mean
    # insurance: flush the headline before benching the extras, so even
    # a hard timeout records the north-star number
    print(json.dumps({
        "metric": "tvl1_fields_per_sec_1024x436",
        "value": round(fps, 3),
        "unit": "fields/s/gpu",
        "vs_baseline": round(fps / base_tvl1, 2) if base_tvl1 else None,
        "device": dev,
        "extra": {"partial": True},
    }), flush=True)

    tf_mean, tf_reps = _time(run_tvl1_fixed)
    th_mean, th_reps = _time(run_hs)
    fps_fixed = B / tf_mean
    fps_hs = B / th_mean

    print(json.dumps({
        "metric": "tvl1_fields_per_sec_1024x436",
        "value": round(fps, 3),
        "unit": "fields/s/gpu",
        "vs_baseline": round(fps / base_tvl1, 2) if base_tvl1 else None,
        "device": dev,
        "extra": {
            "batch": B,
            "tvl1_fixed_schedule": round(fps_fixed, 3),
            "hs_pyramidal": round(fps_hs, 3),
            "hs_pyramidal_vs_baseline":
                round(fps_hs / base_hs, 2) if base_hs else None,
            "reference_cpu_tvl1": base_tvl1,
            "reference_cpu_hs": base_hs,
            "rep_ms": {
                "tvl1": [round(t * 1e3, 2) for t in t_reps],
                "tvl1_fixed": [round(t * 1e3, 2) for t in tf_reps],
                "hs": [round(t * 1e3, 2) for t in th_reps],
            },
        },
    }), flush=True)


if __name__ == "__main__":
    main()
