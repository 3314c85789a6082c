#!/usr/bin/env python3
"""Prove that tpuflow's main path runs on NVIDIA GPUs at Sintel width.

Usage:
    python chip_smoke.py              # one GPU: phases 1-4 below
    python chip_smoke.py --cards 4    # four GPUs: the multi-device paths only

Phases on one card, at 1024x436 (the MPI-Sintel frame size):
  1. device: JAX version, device kind and count, XLA_FLAGS, the card's
     name and power limit (nvidia-smi, run in a child process that never
     imports JAX), and the compile-cache directory;
  2. the batched engines `tvl1_batched` and `hs_pyramidal_batched` at
     B=16: compile seconds, `memory_analysis()`, peak device memory,
     three timed runs, and the EPE of samples 0 and 1 against the
     float64 single-pair exact path, with and without the warp-level
     early exit;
  3. the seven CLIs, in process through each module's `main(argv)`, on
     images written by the repo's own writer; each `.flo` is read back
     and compared with the float64 public function;
  4. one `jax.profiler` trace of a batched TV-L1 call: the ten longest
     device operations and the device idle share.

With `--cards 4` only the multi-device paths run, each compared with the
same work on one card: batch data parallelism (`dp_shard`), the GSPMD
spatial lane at 1920x1080 on a 2x2 mesh, and frame sharding of Brox
temporal over a 9-frame sequence.  The device of every shard is printed.

Precision: float32 is the program under test; float64 (`jax.enable_x64`,
scoped to the reference calls) is the reference.  The only matrix
products are the pyramid resampling einsums, which ask for
`Precision.HIGHEST` (tpuflow/ops/pyramid.py), so TF32 does not enter.

Every phase runs even if an earlier one failed.  The last line of
stdout is `{"ok": true, "device": {...}}` only when every check passed;
otherwise, or when JAX finds no GPU, the script exits non-zero without
that line.  One process drives every card it uses.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

EPE_BUDGET = 0.05      # parity budget vs the reference (README)
NY, NX = 436, 1024     # MPI-Sintel frame size
FAILURES = []


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    log(("PASS " if ok else "FAIL ") + what)
    if not ok:
        FAILURES.append(what)


def epe(u1, v1, u2, v2):
    return float(np.mean(np.hypot(np.asarray(u1, np.float64) - np.asarray(u2),
                                  np.asarray(v1, np.float64) - np.asarray(v2))))


def card_lines():
    """nvidia-smi's name and power limit per card, from a child process
    that stays off JAX (so it holds no device memory)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    except (OSError, subprocess.TimeoutExpired) as e:
        lines = []
        log(f"nvidia-smi unavailable: {e}")
    return lines or ["nvidia-smi: not available"]


def _mem_summary(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, k)) for k in dir(m)
            if k.endswith("_in_bytes") and not k.startswith("_")}


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_device(cache_dir):
    devs = jax.devices()
    log(f"jax {jax.__version__}  device_kind={devs[0].device_kind}  "
        f"platform={devs[0].platform}  device_count={len(devs)}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache_dir}")
    lines = card_lines()
    for ln in lines:
        log(f"nvidia-smi: {ln}")
    return lines[0]


def batch_inputs(B, ny, nx, seed0):
    from bench import synth_pair

    pairs = [synth_pair(ny, nx, seed=seed0 + s) for s in range(B)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def phase_batched(card, B=16, ny=NY, nx=NX, reps=3):
    """The batched engines at (B, ny, nx); returns the compiled TV-L1
    program and its inputs for the trace phase."""

    from tpuflow.models.batch import hs_pyramidal_batched, tvl1_batched
    from tpuflow.models.hs_pyramidal import hs_pyramidal
    from tpuflow.models.tvl1 import tvl1_multiscale

    I0n, I1n = batch_inputs(B, ny, nx, seed0=100)
    I0 = jnp.asarray(I0n, jnp.float32)
    I1 = jnp.asarray(I1n, jnp.float32)
    dev = jax.devices()[0]
    kept = None
    for name, fn, ref in (("tvl1_batched", tvl1_batched, tvl1_multiscale),
                          ("hs_pyramidal_batched", hs_pyramidal_batched,
                           hs_pyramidal)):
        prog = jax.jit(lambda a, b, fn=fn: fn(a, b, stop="error"))
        t0 = time.perf_counter()
        compiled = prog.lower(I0, I1).compile()
        compile_s = time.perf_counter() - t0
        log(f"{name} B={B} {nx}x{ny}: compile {compile_s:.2f} s  "
            f"memory_analysis {_mem_summary(compiled)}  card={card}")
        u, v = jax.block_until_ready(compiled(I0, I1))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(I0, I1))
            times.append(time.perf_counter() - t0)
        ms = [round(t * 1e3, 3) for t in times]
        log(f"{name} B={B} {nx}x{ny}: ms/batch {ms}  fields/s "
            f"{B / min(times):.2f} (best of {reps})  peak_bytes_in_use "
            f"{_peak_bytes(dev)}  card={card}")
        t0 = time.perf_counter()
        u_s, v_s = jax.block_until_ready(
            fn(I0, I1, stop="error", warp_early_exit=False))
        log(f"{name} warp_early_exit=False: first call "
            f"{time.perf_counter() - t0:.2f} s (compile + run)  card={card}")
        for k in range(min(2, B)):
            with jax.enable_x64(True):
                ur, vr = jax.block_until_ready(
                    ref(jnp.asarray(I0n[k], jnp.float64),
                        jnp.asarray(I1n[k], jnp.float64), warp_mode="exact"))
                ur, vr = np.asarray(ur), np.asarray(vr)
            for label, (a, b) in (("early exit", (u, v)),
                                  ("warp_early_exit=False", (u_s, v_s))):
                e = epe(a[k], b[k], ur, vr)
                check(np.isfinite(e) and e <= EPE_BUDGET,
                      f"{name} sample {k} ({label}) f32 vs f64 exact "
                      f"single-pair: EPE {e:.6f} <= {EPE_BUDGET}")
        if name == "tvl1_batched":
            kept = (compiled, I0, I1)
    return kept


def _cli_cases(d, ny, nx):
    """(name, main, argv, outputs, reference) for the seven CLIs on
    images written with the repo's own writer."""

    from bench import synth_sequence, synth_triplet
    from tpuflow.cli import (brox_spatial, brox_temporal,
                             horn_schunck_classic, horn_schunck_pyramidal,
                             robust_expo_methods, tvl1flow, tvl1occflow)
    from tpuflow.io import write_image
    from tpuflow import models

    Im1, I0, I1 = synth_triplet(ny, nx, seed=7)
    p = {k: os.path.join(d, f"{k}.png") for k in ("im1", "i0", "i1")}
    for k, img in zip(("im1", "i0", "i1"), (Im1, I0, I1)):
        write_image(p[k], img)
    seq = []
    for k, img in enumerate(synth_sequence(5, ny, nx, seed=8)):
        seq.append(os.path.join(d, f"seq{k}.png"))
        write_image(seq[-1], img)
    bt = os.path.join(d, "bt")
    os.makedirs(bt, exist_ok=True)
    out = {k: os.path.join(d, f"{k}.flo") for k in
           ("tvl1", "hsp", "hsc", "brox", "re", "occ")}
    pair = (p["i0"], p["i1"])
    return [
        ("tvl1flow", tvl1flow.main, [*pair, out["tvl1"]], [out["tvl1"]],
         pair, lambda a, b: models.tvl1_multiscale(a, b)),
        ("horn_schunck_pyramidal", horn_schunck_pyramidal.main,
         [*pair, out["hsp"]], [out["hsp"]], pair,
         lambda a, b: models.hs_pyramidal(a, b)),
        ("horn_schunck_classic", horn_schunck_classic.main,
         ["100", "7", *pair, out["hsc"]], [out["hsc"]], pair,
         lambda a, b: models.hs_classic(a, b, 100, 7.0)),
        ("brox_spatial", brox_spatial.main, [*pair, out["brox"]],
         [out["brox"]], pair, lambda a, b: models.brox_spatial(a, b)),
        ("robust_expo_methods", robust_expo_methods.main,
         [*pair, out["re"]], [out["re"]], pair,
         lambda a, b: models.robust_expo(a, b)),
        ("tvl1occflow", tvl1occflow.main,
         [p["im1"], *pair, p["i0"], out["occ"],
          os.path.join(d, "occ.png")], [out["occ"]],
         (p["im1"], *pair), lambda m, a, b: models.tvl1occflow(m, a, b)[:2]),
        ("brox_temporal", brox_temporal.main,
         [str(len(seq)), *seq, "18", "7", "100", "0.75", "0.0001", "1",
          "15", bt],
         [os.path.join(bt, f"flow{i:02d}.flo") for i in range(len(seq) - 1)],
         tuple(seq), lambda *fr: models.brox_temporal(jnp.stack(fr))),
    ]


def phase_clis(card, ny=NY, nx=NX):
    from tpuflow.io import read_flo, read_image

    with tempfile.TemporaryDirectory() as d:
        for name, main, argv, outs, inputs, ref in _cli_cases(d, ny, nx):
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                rc = main(list(argv))
                secs.append(time.perf_counter() - t0)
                check(rc == 0, f"{name} CLI exit code {rc}")
            log(f"{name} CLI {nx}x{ny}: first call {secs[0]:.2f} s "
                f"(compile + run), second call {secs[1]:.2f} s  card={card}")
            flows = [read_flo(o) for o in outs]
            u = np.stack([f[0] for f in flows])
            v = np.stack([f[1] for f in flows])
            check(u.shape[-2:] == (ny, nx) and bool(np.isfinite(u).all()
                                                    and np.isfinite(v).all()),
                  f"{name} .flo finite, shape {u.shape}")
            with jax.enable_x64(True):
                imgs = [jnp.asarray(read_image(q, gray=True)) for q in inputs]
                ur, vr = jax.block_until_ready(ref(*imgs))
                ur = np.asarray(ur).reshape(u.shape)
                vr = np.asarray(vr).reshape(v.shape)
            e = epe(u, v, ur, vr)
            check(np.isfinite(e) and e <= EPE_BUDGET,
                  f"{name} CLI f32 vs f64 public function: EPE {e:.6f} "
                  f"<= {EPE_BUDGET}")


def _device_planes(pd):
    return [p for p in pd.planes if p.name.startswith("/device:")]


def reduce_trace(path, window_name="smoke_window", top=10):
    """Ten longest device operations and the device idle share of the
    annotated host window, from one .xplane.pb file.  Returns
    (top list of (name, total_ns, count), idle share or None)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    window = None
    for plane in pd.planes:
        for line in plane.lines:
            for ev in line.events:
                if ev.name == window_name:
                    window = (ev.start_ns, ev.start_ns + ev.duration_ns)
    busy, per_op = [], {}
    for plane in _device_planes(pd):
        log(f"trace plane {plane.name}: lines "
            f"{[(ln.name, sum(1 for _ in ln.events)) for ln in plane.lines]}")
        names = [ln.name for ln in plane.lines]
        streams = [n for n in names if n.startswith("Stream")]
        busy_lines = streams or [n for n in names if n not in
                                 ("XLA Modules", "XLA Ops", "Steps")]
        op_lines = ["XLA Ops"] if "XLA Ops" in names else busy_lines
        for line in plane.lines:
            for ev in line.events:
                if line.name in busy_lines:
                    busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if line.name in op_lines:
                    tot, cnt = per_op.get(ev.name, (0.0, 0))
                    per_op[ev.name] = (tot + ev.duration_ns, cnt + 1)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    tops = [(n, t, c) for n, (t, c) in ranked]
    if not busy:
        return tops, None
    lo, hi = window if window else (min(b[0] for b in busy),
                                    max(b[1] for b in busy))
    merged_ns, cur_lo, cur_hi = 0.0, None, None
    for s, e in sorted(busy):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                merged_ns += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        merged_ns += cur_hi - cur_lo
    return tops, 1.0 - merged_ns / (hi - lo)


def phase_trace(card, program, require_device=True):
    """Trace one call of the compiled batched TV-L1 program into a
    temporary directory and reduce it."""
    with tempfile.TemporaryDirectory() as outdir:
        _trace(card, program, outdir, require_device)


def _trace(card, program, outdir, require_device):
    compiled, I0, I1 = program
    jax.block_until_ready(compiled(I0, I1))
    with jax.profiler.trace(outdir):
        with jax.profiler.TraceAnnotation("smoke_window"):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(I0, I1))
            wall = time.perf_counter() - t0
    files = sorted(glob.glob(os.path.join(outdir, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    check(bool(files), "trace written")
    if not files:
        return
    tops, idle = reduce_trace(files[-1])
    log(f"trace: tvl1_batched B={I0.shape[0]} {I0.shape[2]}x{I0.shape[1]} "
        f"traced call {wall * 1e3:.3f} ms  card={card}")
    for name, tot, cnt in tops:
        log(f"  device op {tot / 1e6:10.3f} ms  x{cnt:<5d} {name[:110]}")
    log(f"trace: device idle share {idle}  card={card}")
    if require_device:
        check(idle is not None and bool(tops),
              "trace holds device operations")


def _where(x):
    """The devices holding the shards of array `x`."""
    return sorted({str(s.device) for s in x.addressable_shards})


def _timed(card, label, fn, *args):
    """Call fn twice (the first call compiles); log both wall times."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    log(f"{label}: first call {first:.2f} s, second "
        f"{time.perf_counter() - t0:.3f} s  card={card}")
    return out


def lane_dp(card, devs, B, ny, nx):
    """(a) batch data parallelism over a ("batch",) mesh."""
    from jax.sharding import Mesh

    from tpuflow.models.batch import tvl1_batched
    from tpuflow.parallel.distributed import dp_shard

    n, one = len(devs), devs[0]
    I0n, I1n = batch_inputs(B, ny, nx, seed0=200)
    a1 = [jax.device_put(jnp.asarray(x, jnp.float32), one) for x in (I0n, I1n)]
    u1, v1 = _timed(card, f"dp tvl1_batched B={B} {nx}x{ny} on 1 card",
                    tvl1_batched, *a1)
    mesh = Mesh(np.asarray(devs), ("batch",))
    an = dp_shard(tuple(jnp.asarray(x, jnp.float32) for x in (I0n, I1n)),
                  mesh)
    log(f"dp input shards on {_where(an[0])}")
    un, vn = _timed(card, f"dp tvl1_batched B={B} {nx}x{ny} on {n} cards",
                    tvl1_batched, *an)
    log(f"dp output shards on {_where(un)}")
    per = np.hypot(np.asarray(un) - np.asarray(u1),
                   np.asarray(vn) - np.asarray(v1)).mean(axis=(-2, -1))
    check(len(_where(un)) == n, f"dp output on {n} distinct devices")
    check(float(per.max()) <= 1e-5,
          f"dp per-sample EPE {n} cards vs 1 card: max {per.max():.3e} "
          f"<= 1e-05")


def lane_spatial(card, devs, big):
    """(b) the GSPMD spatial lane on a 2 x (n/2) mesh.

    tvl1occflow runs in float64 on both sides: its chi >= 0.75 branch
    selection turns a one-ulp f32 difference between two compilations
    of the solve (the partitioned program against the one-device one)
    into ~1e-3 EPE, so the 1e-4 bound is a float64 bound for it."""

    from bench import synth_triplet
    from tpuflow.models.robust_expo import robust_expo
    from tpuflow.models.tvl1occflow import tvl1occflow
    from tpuflow.parallel.spatial import (make_spatial_mesh,
                                          robust_expo_spatial,
                                          tvl1occflow_spatial)

    n, one = len(devs), devs[0]
    smesh = make_spatial_mesh(2, n // 2, devices=devs)
    size = f"{big[1]}x{big[0]}"
    frames = synth_triplet(*big, seed=11)
    with jax.enable_x64(True):
        trip = [jnp.asarray(x, jnp.float64) for x in frames]
        r1 = _timed(card, f"tvl1occflow fast f64 {size} on 1 card",
                    lambda m, a, b: tvl1occflow(m, a, b, warp_mode="fast"),
                    *(jax.device_put(x, one) for x in trip))
        rn = _timed(card, f"tvl1occflow_spatial f64 {size} on {n} cards",
                    lambda m, a, b: tvl1occflow_spatial(m, a, b, mesh=smesh),
                    *trip)
        log(f"tvl1occflow_spatial output shards on {_where(rn[0])}")
        e = epe(rn[0], rn[1], r1[0], r1[1])
    check(len(_where(rn[0])) == n and e <= 1e-4,
          f"tvl1occflow_spatial f64 vs 1 card: EPE {e:.3e} <= 1e-04")
    J0, J1 = (jnp.asarray(x) for x in frames[1:])
    r1 = _timed(card, f"robust_expo fast f32 {size} on 1 card",
                lambda a, b: robust_expo(a, b, warp_mode="fast"),
                *(jax.device_put(x, one) for x in (J0, J1)))
    rn = _timed(card, f"robust_expo_spatial f32 {size} on {n} cards",
                lambda a, b: robust_expo_spatial(a, b, mesh=smesh), J0, J1)
    log(f"robust_expo_spatial output shards on {_where(rn[0])}")
    e = epe(rn[0], rn[1], r1[0], r1[1])
    check(len(_where(rn[0])) == n and e <= 1e-4,
          f"robust_expo_spatial f32 vs 1 card: EPE {e:.3e} <= 1e-04")


def lane_temporal(card, devs, frames, ny, nx):
    """(c) frame sharding of Brox temporal over a ("t",) mesh."""
    from jax.sharding import Mesh

    from bench import synth_sequence
    from tpuflow.models.brox_temporal import brox_temporal
    from tpuflow.parallel.temporal import brox_temporal_multiscale_sharded

    n, one = len(devs), devs[0]
    vol = jnp.asarray(synth_sequence(frames, ny, nx, seed=12))
    r1 = _timed(card, f"brox_temporal {frames} frames {nx}x{ny} on 1 card",
                brox_temporal, jax.device_put(vol, one))
    tmesh = Mesh(np.asarray(devs), ("t",))
    rn = _timed(card, f"brox_temporal_multiscale_sharded {frames} frames "
                f"on {n} cards",
                lambda x: brox_temporal_multiscale_sharded(x, tmesh), vol)
    log(f"brox_temporal_multiscale_sharded output shards on {_where(rn[0])}")
    e = epe(rn[0], rn[1], r1[0], r1[1])
    check(len(_where(rn[0])) == n and e <= 1e-4,
          f"brox_temporal_multiscale_sharded vs 1 card: EPE {e:.3e} <= 1e-04")


def run_phase(name, fn, *args, **kwargs):
    log(f"== phase {name}")
    try:
        return fn(*args, **kwargs)
    except Exception:
        traceback.print_exc()
        check(False, f"phase {name} raised")
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="1 (default): the one-card phases; 4: only the "
                         "multi-device paths, each against one card")
    args = ap.parse_args(argv)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    if len(devs) < args.cards:
        print(f"--cards {args.cards} needs {args.cards} GPUs; JAX found "
              f"{len(devs)}", file=sys.stderr)
        return 2
    from tpuflow.utils.cache import configure_cache

    card = run_phase("device", phase_device, configure_cache())
    if args.cards == 1:
        program = run_phase("batched", phase_batched, card)
        run_phase("clis", phase_clis, card)
        if program is not None:
            run_phase("trace", phase_trace, card, program)
        else:
            check(False, "phase trace skipped: no batched program")
    else:
        devs = devs[:args.cards]
        run_phase("data parallel", lane_dp, card, devs, B=64, ny=NY, nx=NX)
        run_phase("spatial", lane_spatial, card, devs, big=(1080, 1920))
        run_phase("frames", lane_temporal, card, devs, frames=9, ny=NY,
                  nx=NX)
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": args.cards}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
