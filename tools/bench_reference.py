#!/usr/bin/env python3
"""Measure the reference binaries' CPU throughput to anchor vs_baseline.

Builds (if needed) via tools/build_reference.sh, generates the same
synthetic 1024x436 pair bench.py uses, times the reference `tvl1flow`
and `horn_schunck_pyramidal` CLIs with default parameters using all CPU
cores, and writes the measurement artifact
tools/baseline_measured.json that bench.py reads for `vs_baseline`.
"""

import json
import os
import platform
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import synth_pair, synth_triplet
from tpuflow.io import write_image

BUILD = os.environ.get("REF_BUILD", "/tmp/refbuild")
ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline_measured.json")


def main():
    if not os.path.exists(os.path.join(BUILD, "tvl1flow")):
        subprocess.run(["bash", os.path.join(os.path.dirname(__file__),
                                             "build_reference.sh")], check=True)
    I0, I1 = synth_pair()
    results = {}
    with tempfile.TemporaryDirectory() as d:
        p0 = os.path.join(d, "i0.png")
        p1 = os.path.join(d, "i1.png")
        write_image(p0, I0.clip(0, 255).astype("uint8"))
        write_image(p1, I1.clip(0, 255).astype("uint8"))

        # third frame for tvl1occflow: backward warp of the base frame
        Im1, _, _ = synth_triplet(436, 1024)
        pm1 = os.path.join(d, "im1.png")
        write_image(pm1, Im1.clip(0, 255).astype("uint8"))

        # 9-frame drifting sequence for brox_temporal (same drift flow
        # family as the pair; r5 — anchors the all-seven artifact)
        frames = [I0.astype(np.float64)]
        NY, NX = I0.shape
        du = 2.0 * np.sin(np.linspace(0, 3, NX))[None, :]
        dv = 1.5 * np.cos(np.linspace(0, 2, NY))[:, None]
        yy, xx = np.mgrid[0:NY, 0:NX].astype(np.float64)
        for _ in range(8):
            sx = np.clip(xx + du, 0, NX - 1)
            sy = np.clip(yy + dv, 0, NY - 1)
            x0 = np.clip(np.floor(sx).astype(int), 0, NX - 2)
            y0 = np.clip(np.floor(sy).astype(int), 0, NY - 2)
            fx, fy = sx - x0, sy - y0
            pr = frames[-1]
            frames.append(pr[y0, x0] * (1 - fx) * (1 - fy)
                          + pr[y0, x0 + 1] * fx * (1 - fy)
                          + pr[y0 + 1, x0] * (1 - fx) * fy
                          + pr[y0 + 1, x0 + 1] * fx * fy)
        fpaths = []
        for k, fr in enumerate(frames):
            fp = os.path.join(d, f"seq{k}.png")
            write_image(fp, fr.clip(0, 255).astype("uint8"))
            fpaths.append(fp)
        os.makedirs(os.path.join(d, "bt"), exist_ok=True)

        repeats = int(os.environ.get("REF_BENCH_REPEATS", "3"))
        slow = {"brox_temporal", "tvl1occflow", "brox_spatial",
                "robust_expo_methods"}
        # per-method work-unit count for the fields/s conversion
        # (brox_temporal solves 8 flow fields per run)
        units = {"brox_temporal": 8}
        for name, cmd in (
            ("tvl1flow", [os.path.join(BUILD, "tvl1flow"), p0, p1,
                          os.path.join(d, "f.flo")]),
            ("horn_schunck_pyramidal", [os.path.join(BUILD, "horn_schunck_pyramidal"),
                                        p0, p1, os.path.join(d, "g.flo")]),
            ("horn_schunck_classic", [os.path.join(BUILD, "horn_schunck_classic"),
                                      "100", "7", p0, p1,
                                      os.path.join(d, "h.flo")]),
            ("brox_spatial", [os.path.join(BUILD, "brox_spatial"), p0, p1,
                              os.path.join(d, "b.flo")]),
            ("robust_expo_methods", [os.path.join(BUILD, "robust_expo_methods"),
                                     p0, p1, os.path.join(d, "r.flo")]),
            ("tvl1occflow", [os.path.join(BUILD, "tvl1occflow"), pm1, p0, p1,
                             p0, os.path.join(d, "o.flo"),
                             os.path.join(d, "occ.png")]),
            ("brox_temporal", [os.path.join(BUILD, "brox_temporal"), "9",
                               *fpaths, "18", "7", "100", "0.75", "0.0001",
                               "1", "15", os.path.join(d, "bt")]),
        ):
            # N repeats, take the BEST (minimum) time: a shared container
            # can only slow the binary down, never speed it up, so min is
            # the fairest estimate of the machine's real capability and is
            # robust to the load spikes that produced the bogus r2 artifact
            n_rep = 1 if name in slow else repeats
            times = []
            for _ in range(n_rep):
                t0 = time.perf_counter()
                subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
                times.append(time.perf_counter() - t0)
            dt = min(times)
            spread = max(times) / dt
            fields = units.get(name, 1)
            print(f"{name}: best {dt:.2f} s = {fields/dt:.4f} fields/s "
                  f"over {n_rep} runs (max/min spread {spread:.2f}x, "
                  f"cores={os.cpu_count()})", flush=True)
            if spread > 2.0:
                print(f"WARNING: {name} timing spread >2x — container under "
                      "load; rerun on an idle machine", file=sys.stderr)
            results[name] = round(fields / dt, 4)
    # sanity check vs an existing artifact before overwriting it
    try:
        with open(ARTIFACT) as f:
            prev = json.load(f)["fields_per_sec"]
        for name, val in results.items():
            old = prev.get(name)
            if old and not (0.5 <= val / old <= 2.0):
                print(f"WARNING: {name} deviates >2x from existing artifact "
                      f"({old} -> {val} fields/s)", file=sys.stderr)
    except (OSError, KeyError, ValueError):
        pass
    artifact = {
        "shape": "1024x436",
        "unit": "fields/s",
        "cores": os.cpu_count(),
        "machine": platform.machine(),
        "measured_at": time.strftime("%Y-%m-%d"),
        "fields_per_sec": results,
    }
    with open(ARTIFACT, "w") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")
    print(f"wrote {ARTIFACT}")


if __name__ == "__main__":
    main()
