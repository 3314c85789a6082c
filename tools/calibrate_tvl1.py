#!/usr/bin/env python3
"""Calibrate the TV-L1 fixed-iteration schedule from the REFERENCE
binary's own data-dependent stopping behavior (the HS analog is
tools/hs_calibration.json).

Runs `/tmp/refbuild/tvl1flow` (tools/build_reference.sh) with verbose=1
on bench-geometry synthetic pairs, parses the per-scale per-warp
`Warping: w, Iterations: n, Error: e` stderr lines
(reference src/tvl1flow.cpp:184-188), and writes
tools/tvl1_calibration.json: per level size, the observed per-warp
stopping iterations and a 1.3x envelope usable as a fixed schedule.

Usage: python tools/calibrate_tvl1.py [n_pairs]
"""

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

BIN = "/tmp/refbuild/tvl1flow"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "tvl1_calibration.json")


def run_pair(I0, I1, tmp):
    from tpuflow.io import write_image

    a = os.path.join(tmp, "a.png")
    b = os.path.join(tmp, "b.png")
    write_image(a, np.clip(I0, 0, 255).astype(np.uint8))
    write_image(b, np.clip(I1, 0, 255).astype(np.uint8))
    p = subprocess.run(
        [BIN, a, b, os.path.join(tmp, "o.flo"),
         "1", "0.25", "0.15", "0.3", "100", "0.5", "5", "0.01", "1"],
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=3600)
    scales = []  # list of (nx, ny, [iters per warp])
    cur = None
    for line in p.stderr.splitlines():
        m = re.match(r"Scale (\d+): (\d+)x(\d+)", line)
        if m:
            cur = {"scale": int(m.group(1)), "nx": int(m.group(2)),
                   "ny": int(m.group(3)), "iters": []}
            scales.append(cur)
            continue
        m = re.match(r"Warping: (\d+), Iterations: (\d+)", line)
        if m and cur is not None:
            cur["iters"].append(int(m.group(2)))
    return scales


def main():
    from bench import synth_pair

    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    if not os.path.exists(BIN):
        sys.exit(f"{BIN} missing — run tools/build_reference.sh first")

    by_size = {}
    with tempfile.TemporaryDirectory() as tmp:
        for s in range(n_pairs):
            I0, I1 = synth_pair(seed=100 + s)
            for sc in run_pair(I0, I1, tmp):
                key = f"{sc['nx']}x{sc['ny']}"
                by_size.setdefault(key, []).append(sc["iters"])

    out = {"note": "reference tvl1flow verbose stopping iterations at "
                   "default params (tau=.25 lambda=.15 theta=.3 "
                   "zfactor=.5 nwarps=5 epsilon=.01); envelope = "
                   "ceil(1.3 * max over pairs) per warp",
           "sizes": {}}
    for key, runs in sorted(by_size.items(),
                            key=lambda kv: -np.prod(
                                [int(x) for x in kv[0].split("x")])):
        arr = np.asarray(runs)  # (pairs, warps)
        env = np.ceil(1.3 * arr.max(axis=0)).astype(int).tolist()
        out["sizes"][key] = {"observed": arr.tolist(), "envelope": env}
        print(key, "envelope", env, flush=True)

    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
