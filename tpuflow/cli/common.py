"""Shared CLI plumbing for the seven solver drivers.

The reference CLIs all use the same idiom (e.g. src/tvl1flow_main.cpp
:96-167): positional optional arguments, invalid values clamped back to
the compile-time default with a warning when verbose, and the flow saved
as float32 `.flo`.  We mirror the argument order, defaults and clamping
exactly so shell scripts written for the reference binaries keep
working.  `nproc` is accepted for compatibility and ignored (XLA owns
threading).
"""

import sys

import numpy as np

from tpuflow.io import read_image, write_flow


def enable_persistent_cache():
    """CLI runs are one-shot processes: without the persistent
    compilation cache every invocation would pay the full XLA compile.
    Called by each CLI `main()` (NOT at import time, so importing this
    module has no global side effects) — see tpuflow.utils.cache."""
    from tpuflow.utils.cache import configure_cache

    configure_cache()


class Args:
    """Positional-argument cursor over argv with typed defaults."""

    def __init__(self, argv):
        self.argv = argv
        self.i = 0

    def next(self, default, cast=str):
        v = self.argv[self.i] if self.i < len(self.argv) else None
        self.i += 1
        if v is None:
            return default
        try:
            return cast(v)
        except ValueError:
            return default


def clamp(value, ok, default, name, verbose):
    """Reset `value` to `default` unless ok(value); warn when verbose."""
    if ok(value):
        return value
    if verbose:
        print(f"warning: {name} changed to {default}", file=sys.stderr)
    return default


def load_pair(path0, path1, dtype=np.float32):
    I0 = read_image(path0, gray=True, dtype=np.float64).astype(dtype)
    I1 = read_image(path1, gray=True, dtype=np.float64).astype(dtype)
    if I0.shape != I1.shape:
        print(f"ERROR: input images size mismatch {I0.shape} != {I1.shape}",
              file=sys.stderr)
        raise SystemExit(1)
    return I0, I1


def save_flow(outfile, u, v):
    # extension dispatch (.uv -> JUV) per reference src/iio.cpp:3655-3675
    write_flow(outfile, np.asarray(u), np.asarray(v))
