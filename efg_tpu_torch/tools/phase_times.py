"""Wall seconds of each phase of a checkout's `chip_smoke.py`.

Loads `chip_smoke.py` from the checkout at `--root`, wraps every
module-level `phase_*` function in a timer (a phase called from inside
another phase counts in its caller only), runs the script's `main()` and
prints, after the script's own output, one JSON line

    {"phase_times": {"root": ..., "rc": ..., "total_s": ...,
                     "phase_s": {phase: seconds, ...}}}

with the phases in the order they ran and `rc` the script's own exit
code. The file imports nothing of the checkout itself, so one copy times
any checkout, an older one too; two checkouts timed in one run on one
card compare phase by phase:

    python efg_tpu_torch/tools/phase_times.py --root <checkout> [--flagship]

`--flagship` runs only the script's first phases (`device`, `slice`:
the flagship's serving batches, `train`: its timed training steps) in
place of `main()`, so that many short runs of two checkouts alternate
in one call. `host_ms` is the median time of a fixed numpy sort on the
host, taken before and after: it shows how fast the shared host was
while the run's host-bound phases ran.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys
import time


def _timed(fn, name, out, depth):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            depth[0] -= 1
            if depth[0] == 0:
                out[name] = out.get(name, 0.0) + time.perf_counter() - t0

    return run


def _host_ms() -> float:
    import numpy as np

    x = np.random.RandomState(0).rand(2_000_000)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.sort(x)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[2]


def _flagship(smoke) -> int:
    """The script's device check, serving and training phases of the
    flagship, as its `main()` starts."""
    card = smoke.phase_device()
    md, _ = smoke.make_model(smoke.FLAGSHIP, "cuda")
    smoke.phase_slice(md)
    smoke.phase_train(md, card)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose chip_smoke.py is timed")
    ap.add_argument("--flagship", action="store_true",
                    help="run the device, slice and train phases only")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke  # its spawned ranks import it by this name
    sys.path.insert(0, root)
    spec.loader.exec_module(smoke)
    phase_s, depth = {}, [0]
    for name in [n for n in vars(smoke) if n.startswith("phase_")]:
        fn = getattr(smoke, name)
        if callable(fn):
            setattr(smoke, name, _timed(fn, name[len("phase_"):], phase_s, depth))
    host_before = _host_ms()
    t0 = time.perf_counter()
    rc = _flagship(smoke) if args.flagship else smoke.main()
    total = time.perf_counter() - t0
    print(json.dumps({"phase_times": {"root": root, "rc": rc, "total_s": total,
                                      "phase_s": phase_s,
                                      "host_ms": [host_before, _host_ms()]}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
