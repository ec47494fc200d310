#!/usr/bin/env python3
"""chip_smoke.py of a checkout, run whole, with the wall seconds of each of
its phases.

    python3 scripts/smoke_phase_times.py [--root DIR] [--out FILE]

from the root of this checkout, on a machine with one CUDA card. It runs
DIR's chip_smoke.main() (by default this checkout's) with DIR first on the
path, and times each outermost call of DIR's chip_smoke functions named
check_*, run_main_path and make_posed_scene, and of its kernel build
(build.build_all): the phases in the order main() runs them. A phase
called twice sums its calls. After the smoke's own output it prints one
line `phase seconds {...}`: each phase's seconds, `other` (the rest of
main(): the inline D = 96 and D = 320 stage runs, the map checks, the
scene's files) and `total`, and with --out writes that object to FILE as
JSON. It exits with the smoke's code. The same wrapper times any commit's
smoke the same way, so two trees unpacked side by side are compared
phase by phase in one call.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose chip_smoke.py runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root, out = os.path.abspath(args.root), args.out and os.path.abspath(args.out)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke

    seconds: dict = {}
    depth = [0]

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            if depth[0]:
                return fn(*a, **kw)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
                depth[0] -= 1
        return run

    for name in list(vars(chip_smoke)):
        fn = getattr(chip_smoke, name)
        if callable(fn) and (name.startswith("check_") or name in ("run_main_path", "make_posed_scene")):
            setattr(chip_smoke, name, timed(name, fn))
    chip_smoke.build.build_all = timed("build_all", chip_smoke.build.build_all)

    t0 = time.perf_counter()
    try:
        rc = chip_smoke.main([])
    finally:
        total = time.perf_counter() - t0
        row = dict(seconds, other=total - sum(seconds.values()), total=total)
        print("phase seconds " + json.dumps(row), flush=True)
        if out:
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as f:
                json.dump(row, f, indent=1)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
