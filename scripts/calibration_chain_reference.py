#!/usr/bin/env python3
"""The JAX package's readings for chip_smoke.py's `calibration` phase, on
the CPU: the numbers its gates (`chip_smoke.CAL_GATES`) are set from.

    python3 scripts/calibration_chain_reference.py [--work DIR]

from the repository root. It renders the phase's shoots
(`chip_smoke.make_calibration_inputs`: numpy, seeded, the same files the
card reads), runs the phase's command chain through the JAX CLI
(`alicevision_tpu.pipeline.cli.main`: checkerboardDetection,
checkerboardCalibration, cameraCalibration, convertDistortion,
exportDistortion, distortionCalibration, colorCheckerDetection,
colorCheckerCorrection, sphereDetection, lightingCalibration,
photometricStereo, normalIntegration, lightingEstimation), reads it with
`chip_smoke.calibration_report` and prints each command's seconds and the
report as one JSON line. A few minutes on 4 CPU threads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from alicevision_tpu.pipeline import cli as jcli  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None, help="keep the inputs and outputs here")
    args = ap.parse_args()
    work = args.work or tempfile.mkdtemp(prefix="cal_ref_")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    inputs = chip_smoke.make_calibration_inputs(work)
    print(f"inputs rendered in {inputs['render_s']:.1f} s", flush=True)
    rows = chip_smoke.run_calibration_chain(jcli.main, work, inputs)
    report = chip_smoke.calibration_report(work, inputs)
    print(json.dumps({"calibration_reference": {"report": report,
                                                "chain_seconds": {k: v["seconds"] for k, v in rows.items()},
                                                "seconds": time.perf_counter() - t0}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
