#!/usr/bin/env python3
"""chip_smoke.py's `codecs` phase alone, on one CUDA card (or `--device
cpu`).

    python3 scripts/codecs_phase_torch.py [--out chiprun_out] [--device cuda] [--small]

Builds native/codecs.cpp and native/jpeg.cpp, renders the pipeline phase's
8-view scene, runs `run_full_pipeline` on its `.npy` images once (so the
TIFF run finds the process warm, as in the smoke), then the `codecs`
phase: the committed TIFF / BMP / PNG / AVI fixtures against
fixtures.json, the 24 MP LZW and deflate TIFFs and BMP, the pipeline from
16-bit camera TIFFs, and keyframeSelection from a 1920x1080 MJPEG AVI.
Prints the phase's summary line and the gates it misses, and exits 1 when
one is missed. With `--out`, writes the full row to
`OUT/codecs_phase.json`. `--small` runs the AVI at 320x240 and 12 frames
(a CPU rehearsal).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch import native  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    smi = ""
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        chip_smoke.build.build_all()
    print(smi, flush=True)
    t0 = time.perf_counter()
    native.build(native.CODECS_SRC)
    native.build(native.JPEG_SRC)
    print(f"build native/codecs.cpp, native/jpeg.cpp: {time.perf_counter() - t0:.2f} s", flush=True)
    work = tempfile.mkdtemp(prefix=".codecs_phase_", dir=chip_smoke.ROOT)
    try:
        t0 = time.perf_counter()
        sfm, gt = chip_smoke.make_posed_scene(work, n_views=8)
        images = os.path.join(work, "images")
        print(f"scene in {time.perf_counter() - t0:.1f} s", flush=True)
        seconds, _ = chip_smoke.run_pipeline(os.path.join(work, "pipe"), images, dev)
        print("pipeline (npy) stage seconds " + json.dumps(seconds), flush=True)
        avi = dict(chip_smoke.CODEC_AVI, wh=(320, 240), frames=12) if args.small else chip_smoke.CODEC_AVI
        row, _ = chip_smoke.run_codecs_phase(dev, work, images, sfm, gt, smi, avi_cfg=avi)
        print("codecs " + json.dumps(chip_smoke.codecs_summary(row)), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "codecs_phase.json"), "w") as f:
                json.dump({"codecs": row, "npy_seconds": seconds}, f, indent=1)
        print("misses: " + json.dumps(row["misses"]), flush=True)
        return 1 if row["misses"] else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
