#!/usr/bin/env python3
"""chip_smoke.py's `panorama` phase alone on the card, without its gates:
the numbers to set them against and the stage times.

    python3 scripts/panorama_phase_torch.py [--out DIR]

from the repository root, on a machine with a CUDA card. It renders the
cli phase's 8 views (`chip_smoke.make_posed_scene`), runs its four front
stages in this process (`cli.main`, the CLI's defaults), then
`chip_smoke.run_panorama_phase`, and prints the card's name and power limit
and the `panorama` row as one JSON line (also written to
DIR/panorama_phase.json with `--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.pipeline import cli  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        sfm, _ = chip_smoke.make_posed_scene(work, n_views=8)
        cli_out = os.path.join(work, "cli")
        os.makedirs(cli_out)
        for name, argv in chip_smoke.cli_chain(cli_out, os.path.join(work, "images"),
                                               extra=["--device", str(dev)])[:4]:
            if cli.main(argv) != 0:
                raise RuntimeError(f"{name} failed")
        row = chip_smoke.run_panorama_phase(dev, work, cli_out, sfm, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "panorama_phase.json"), "w") as f:
            json.dump(row, f, indent=1)
    print(json.dumps({"panorama": row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
