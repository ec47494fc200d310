#!/usr/bin/env python3
"""chip_smoke.py's `aux` phase alone, on the card, with its gates read but
not enforced.

    python3 scripts/aux_phase_torch.py [--out DIR]

from the repository root, on a machine with a CUDA card. It renders the
dense phase's 8 views (`chip_smoke.make_posed_scene`), runs the cli phase's
front commands that the aux phase reads (cameraInit, featureExtraction,
imageMatching, featureMatching) in this process through the port's
`cli.main` on the card, then `chip_smoke.run_aux_phase`, and prints the
row, the gates with the JAX readings they come from (when
`chip_smoke.AUX_REFERENCE` holds them), and the gates it misses, each as
one JSON line, beside the card's name and power limit. With `--out`, the
row is also written there as `aux_row.json`. About 2 minutes on an H100.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.pipeline.cli import main as cli_main  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write aux_row.json here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)  # the CUDA context, before its memory statistics are read
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix="aux_")
    try:
        t0 = time.perf_counter()
        chip_smoke.make_posed_scene(work, n_views=8)
        cli = os.path.join(work, "cli")
        os.makedirs(cli)
        chain = [c for c in chip_smoke.cli_chain(cli, os.path.join(work, "images"))
                 if c[0] in ("cameraInit", "featureExtraction", "imageMatching", "featureMatching")]
        rows = chip_smoke.run_chain(cli_main, [(n, a[1:]) for n, a in chain], "cli front", ("--device", str(dev)),
                                    dev)
        print(json.dumps({"cli_front_seconds": {k: v["seconds"] for k, v in rows.items()},
                          "setup_s": time.perf_counter() - t0}), flush=True)
        row = chip_smoke.run_aux_phase(dev, work, cli, os.path.join(work, "images"), smi=smi)
        print(json.dumps({"aux": row}), flush=True)
        if chip_smoke.AUX_REFERENCE:
            row["gates"] = chip_smoke.aux_gates()
            print(json.dumps({"gates": row["gates"]}), flush=True)
            print(json.dumps({"misses": chip_smoke.aux_misses(row)}), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "aux_row.json"), "w") as f:
                json.dump(row, f, indent=1)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
