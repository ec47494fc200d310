#!/usr/bin/env python3
"""chip_smoke.py's `scaleout` phase alone, on the card.

    python3 scripts/scaleout_phase_torch.py [--out DIR]

from the repository root, on a machine with a CUDA card. It builds the
port's kernels, renders the dense phase's 8 views
(`chip_smoke.make_posed_scene`), runs prepareDenseScene and then
`chip_smoke.check_scaleout` (an nccl group of one rank: the sharded BA,
make_sharded_sgm, the ring-halo filter, the comms tables at one shard),
and prints the phase's row beside the card's name and power limit; a
missed check raises. With `--out`, the row is also written there as
`scaleout_row.json`. About a minute on an H100.
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
from alicevision_tpu_torch.ops import build  # noqa: E402
from alicevision_tpu_torch.pipeline import stages  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write scaleout_row.json here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    work = tempfile.mkdtemp(prefix=".chip_smoke_scaleout_", dir=ROOT)
    try:
        sfm, _ = chip_smoke.make_posed_scene(work, n_views=8)
        dense = os.path.join(work, "dense")
        stages.prepare_dense_scene(sfm, dense, device=dev)
        row, _ = chip_smoke.check_scaleout(dev, work, sfm, dense, smi)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "scaleout_row.json"), "w") as f:
                json.dump(row, f, indent=1)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
