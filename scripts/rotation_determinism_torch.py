#!/usr/bin/env python3
"""Whether panoramaEstimation writes the same scene on every run on the card.

    python3 scripts/rotation_determinism_torch.py [--repeats 8] [--out DIR]

from the repository root, on a machine with a CUDA card. It makes
chip_smoke.py's `panorama` phase inputs, runs that phase's chain up to the
exhaustive featureMatching in this process (`cli.main`), then
panoramaEstimation `--repeats` times on the same files and counts the
distinct .sfm files they write (chip_smoke's `nodal_equal` gate needs 1).
It also counts the distinct results of each piece on the run's 66 edges:
rotation averaging (`rotation_averaging_l2`, two IRLS steps) on the pairs'
relative rotations, and a degree sum over the edges with float weights by
`index_add` (atomic adds on a card) and by `index_put_(accumulate=True)`
(a sorted accumulation), `--op-repeats` times each. Prints the card's name
and power limit and one JSON line (also DIR/rotation_determinism.json with
`--out`).
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu_torch import sfmdata  # noqa: E402
from alicevision_tpu_torch.pipeline import cli  # noqa: E402
from alicevision_tpu_torch.sfm.global_sfm import rotation_averaging_l2  # noqa: E402
from alicevision_tpu_torch.sfm.rotation_sfm import robust_rotation  # noqa: E402


def _distinct(results) -> int:
    return len({r.cpu().numpy().tobytes() for r in results})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--op-repeats", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        inputs = chip_smoke.make_panorama_inputs(work, dev)
        steps = chip_smoke.panorama_chain(work, inputs["focal_px"])
        last = [n for n, _ in steps].index("featureMatching")
        for name, argv in steps[:last + 1]:
            if cli.main([name, *argv, "--device", str(dev)]) != 0:
                raise RuntimeError(f"{name} failed")
        est = next(argv for name, argv in steps if name == "panoramaEstimation")  # the exhaustive one
        out_at = est.index("--output") + 1
        scenes = []
        for k in range(args.repeats):
            argv = est[:out_at] + [os.path.join(work, f"panorama_{k}.sfm")] + est[out_at + 1:]
            if cli.main(["panoramaEstimation", *argv, "--device", str(dev)]) != 0:
                raise RuntimeError("panoramaEstimation failed")
            with open(argv[out_at], "rb") as f:
                scenes.append(f.read())

        sc = sfmdata.load(os.path.join(work, "cameraInit.sfm"))
        pairs = cli.rotation_pair_bearings(sc, os.path.join(work, "features"), os.path.join(work, "matches.npz"), dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        size = (float(sc.sizes[0, 0]), float(sc.sizes[0, 1]))
        R_rel = torch.stack([robust_rotation(gen, bi, bj, float(np.mean(sc.scale)), size)[0]
                             for bi, bj in pairs.values()])
        edges = np.array(list(pairs))
        averaged = [rotation_averaging_l2(sc.n_views, edges, R_rel, irls_iters=2) for _ in range(args.op_repeats)]

        idx = torch.as_tensor(edges, dtype=torch.int64, device=dev)
        w = torch.as_tensor(np.random.RandomState(0).uniform(1.0, 10.0, len(edges)), dtype=torch.float32, device=dev)
        zeros = torch.zeros(sc.n_views, dtype=torch.float32, device=dev)
        by_add = [zeros.index_add(0, idx[:, 0], w).index_add(0, idx[:, 1], w) for _ in range(args.op_repeats)]
        by_put = [zeros.clone().index_put_((idx.T.reshape(-1),), torch.cat([w, w]), accumulate=True)
                  for _ in range(args.op_repeats)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    row = {"device": smi, "edges": len(edges), "panoramaEstimation_runs": args.repeats,
           "panoramaEstimation_distinct_scenes": len(set(scenes)), "op_repeats": args.op_repeats,
           "rotation_averaging_l2_distinct": _distinct(averaged), "degree_index_add_distinct": _distinct(by_add),
           "degree_index_put_distinct": _distinct(by_put)}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "rotation_determinism.json"), "w") as f:
            json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
