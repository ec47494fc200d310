#!/usr/bin/env python3
"""The `cli` phase's texture atlas fill, the port on the card against the
JAX package's texturing of the same mesh, views and depth maps.

    python3 scripts/cli_atlas_fill_reference.py --out DIR [--repeats N]   # on the card
    python3 scripts/cli_atlas_fill_reference.py --inputs DIR/cli_texturing_inputs   # on the CPU

On the card (from the repository root): `chip_smoke.make_posed_scene`'s 8
views through the first 11 commands of `chip_smoke.cli_chain` (cameraInit
to texturing, one process a stage), N times; each run's atlas fills
(`chip_smoke.atlas_fills`: the share of the 2048² atlas's texels above 0,
and that share inside the faces' UV triangles, as the phase reads them),
and the filtered mesh's vertices and faces and their share in the box
world (`chip_smoke.mesh_box_stats`, the mesh mapped into the rendered
frame by the similarity that aligns the reconstruction's camera centres
to the truth's, as the phase maps its surface mesh) are printed as JSON
lines, and the first run's texturing inputs (the posed .sfm, the filtered
mesh, the dense images and the depth maps, ~50 MB) are copied to
DIR/cli_texturing_inputs/. On the CPU: texturing of those inputs at the
phase's atlas size through the JAX CLI and through the port's
(`--device cpu`), each atlas's fills printed as one JSON line.
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

import chip_smoke  # noqa: E402

INPUTS = ("sfm.sfm", "mesh_filtered.obj", "dense", "depth")


def card(out: str, repeats: int) -> int:
    from alicevision_tpu_torch import mesh as meshm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    try:
        posed_sfm, _ = chip_smoke.make_posed_scene(work, n_views=8)
        truth = chip_smoke.sfmdata.load(posed_sfm)
        R_true, c_true = truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose]
        for k in range(repeats):
            run, logs = os.path.join(work, f"cli{k}"), os.path.join(work, f"logs{k}")
            os.makedirs(run)
            os.makedirs(logs)
            for name, argv in chip_smoke.cli_chain(run, os.path.join(work, "images"), ("--device", "cuda:0"))[:11]:
                res = chip_smoke.run_cli_process(argv, os.path.join(logs, name))
                if res["rc"] != 0:
                    raise RuntimeError(f"{name} exited {res['rc']}")
            s, Ra, t = chip_smoke._posed_ate(os.path.join(run, "sfm.sfm"), R_true, c_true)["alignment"]
            v, f = meshm.load_obj(os.path.join(run, "mesh_filtered.obj"))
            print(json.dumps({"run": k, **chip_smoke.atlas_fills(os.path.join(run, "textured.obj")),
                              "filtered_mesh": chip_smoke.mesh_box_stats(np.asarray(v) @ (s * Ra).T + t,
                                                                         np.asarray(f))}), flush=True)
            if k == 0:
                dst = os.path.join(out, "cli_texturing_inputs")
                os.makedirs(dst, exist_ok=True)
                for name in INPUTS:
                    src = os.path.join(run, name)
                    (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, os.path.join(dst, name))
                with open(os.path.join(dst, "card.txt"), "w") as fo:
                    fo.write(smi + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def reference(inputs: str) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from alicevision_tpu.pipeline import cli as jcli
    from alicevision_tpu_torch.pipeline import cli as tcli

    work = tempfile.mkdtemp(prefix="atlas_ref_")
    argv = ["texturing", "--input", os.path.join(inputs, "sfm.sfm"), "--mesh",
            os.path.join(inputs, "mesh_filtered.obj"), "--images", os.path.join(inputs, "dense"), "--depth",
            os.path.join(inputs, "depth"), "--atlasSize", str(chip_smoke.CLI_ATLAS)]
    fills = {}
    for pkg, main, extra in (("jax", jcli.main, ()), ("port", tcli.main, ("--device", "cpu"))):
        out = os.path.join(work, f"{pkg}.obj")
        if main([*argv, "--output", out, *extra]) != 0:
            raise RuntimeError(f"{pkg} texturing failed")
        fills[pkg] = chip_smoke.atlas_fills(out)
    print(json.dumps({"fills": fills, "gate": chip_smoke.CLI_MIN_FOOTPRINT_FILL}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="on the card: where the first run's inputs go")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--inputs", default=None, help="on the CPU: a saved cli_texturing_inputs/")
    args = ap.parse_args()
    if args.inputs:
        return reference(args.inputs)
    return card(args.out or "chiprun_out", args.repeats)


if __name__ == "__main__":
    raise SystemExit(main())
