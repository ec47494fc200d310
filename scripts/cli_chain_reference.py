#!/usr/bin/env python3
"""The JAX package and the port on the CPU, on the cli chain's features
from the card: what the reference reaches on the cli phase's inputs.

    python3 scripts/cli_chain_reference.py --features OUT/cli_chain_features [--skip-dense]

from the repository root (CPU only; JAX is forced to the CPU; about 30
minutes on 4 threads, most of it the JAX package's depthMapEstimation and
the mesh's renders into the 8 views). `--features` is
the folder `scripts/cli_chain_diagnostics_torch.py` writes on the card:
cameraInit.sfm, features/, pairs.txt and matches.npz of
chip_smoke.make_posed_scene's 8 views (1280x960) at the CLI's defaults
(DSP-SIFT). The images are rendered again here (host numpy, the same as on
the card). It prints, as JSON lines:

1. `engine`: incrementalSfm through the JAX CLI and through the port's CLI
   (`--device cpu`) on the card's features, and on features the port
   extracts on the CPU from the same images (matched over the same pairs):
   posed views, ATE (fraction of the ring radius), every rotation error
   after the orientations' alignment, the refined focal;
2. `dense_mesh` (unless `--skip-dense`): the JAX CLI's prepareDenseScene ->
   depthMapEstimation -> depthMapFiltering -> meshSurface on its own SfM of
   the card's features, checked as chip_smoke.check_cli checks the port's:
   each map's median relative depth error and valid fraction, and the
   surface mesh's box-world statistics (`chip_smoke.mesh_box_stats`) and
   agreement with its maps (`chip_smoke.mesh_view_agreement`).

chip_smoke.py's CLI_ROT_DEG and CLI_BOX_* gates are set from these numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu.pipeline import cli as jcli  # noqa: E402
from alicevision_tpu_torch import sfmdata  # noqa: E402
from alicevision_tpu_torch.mesh import load_obj  # noqa: E402
from alicevision_tpu_torch.pipeline import cli as tcli  # noqa: E402

CPU = ["--device", "cpu"]


def pose_report(sfm_path: str, R_true, c_true) -> dict:
    sc = sfmdata.load(sfm_path)
    posed = sc.valid_views()
    rot, _ = chip_smoke.rotation_errors_deg(sc.pose_R[sc.view_pose[posed]], R_true[posed])
    ate = chip_smoke._posed_ate(sfm_path, R_true, c_true)
    return {"n_posed": ate["n_posed"], "landmarks": ate["landmarks"], "ate_frac_of_radius": ate["ate_frac_of_radius"],
            "rotation_err_deg": rot, "max_rotation_err_deg": max(rot), "focal_px": sc.scale.tolist()}


def run(main, argv) -> None:
    if main(argv) != 0:
        raise RuntimeError(f"`{' '.join(argv)}` failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--features", required=True, help="cli_chain_features folder from the card")
    ap.add_argument("--skip-dense", action="store_true", help="the engines only")
    ap.add_argument("--threads", type=int, default=4, help="torch threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    src = os.path.abspath(args.features)
    with open(os.path.join(src, "device.txt")) as f:
        card = f.read().strip()
    work = tempfile.mkdtemp(prefix="cli_chain_ref_")
    try:
        truth_sfm, gt = chip_smoke.make_posed_scene(work, n_views=8)
        truth = sfmdata.load(truth_sfm)
        R_true, c_true = truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose]
        # the card's cameraInit.sfm, its images named by this machine's paths
        init = os.path.join(work, "cameraInit.sfm")
        sc = sfmdata.load(os.path.join(src, "cameraInit.sfm"))
        sc.view_paths = [os.path.join(work, "images", f"{int(v)}.npy") for v in sc.view_ids]
        sfmdata.save(sc, init)
        card_feats, card_matches = os.path.join(src, "features"), os.path.join(src, "matches.npz")

        cpu_feats, cpu_matches = os.path.join(work, "cpu_features"), os.path.join(work, "cpu_matches.npz")
        run(tcli.main, ["featureExtraction", "--input", init, "--output", cpu_feats, *CPU])
        run(tcli.main, ["featureMatching", "--input", init, "--features", cpu_feats, "--pairs",
                        os.path.join(src, "pairs.txt"), "--output", cpu_matches, *CPU])

        sfms = {}
        for feats_tag, feats, matches in (("card_features", card_feats, card_matches),
                                          ("cpu_features", cpu_feats, cpu_matches)):
            for engine, main, extra in (("jax", jcli.main, []), ("port_cpu", tcli.main, CPU)):
                out = os.path.join(work, f"{engine}_{feats_tag}.sfm")
                run(main, ["incrementalSfm", "--input", init, "--features", feats, "--matches", matches,
                           "--output", out, *extra])
                sfms[engine, feats_tag] = out
                print(json.dumps({"engine": engine, "features": feats_tag, "features_from": card,
                                  **pose_report(out, R_true, c_true)}), flush=True)
        if args.skip_dense:
            return 0

        w = os.path.join(work, "jax_chain")
        os.makedirs(w)
        sfm = os.path.join(w, "sfm.sfm")
        shutil.copy(sfms["jax", "card_features"], sfm)
        for argv in (["prepareDenseScene", "--input", sfm, "--output", os.path.join(w, "dense")],
                     ["depthMapEstimation", "--input", sfm, "--images", os.path.join(w, "dense"), "--output",
                      os.path.join(w, "depth")],
                     ["depthMapFiltering", "--input", sfm, "--depth", os.path.join(w, "depth"), "--output",
                      os.path.join(w, "depth_filtered")],
                     ["meshSurface", "--input", sfm, "--depth", os.path.join(w, "depth_filtered"), "--output",
                      os.path.join(w, "mesh.obj")]):
            run(jcli.main, argv)
        rep = chip_smoke.pipeline_report(w, R_true, c_true, gt)
        s, Ra, t = chip_smoke._posed_ate(sfm, R_true, c_true)["alignment"]
        mv, mf = load_obj(os.path.join(w, "mesh.obj"))
        surface = chip_smoke.mesh_box_stats(mv @ (s * Ra).T + t, mf)
        surface.update(chip_smoke.mesh_view_agreement(sfm, os.path.join(w, "mesh.obj"),
                                                      os.path.join(w, "depth_filtered"), gt, s, "cpu"))
        print(json.dumps({"dense_mesh": "jax", "features_from": card,
                          "depth_median_rel_err": rep["depth_median_rel_err"],
                          "depth_valid_frac": rep["depth_valid_frac"], "surface_mesh": surface}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
