#!/usr/bin/env python3
"""The JAX package's CLI on the CPU, on the inputs of chip_smoke.py's
`panorama` phase: what the reference reaches there, to set the phase's
gates.

    python3 scripts/panorama_chain_reference.py [--work DIR]

from the repository root (CPU only; JAX is forced to the CPU; about 40
minutes, most of it the JAX package's RANSAC compiled eagerly pair by
pair). It makes
the phase's inputs with `chip_smoke.make_panorama_inputs` (the procedural
equirect radiance, its 12 views of 1024^2 split by the port on the CPU, 3
Laguerre brackets a view), runs `chip_smoke.panorama_chain` through the
JAX CLI (`alicevision_tpu.pipeline.cli.main`), and prints, as JSON lines:

1. `seconds`: each command's seconds;
2. `report`: `chip_smoke.panorama_report` of the JAX chain's outputs
   (Laguerre phi, the merged views' correlation with the truth, the
   rotation errors of panoramaEstimation at the CLI's default exhaustive
   pairs and on sequential pairs, the exhaustive run's overlapping pairs
   before the averaging as the port's engine estimates them on the CPU
   from the JAX chain's matches, the panoramas' median relative errors at
   the width of 2048);
3. `jax_pairs`: those overlapping pairs as the JAX package's engine
   estimates them (`overlap_pair_errors` below);
4. `large`: the JAX package's `warp_to_equirect` + `composite_panorama` of
   the merged views at the phase's 8192 (~3.5 minutes and ~11 GB of host
   memory), with its median error and seconds;
5. `global`: relativePoseEstimating -> globalSfM through the JAX CLI on
   the features of the cli phase's 8 rendered views
   (`chip_smoke.make_posed_scene`, the port's front end on the CPU at the
   CLI's defaults, as scripts/cli_chain_reference.py uses them):
   posed views, rotation errors and ATE against the rendered poses.

chip_smoke.py's PANO_* and GLOBAL_* gates are set from its numbers.
`--work` keeps the chain's outputs in DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu.pipeline import cli as jcli  # noqa: E402
from alicevision_tpu_torch.pipeline import cli as tcli  # noqa: E402

CPU = ["--device", "cpu"]


def large_composite(work: str, inputs: dict) -> dict:
    """The JAX warp and composite of the merged views at
    `chip_smoke.PANO_WIDTH_LARGE`, with the rotations the chain warps with
    (`chip_smoke.PANO_WARP_FROM`)."""
    import jax.numpy as jnp

    from alicevision_tpu import sfmdata
    from alicevision_tpu.panorama import composite_panorama, warp_to_equirect

    sc = sfmdata.load(os.path.join(work, chip_smoke.PANO_WARP_FROM))
    width = chip_smoke.PANO_WIDTH_LARGE
    K = jnp.asarray(inputs["K"], jnp.float32)
    t0 = time.perf_counter()
    warps, masks = [], []
    for v in range(sc.n_views):
        img = jnp.asarray(np.load(os.path.join(work, "merged", f"view_{v:02d}.npy")))
        w, m = warp_to_equirect(img, K, jnp.asarray(sc.pose_R[sc.view_pose[v]], jnp.float32), (width, width // 2))
        warps.append(w)
        masks.append(m)
    pano = np.asarray(composite_panorama(jnp.stack(warps), jnp.stack(masks)))
    seconds = time.perf_counter() - t0
    covered = np.asarray(jnp.any(jnp.stack(masks), axis=0))
    return {"width": width, "seconds": seconds, "covered_frac": float(covered.mean()),
            "median_rel_err": chip_smoke.panorama_error(pano, inputs["gt"], covered)}


def overlap_pair_errors(work: str, inputs: dict) -> dict:
    """`chip_smoke.overlap_pair_errors` with the JAX package's engine: its
    `robust_rotation` on each pair of the exhaustive run (the port's CPU
    bearings of the same matches), with the key that `RotationSfM.run`
    splits off for the pair from PRNGKey(0); the errors of the overlapping
    pairs against the truth R_j R_i^T, keyed "i_j"."""
    import jax.numpy as jnp

    from alicevision_tpu.sfm.rotation_sfm import robust_rotation
    from alicevision_tpu_torch import sfmdata

    sc = sfmdata.load(os.path.join(work, "cameraInit.sfm"))
    focal, im_size = float(np.mean(sc.scale)), (float(sc.sizes[0, 0]), float(sc.sizes[0, 1]))
    key, out = jax.random.PRNGKey(0), {}
    for (i, j), (bi, bj) in tcli.rotation_pair_bearings(sc, os.path.join(work, "features"),
                                                        os.path.join(work, "matches.npz"), "cpu").items():
        key, k = jax.random.split(key)
        R, _, _ = robust_rotation(k, jnp.asarray(bi.numpy()), jnp.asarray(bj.numpy()), focal, im_size)
        truth = inputs["R"][j] @ inputs["R"][i].T
        if chip_smoke._angle_deg(truth) < chip_smoke.PANO_FOV_DEG:
            out[f"{i}_{j}"] = chip_smoke._angle_deg(np.asarray(R, np.float64) @ truth.T)
    return out


def global_sfm(work: str) -> dict:
    """relativePoseEstimating -> globalSfM through the JAX CLI on the port's
    CPU features of the cli phase's 8 rendered views."""
    from alicevision_tpu_torch import sfmdata

    posed, _ = chip_smoke.make_posed_scene(work, n_views=8)
    truth = sfmdata.load(posed)
    R_true, c_true = truth.pose_R[truth.view_pose], truth.pose_c[truth.view_pose]
    out = os.path.join(work, "cli")
    os.makedirs(out, exist_ok=True)
    seconds = {}
    for name, argv in chip_smoke.cli_chain(out, os.path.join(work, "images"), extra=CPU)[:4]:
        t0 = time.perf_counter()
        assert tcli.main(argv) == 0, name
        seconds[name] = time.perf_counter() - t0
    res = {"front_seconds_port_cpu": seconds}
    for tag, main, extra in (("jax", jcli.main, []), ("port_cpu", tcli.main, CPU)):
        rel, glob = os.path.join(out, f"{tag}_rel.npz"), os.path.join(out, f"{tag}_global.sfm")
        t0 = time.perf_counter()
        args = ["--input", os.path.join(out, "cameraInit.sfm"), "--features", os.path.join(out, "features"),
                "--matches", os.path.join(out, "matches.npz")]
        assert main(["relativePoseEstimating", *args, "--output", rel, *extra]) == 0
        assert main(["globalSfM", *args, "--relativePoses", rel, "--output", glob, *extra]) == 0
        res[tag] = chip_smoke.global_sfm_report(glob, R_true, c_true)
        res[tag]["seconds"] = time.perf_counter() - t0
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None, help="working folder (default: a temporary one, removed)")
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    work = args.work or tempfile.mkdtemp(prefix="pano_ref_")
    try:
        inputs = chip_smoke.make_panorama_inputs(work, "cpu")
        rows = chip_smoke.run_panorama_chain(jcli.main, work, inputs)
        print(json.dumps({"seconds": {k: v["seconds"] for k, v in rows.items()}}), flush=True)
        print(json.dumps({"report": chip_smoke.panorama_report(work, inputs, "cpu")}), flush=True)
        print(json.dumps({"jax_pairs": overlap_pair_errors(work, inputs)}), flush=True)
        print(json.dumps({"large": large_composite(work, inputs)}), flush=True)
        print(json.dumps({"global": global_sfm(os.path.join(work, "global"))}), flush=True)
    finally:
        if not args.work:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
