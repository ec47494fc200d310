#!/usr/bin/env python3
"""The JAX package's readings for chip_smoke.py's `localization` phase, on
the CPU: the numbers its gates are set from.

    python3 scripts/localization_reference.py --inputs DIR [--work DIR]
        [--solver-batch N] [--marker-frames N] [--keys K] [--first-key F] [--sweep-only]
        [--runs A,B]

DIR is `scripts/localization_phase_torch.py --out`'s localization_inputs/
(the card's hard-scene reconstruction with feature ids, and the features
its observations name). The script renders the phase's queries and rig
scenes on the CPU (`chip_smoke.make_localization_inputs`, float64: the
card's render agrees within 1e-6 on all but ~0.1 % of the pixels), runs
the phase's command chain through the JAX CLI (`alicevision_tpu.pipeline.
cli.main`: cameraLocalization by both methods, rigCalibration,
rigTransform, sfmToRig, rigLocalization by both fusions and the scene
tools), reads it with `chip_smoke.localization_report`, then runs the JAX
solvers on `chip_smoke.solver_samples` and the JAX marker path on
`chip_smoke.render_marker_frames`, and prints one JSON line. About 15
minutes on 4 CPU threads, most of it JAX compiling its SIFT and RANSAC.

With --keys K, each cameraLocalization run of the phase is repeated with
the JAX CLI's loop for draws k = 0..K-1, or F..F+K-1 with --first-key F
(`key_sweep`: the vocabulary tree trained with seed k, RANSAC keys split
from PRNGKey(k); draw 0 is the CLI's), and the right and wrong successes of each draw are printed, as
`scripts/localization_phase_torch.py --seeds` prints the port's;
--sweep-only skips the rest, and --runs limits the sweep to those runs
(chip_smoke.LOC_SWEEP_RUNS are the ones its K-draw gates read).
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

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu import multiview as jmv  # noqa: E402
from alicevision_tpu.features.markers import MarkerDetection  # noqa: E402
from alicevision_tpu.localization import localize_by_markers, refine_sequence  # noqa: E402
from alicevision_tpu.pipeline import cli as jcli  # noqa: E402
from alicevision_tpu.pipeline import stages as jst  # noqa: E402
from alicevision_tpu_torch import sfmdata  # noqa: E402
from alicevision_tpu_torch.utils.rendered import _ring_cameras  # noqa: E402


def _recovered(f, ok, focal, k=None, k1=None):
    near = ok & (np.abs(f - focal) < 0.01 * focal)
    if k is not None:
        near &= np.abs(k - k1) < 0.01
    return float(near.any(-1).mean())


def jax_solvers(n: int) -> dict:
    """The JAX solvers on chip_smoke.solver_samples(n), jitted, timed on the
    CPU (second call), with the phase's readings."""
    smp = chip_smoke.solver_samples(n)
    lo, hi = chip_smoke.LOC_SOLVER_F
    calls = {
        "resection_dlt6": (jax.jit(jmv.resection_dlt6), (smp["world"], smp["xn"])),
        "epnp": (jax.jit(jmv.epnp), (smp["world"], smp["xn"])),
        "p4pf": (jax.jit(lambda w, p: jmv.p4pf(w, p, lo, hi)), (smp["world"][:, :4], smp["px"][:, :4])),
        "p5pfr": (jax.jit(lambda w, p: jmv.p5pfr(w, p, lo, hi)), (smp["world"][:, :5], smp["px_k1"][:, :5])),
    }
    rows = {}
    for name, (fn, args) in calls.items():
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        out = [np.asarray(x) for x in jax.block_until_ready(fn(*args))]
        row = {"samples": n, "cpu_ms": (time.perf_counter() - t0) * 1e3}
        if name in ("resection_dlt6", "epnp"):
            err = np.array([chip_smoke._angle_deg(a @ b.T) for a, b in zip(out[0], smp["R"])])
            row["valid"] = float(out[2].mean())
            row["non_finite"] = float(np.isnan(err).mean())  # JAX's EPnP gives NaN poses on a few samples
            row["rot_err_deg_median"] = float(np.nanmedian(err))
        elif name == "p4pf":
            row["recovered"] = _recovered(out[2], out[3], smp["focal"])
        else:
            row["recovered"] = _recovered(out[2], out[4], smp["focal"], out[3], chip_smoke.LOC_SOLVER_K1)
        rows[name] = row
    return rows


def jax_markers(work: str, frames: int) -> dict:
    """chip_smoke.check_marker_sequence through the JAX package."""
    m = chip_smoke.LOC_MARKER
    wh, focal_px = m["wh"], m["focal_px"]
    imgs, R_gt, c_gt, centres = chip_smoke.render_marker_frames(frames, wh, focal_px, m["tags"])
    folder = os.path.join(work, "marker_images")
    os.makedirs(folder, exist_ok=True)
    for k, img in enumerate(imgs):
        np.save(os.path.join(folder, f"m_{k:02d}.npy"), img)
    scene = os.path.join(work, "marker_init.sfm")
    jst.camera_init(folder, scene, default_focal_px=focal_px)
    feats = os.path.join(work, "marker_features")
    jst.feature_extraction(scene, feats, downscale_to=0, describer_types="tag16h5")
    sc = sfmdata.load(scene)
    f0 = focal_px * m["focal0"]
    key = jax.random.PRNGKey(0)
    Rs, ts, world, uv, detected = [], [], [], [], []
    for v in range(sc.n_views):
        with np.load(os.path.join(feats, f"{int(sc.view_ids[v])}.tag16h5.npz")) as z:
            ids, xy = z["ids"], z["xy"]
        detected.append(int(len(ids)))
        key, k1 = jax.random.split(key)
        res = localize_by_markers(k1, [MarkerDetection(int(i), p, None, 1.0) for i, p in zip(ids, xy)], centres, f0,
                                  (float(wh[0]), float(wh[1])))
        Rs.append(res.R)
        ts.append(-res.R @ res.c)
        world.append(np.stack([centres[int(i)] for i in ids]))
        uv.append(xy)
    M = max(len(x) for x in world)
    world_p = np.stack([np.pad(x, ((0, M - len(x)), (0, 0))) for x in world])
    uv_p = np.stack([np.pad(x, ((0, M - len(x)), (0, 0))) for x in uv])
    mask = np.stack([np.arange(M) < len(x) for x in world])
    out = refine_sequence(np.stack(Rs), np.stack(ts), world_p, uv_p, mask, f0, (wh[0] / 2.0, wh[1] / 2.0))
    c_est = -np.einsum("fji,fj->fi", np.asarray(out.R), np.asarray(out.t))
    return {"frames": frames, "tags_detected": detected, "focal": float(out.focal),
            "focal_err_frac": abs(float(out.focal) - focal_px) / focal_px, "rms_px": float(out.rms_px),
            "centre_err_max": float(np.linalg.norm(c_est - c_gt, axis=1).max())}


def key_sweep(sfm: str, feats: str, inputs: dict, R_gt, c_gt, keys: int, runs=None, first: int = 0) -> dict:
    """The phase's cameraLocalization runs as the JAX CLI's loop
    (`alicevision_tpu.pipeline.cli_ext._camera_localization`), for draws
    first <= k < first + keys: the tree of VoctreeLocalizer(seed=k), the key sequence split
    from PRNGKey(k); the LOC_2X runs read the scene scaled
    (`chip_smoke.scale_intrinsics`); `runs` picks runs (default all). The localizers' robust P3P is jitted for the sweep
    (the same function; eagerly each call takes seconds). Returns {run:
    [chip_smoke.sweep_entry of each draw]}."""
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from alicevision_tpu import camera as camm
    from alicevision_tpu import robust as jrb
    from alicevision_tpu import sfmdata as jsd
    from alicevision_tpu.features import sift as siftm
    from alicevision_tpu.image.io import read_image
    from alicevision_tpu.localization import localize_image
    from alicevision_tpu.localization.voctree_localizer import VoctreeLocalizer
    from alicevision_tpu.pipeline import cli_ext as jext

    sc = jsd.load(sfm)
    sc_2x = chip_smoke.scale_intrinsics(jsd.load(sfm))
    align, C = chip_smoke._database_frame(sc, R_gt, c_gt)
    radius = float(np.linalg.norm(c_gt - c_gt.mean(0), axis=1).mean())
    obs_desc = jext._obs_descriptors(sc, feats)
    lm_desc, lm_pts = jext._build_landmark_index_from_features(sc, feats)
    poses = inputs["poses"]
    eager = jrb.robust_resection_p3p
    jitted = jax.jit(eager, static_argnames=("im_size", "n_hyps", "max_error_px", "refine_iters"))

    def resect(key, world, obs, focal, im_size, valid=None, n_hyps=128, max_error_px=4.0, refine_iters=8):
        return jitted(key, world, obs, focal, tuple(float(x) for x in im_size), valid, n_hyps=n_hyps,
                      max_error_px=float(max_error_px), refine_iters=refine_iters)

    vlocs, out = {}, {}
    jrb.robust_resection_p3p = resect
    try:
        for run, (method, folder, ds, scaled) in chip_smoke.localization_camera_runs(inputs).items():
            if runs and run not in runs:
                continue
            db = sc_2x if scaled else sc
            fx, wh = float(np.mean(db.scale[:, 0])), (float(db.sizes[0, 0]), float(db.sizes[0, 1]))
            row = jtu.tree_map(lambda a: jnp.asarray(np.asarray(a)[0]), db.intrinsics_table())
            ds = 1024 if ds is None else ds
            names = sorted(f for f in os.listdir(folder) if f.endswith(".npy"))
            qf = []
            for n in names:
                img = read_image(os.path.join(folder, n), grayscale=True)
                scale = 1.0
                if ds and max(img.shape) > ds:
                    step = max(img.shape) // ds + 1
                    img, scale = img[::step, ::step], float(step)
                f = siftm.extract(jnp.asarray(img, jnp.float32), siftm.SiftConfig(max_keypoints=2048))
                valid = np.asarray(f.valid)
                p = camm.ima2cam(row, jnp.asarray(np.asarray(f.xy)[valid] * scale, jnp.float32))
                qf.append((np.asarray(f.desc)[valid],
                           np.asarray(camm.remove_distortion(row.disto_kind, row.disto, p))))
            out[run] = []
            for k in range(first, first + keys):
                key = jax.random.PRNGKey(k)
                res = {}
                for n, (desc, p) in zip(names, qf):
                    key, k1 = jax.random.split(key)
                    if method == "voctree":
                        if k not in vlocs:
                            vlocs[k] = VoctreeLocalizer(sc.points, sc.obs_landmark, sc.obs_view, obs_desc, seed=k)
                        r = vlocs[k].localize(k1, desc, p, fx, wh)
                    else:
                        r = localize_image(k1, lm_desc, lm_pts, desc, p, fx, wh)
                    res[n] = {"success": bool(r.success), "n_inliers": int(r.n_inliers),
                              "R": np.asarray(r.R).tolist(), "c": np.asarray(r.c).tolist()}
                out[run].append(chip_smoke.sweep_entry(res, names, poses["R0"], poses["c0"], align, C, radius, k))
            print(f"key_sweep {run} " + json.dumps(out[run]), flush=True)
    finally:
        jrb.robust_resection_p3p = eager
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", required=True, help="localization_inputs/ of localization_phase_torch.py --out")
    ap.add_argument("--work", default=None, help="keep the outputs here")
    ap.add_argument("--solver-batch", type=int, default=chip_smoke.LOC_SOLVER_BATCH)
    ap.add_argument("--marker-frames", type=int, default=chip_smoke.LOC_MARKER["frames"])
    ap.add_argument("--keys", type=int, default=0, help="PRNG keys a cameraLocalization run in the sweep")
    ap.add_argument("--first-key", type=int, default=0, help="the sweep's first key (draws first .. first + K - 1)")
    ap.add_argument("--sweep-only", action="store_true", help="only the key sweep")
    ap.add_argument("--runs", default="", help="comma-separated camera runs of the sweep (default all)")
    args = ap.parse_args()
    work = args.work or tempfile.mkdtemp(prefix="loc_ref_")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    sfm, feats = os.path.join(args.inputs, "database.sfm"), os.path.join(args.inputs, "features")
    _, R_gt, c_gt = _ring_cameras(chip_smoke.HARD_VIEWS, 6.0, 1.2, chip_smoke.HARD_IMG["focal_px"],
                                  chip_smoke.HARD_IMG["wh"], 0)
    inputs = chip_smoke.make_localization_inputs(work, "cpu")
    truth_sfm = os.path.join(work, "truth.sfm")
    chip_smoke._truth_scene(sfm, truth_sfm, R_gt, c_gt)
    print(f"inputs rendered in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = [r for r in args.runs.split(",") if r]
    sweep = key_sweep(sfm, feats, inputs, R_gt, c_gt, args.keys, runs, args.first_key) if args.keys else None
    if args.sweep_only:
        print(json.dumps({"key_sweep": sweep, "seconds": time.perf_counter() - t0}), flush=True)
        return 0
    rows = chip_smoke.run_localization_chain(jcli.main, chip_smoke.localization_chain(work, inputs, sfm, feats,
                                                                                      truth_sfm))
    report = chip_smoke.localization_report(work, rows, inputs, sfm, truth_sfm, R_gt, c_gt, "cpu")
    print("chain " + json.dumps({k: v["seconds"] for k, v in rows.items()}), flush=True)
    print("report " + json.dumps(report), flush=True)
    solvers = jax_solvers(args.solver_batch)
    print("solvers " + json.dumps(solvers), flush=True)
    markers = jax_markers(work, args.marker_frames)
    print(json.dumps({"localization_reference": {"report": report, "solvers": solvers, "markers": markers,
                                                 "key_sweep": sweep,
                                                 "chain_seconds": {k: v["seconds"] for k, v in rows.items()},
                                                 "seconds": time.perf_counter() - t0}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
