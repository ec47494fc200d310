#!/usr/bin/env python3
"""Where the 8-view vertical focal parts between the JAX engine and the
port's: readings on the CPU, and the fixture of tests/test_torch_focal_parting.py.

    python3 scripts/focal_parting.py --write-fixture [--threads 4]
    python3 scripts/focal_parting.py [--seeds 4] [--threads 4]

The scene is chip_smoke.py's `pipeline` phase: 8 rendered 1280x960 views
of the box world on a 0.6 rad arc (`utils/rendered.render_views`, f =
1120 px). `--write-fixture` runs the port's front end on the CPU
(cameraInit at 1120 px -> featureExtraction at 4096 keypoints ->
exhaustive pairs -> featureMatching), builds the JAX package's tracks
from its matches and writes `tests/golden/focal_parting_tracks.npz`: the
tracks, the pixel positions of the features they hold (renumbered from 0
a view), the intrinsics row and the image sizes (about 60 s on 4
threads). Without it, the script reads that file and prints one JSON line
a run of the incremental engine at its defaults: the JAX engine; the
port's engine fed every one of the JAX engine's RANSAC samples (initial
pair and resections, `sample_minimal` under the keys the JAX engine
splits); the port's engine on its own draws for seeds 0..N-1; and the
JAX engine for seeds 1..N-1. Each line holds (fx, fy), the posed views,
the landmarks, and against the rendered poses the largest rotation error
and the centres' ATE over the radius (the pipeline phase's measures).
Needs JAX (CPU) and the port; about 4 minutes with `--seeds 8`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "tests", "golden", "focal_parting_tracks.npz")


def write_fixture(path: str = FIXTURE) -> dict:
    """Render the pipeline phase's views, run the port's CPU front end and
    save the compact tracks and features (see the module docstring)."""
    import chip_smoke
    from alicevision_tpu.tracks.builder import build_tracks
    from alicevision_tpu_torch import sfmdata
    from alicevision_tpu_torch.pipeline import stages
    from alicevision_tpu_torch.pipeline.runner import run_full_pipeline

    with tempfile.TemporaryDirectory() as work:
        chip_smoke.make_posed_scene(work, n_views=8)
        out = os.path.join(work, "run")
        run_full_pipeline(os.path.join(work, "images"), out, default_focal_px=1120.0, skip_mvs=True,
                          device="cpu")
        sc = sfmdata.load(os.path.join(out, "cameraInit.sfm"))
        matches = stages.load_matches(os.path.join(out, "matches.npz"))
        xy = {v: stages.load_features(os.path.join(out, "features"), int(sc.view_ids[v]))["xy"]
              for v in range(sc.n_views)}
    tracks = build_tracks(matches, {v: len(f) for v, f in xy.items()}, min_track_length=2)
    views, feats = np.asarray(tracks.views), np.asarray(tracks.features)
    new_feats = np.zeros_like(feats)
    arrays = {}
    for v in range(sc.n_views):
        sel = views == v
        used, inverse = np.unique(feats[sel], return_inverse=True)
        new_feats[sel] = inverse
        arrays[f"xy_{v}"] = np.asarray(xy[v], np.float32)[used]
    intr = sc.intrinsics_table()
    np.savez_compressed(
        path, track_ids=np.asarray(tracks.track_ids, np.int32), views=views.astype(np.int32),
        features=new_feats.astype(np.int32), n_tracks=np.int64(tracks.n_tracks),
        view_intrinsic=np.asarray(sc.view_intrinsic, np.int32), image_sizes=np.asarray(sc.view_sizes, np.int64),
        **{f"intr_{i}": np.asarray(a) for i, a in enumerate(intr)}, **arrays,
    )
    return {"path": path, "tracks": int(tracks.n_tracks), "observations": int(len(views)),
            "bytes": os.path.getsize(path)}


class DrawRecorder:
    """Record the JAX engine's RANSAC samples as it draws them, and hand
    them, in the same order, to the port's engine: the initial-pair
    batches (5-point, `_init_pair_eval_packed`) and the resection chunks
    (P3P, `_resect_packed`). Indices are positions among the valid
    entries, so the JAX engine's wider padding does not change them."""

    def __init__(self):
        import jax

        from alicevision_tpu.robust.ransac import sample_minimal
        from alicevision_tpu.sfm import incremental as jinc
        from alicevision_tpu_torch.sfm import incremental as tinc

        self.jax, self.jinc, self.tinc, self.sample = jax, jinc, tinc, sample_minimal
        self.drawn, self.queue = [], []
        self._saved = []

    def _draw(self, kind, size, keys, n, n_hyps, valid):
        idx = self.jax.vmap(lambda k, v: self.sample(k, n, size, n_hyps, v))(keys, valid)
        self.drawn.append((kind, np.asarray(idx)))

    def install(self):
        import torch

        jinc, tinc = self.jinc, self.tinc
        init_j, res_j = jinc._init_pair_eval_packed, jinc._resect_packed
        init_t, res_t = tinc._init_pair_eval_batch, tinc.robust.robust_resection_p3p_batch

        def init_jax(keys, x1, x2, valid, focal_mean, im_size, n_hyps, max_error_px):
            self._draw("init", 5, keys, x1.shape[1], n_hyps, valid)
            return init_j(keys, x1, x2, valid, focal_mean, im_size, n_hyps, max_error_px)

        def res_jax(keys, world, obs, focal_mean, im_size, valid, n_hyps, max_error_px):
            self._draw("resect", 3, keys, world.shape[1], n_hyps, valid)
            return res_j(keys, world, obs, focal_mean, im_size, valid, n_hyps, max_error_px)

        def take(kind, batch):
            got, idx = self.queue.pop(0)
            if got != kind:
                raise RuntimeError(f"the port asked for a {kind} draw where the JAX engine drew {got}")
            return torch.as_tensor(np.array(idx[:batch]), dtype=torch.int64)

        def init_port(generator, x1, x2, valid, focal_mean, im_size, n_hyps, max_error_px, idx=None):
            return init_t(generator, x1, x2, valid, focal_mean, im_size, n_hyps, max_error_px,
                          idx=take("init", x1.shape[0]))

        def res_port(generator, world, obs, focal_mean, im_size, valid, n_hyps=128, max_error_px=4.0,
                     refine_iters=8, idx=None):
            return res_t(generator, world, obs, focal_mean, im_size, valid, n_hyps=n_hyps,
                         max_error_px=max_error_px, refine_iters=refine_iters, idx=take("resect", world.shape[0]))

        self._saved = [(jinc, "_init_pair_eval_packed", init_j), (jinc, "_resect_packed", res_j),
                       (tinc, "_init_pair_eval_batch", init_t), (tinc.robust, "robust_resection_p3p_batch", res_t)]
        jinc._init_pair_eval_packed, jinc._resect_packed = init_jax, res_jax
        tinc._init_pair_eval_batch, tinc.robust.robust_resection_p3p_batch = init_port, res_port
        return self

    def uninstall(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []


def engines(fx: dict, **cfg):
    """A JAX engine and a factory of port engines over the fixture, both at
    the IncrementalConfig `cfg` (the defaults otherwise)."""
    from alicevision_tpu import camera as jcam
    from alicevision_tpu.sfm.incremental import IncrementalConfig as JConfig
    from alicevision_tpu.sfm.incremental import IncrementalSfM as JEngine
    from alicevision_tpu.tracks.builder import Tracks as JTracks
    from alicevision_tpu_torch import convert
    from alicevision_tpu_torch.sfm.incremental import IncrementalSfM

    jcfg = JConfig(**cfg)
    jeng = JEngine(JTracks(*fx["tracks"]), fx["xy"], jcam.Intrinsics(*fx["intr"]), fx["view_intrinsic"],
                   fx["image_sizes"], jcfg)
    port_tracks = convert.tracks_from_numpy(*fx["tracks"])

    def port(**over):
        pcfg = convert.incremental_config_from_reference(dataclasses.asdict(dataclasses.replace(jcfg, **over)))
        return IncrementalSfM(port_tracks, fx["xy"], fx["intr"], fx["view_intrinsic"], fx["image_sizes"], pcfg,
                              device="cpu")

    return jeng, port


def truth_poses():
    """The rendered views' rotations and centres (chip_smoke.make_posed_scene's)."""
    from alicevision_tpu_torch.utils.rendered import render_views

    _, _, _, R, c = render_views(8, (1280, 960), focal_px=1120.0, arc=0.6, seed=0)
    return R, c


def reading(name: str, res, intr_np, truth=None) -> dict:
    """(fx, fy), posed views, landmarks; with `truth`, the pipeline phase's
    measures: the largest rotation error (chip_smoke.rotation_errors_deg)
    and the centres' ATE over the radius."""
    out = {"run": name, "focal_px": np.asarray(intr_np.scale, np.float64).ravel().tolist(),
           "posed": int(np.asarray(res.posed).sum()), "landmarks": int(np.asarray(res.point_valid).sum())}
    if truth is not None:
        import chip_smoke

        R, c = truth
        posed = np.nonzero(np.asarray(res.posed))[0]
        est_R, est_c = np.asarray(res.pose_R, np.float64)[posed], np.asarray(res.pose_c, np.float64)[posed]
        out["max_rotation_err_deg"] = max(chip_smoke.rotation_errors_deg(est_R, R[posed])[0])
        s, Ra, t = chip_smoke._align_similarity(est_c, c[posed])
        ate = np.sqrt(np.mean(np.sum((est_c @ (s * Ra).T + t - c[posed]) ** 2, axis=1)))
        out["ate_frac_of_radius"] = float(ate / np.linalg.norm(c[:, :2], axis=1).mean())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write-fixture", action="store_true")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(args.threads)
    if args.write_fixture:
        print(json.dumps(write_fixture()), flush=True)
        return 0
    import chip_smoke

    fx = chip_smoke.load_focal_fixture()
    truth = truth_poses()
    jeng, port = engines(fx)
    rec = DrawRecorder().install()
    try:
        jeng.process()
        print(json.dumps(reading("jax", jeng.res, jeng.intr_np, truth)), flush=True)
        rec.queue = list(rec.drawn)
        p = port()
        p.process()
        print(json.dumps({**reading("port, the JAX engine's draws", p.res, p.intr_np, truth),
                          "draws_left": len(rec.queue)}), flush=True)
    finally:
        rec.uninstall()
    for seed in range(args.seeds):
        p = port(seed=seed)
        p.process()
        print(json.dumps(reading(f"port, its own draws, seed {seed}", p.res, p.intr_np, truth)), flush=True)
    for seed in range(1, args.seeds):
        j, _ = engines(fx, seed=seed)
        j.process()
        print(json.dumps(reading(f"jax, seed {seed}", j.res, j.intr_np, truth)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
