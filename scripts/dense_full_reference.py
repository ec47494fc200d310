#!/usr/bin/env python3
"""Reference numbers of chip_smoke.py's dense_full phase, from the JAX
package on the CPU.

    python scripts/dense_full_reference.py

from the repository root, on a machine with the JAX package (it forces
JAX onto the CPU; about 15 minutes). It renders the scene of
chip_smoke.make_posed_scene (8 views of 1280x960 on a 0.6 rad arc, 3000
landmarks observed where their depth agrees with the rendered depth within
1 %), runs the JAX package's prepareDenseScene and depthMapEstimation at
D = 96 twice — plain and with `refine=True` — and one view-1 SGM map with
a guided-filter radius of 4, and prints one JSON object: per view, the
median relative depth error and the valid fraction against the rendered
depth on the interior [12:-12, 12:-12] of the 640x480 map
(tests/test_golden_mvs.py's statistics). chip_smoke.py holds the card's
maps to these numbers (`DENSE_FULL_REFERENCE`). It runs no tiled map:
the JAX package's tiled branch takes the rectified sweep on tiles whose
principal point lies off their centre, where that sweep misses, and the
port, which sends every tile to the gather sweep, holds its tiled maps to
its own untiled maps instead.

It imports only the JAX package, so the scene is built here as
chip_smoke.make_posed_scene builds it.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alicevision_tpu import sfmdata  # noqa: E402
from alicevision_tpu.mvs import plane_sweep as ps  # noqa: E402
from alicevision_tpu.mvs.depth_list import sgm_depth_list  # noqa: E402
from alicevision_tpu.mvs.fusion import depth_range_from_landmarks  # noqa: E402
from alicevision_tpu.pipeline import stages  # noqa: E402
from alicevision_tpu.utils.rendered import render_views, sample_surface_points  # noqa: E402

N_VIEWS, WH, FOCAL, N_POINTS = 8, (1280, 960), 1120.0, 3000
N_DEPTHS, GUIDED_RADIUS = 96, 4


def make_posed_scene(folder: str):
    imgs, gt, K, R, c = render_views(N_VIEWS, WH, focal_px=FOCAL, arc=0.6, seed=0)
    W, H = WH
    img_dir = os.path.join(folder, "images")
    os.makedirs(img_dir, exist_ok=True)
    sc = sfmdata.SfMData.empty()
    sc.add_intrinsic(1000, W, H, FOCAL, offset=(-0.5, -0.5))
    pp = K[:2, 2] - 0.5
    for v in range(N_VIEWS):
        path = os.path.join(img_dir, f"{v + 1}.npy")
        np.save(path, imgs[v])
        vi = sc.add_view(v + 1, 0, W, H, path=path)
        sc.set_pose(vi, R[v], c[v])
    pts = sample_surface_points(N_POINTS, seed=0)
    obs_lm, obs_view, obs_uv = [], [], []
    for v in range(N_VIEWS):
        xc = (pts - c[v]) @ R[v].T
        z = xc[:, 2]
        zs = np.where(z > 1e-6, z, 1.0)
        uv = FOCAL * xc[:, :2] / zs[:, None] + pp
        xi = np.round(uv[:, 0]).astype(np.int64)
        yi = np.round(uv[:, 1]).astype(np.int64)
        inside = (z > 0.1) & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        g = gt[v, yi.clip(0, H - 1), xi.clip(0, W - 1)]
        idx = np.nonzero(inside & (g > 0) & (np.abs(g - z) < 0.01 * z))[0]
        obs_lm.append(idx)
        obs_view.append(np.full(len(idx), v))
        obs_uv.append(uv[idx])
    obs_lm = np.concatenate(obs_lm)
    seen, obs_lm = np.unique(obs_lm, return_inverse=True)
    sc.set_structure(pts[seen], obs_lm, np.concatenate(obs_view), np.concatenate(obs_uv))
    sfm = os.path.join(folder, "scene.sfm")
    sfmdata.save(sc, sfm)
    return sfm, gt


def depth_stats(depth, gt):
    interior = np.zeros(gt.shape, bool)
    interior[12:-12, 12:-12] = True
    valid = (depth > 0) & (gt > 0) & interior
    rel = np.abs(depth - gt)[valid] / gt[valid]
    return [float(np.median(rel)), float(valid.mean())]


def guided_view_one(sfm: str, dense: str):
    """View index 0's SGM map with the guided filter, from the inputs that
    depthMapEstimation builds (nearest 4 T-cams, seeded depth list)."""
    sc = sfmdata.load(sfm)
    valid = list(sc.valid_views())
    K, R, c, img = {}, {}, {}, {}
    for u in valid:
        fx, fy = sc.scale[0] / 2
        pp = (sc.offset[0] + 0.5 * sc.sizes[0]) / 2
        K[u] = np.array([[fx, 0, pp[0]], [0, fy, pp[1]], [0, 0, 1.0]], np.float32)
        R[u] = sc.pose_R[int(sc.view_pose[u])].astype(np.float32)
        c[u] = sc.pose_c[int(sc.view_pose[u])].astype(np.float32)
        img[u] = np.load(os.path.join(dense, f"{int(sc.view_ids[u])}.npy"))[::2, ::2].astype(np.float32)
    v = 0
    d = np.linalg.norm(np.stack([c[u] for u in valid]) - c[v], axis=1)
    order = [valid[i] for i in np.argsort(d) if valid[i] != v][:4]
    hw = {u: (img[u].shape[1], img[u].shape[0]) for u in valid}
    dl = sgm_depth_list(sc.points, sc.obs_landmark, sc.obs_view, sc.obs_uv, v, R, c, K, hw, order,
                        N_DEPTHS, fallback_range=depth_range_from_landmarks(sc.points, R[v], c[v]))
    tc = np.stack([dl.depths[dl.tc_limits[:, 0]],
                   dl.depths[np.clip(dl.tc_limits[:, 1] - 1, 0, N_DEPTHS - 1)]], axis=1).astype(np.float32)
    depth, _ = ps.sgm_depth_map(
        jnp.asarray(img[v]), jnp.asarray(np.stack([img[u] for u in order])), jnp.asarray(K[v]),
        jnp.asarray(np.stack([K[u] for u in order])),
        jnp.asarray(np.stack([R[u] @ R[v].T for u in order])),
        jnp.asarray(np.stack([R[u] @ (c[v] - c[u]) for u in order])),
        dl.d_min, dl.d_max, ps.SgmParams(n_depths=N_DEPTHS, guided_radius=GUIDED_RADIUS),
        depths=dl.depths, tc_depth_ranges=jnp.asarray(tc),
    )
    return np.asarray(depth)


def main() -> int:
    out = {}
    with tempfile.TemporaryDirectory() as work:
        sfm, gt = make_posed_scene(work)
        dense = os.path.join(work, "dense")
        stages.prepare_dense_scene(sfm, dense)
        runs = {"plain": {}, "refine": dict(refine=True)}
        for name, kw in runs.items():
            folder = os.path.join(work, name)
            stages.depth_map_estimation(sfm, dense, folder, n_depths=N_DEPTHS, **kw)
            out[name] = [depth_stats(np.load(os.path.join(folder, f"{v + 1}_depth.npy")), gt[v, ::2, ::2])
                         for v in range(N_VIEWS)]
            print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
        out["guided_view1"] = depth_stats(guided_view_one(sfm, dense), gt[0, ::2, ::2])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
