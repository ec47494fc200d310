"""Scene exporters: COLMAP text model, Meshlab/MVE-style bundles.

Port of `alicevision_tpu/sfmdata/export.py` (host code; the quaternions are
float32, rounded as the reference computes them on the CPU), the
counterpart of the reference's exporters
(ref: src/aliceVision/sfmDataIO/colmap.cpp — cameras.txt/images.txt/
points3D.txt; src/software/export/main_exportColmap.cpp,
main_exportMeshlab.cpp). Text formats follow the public COLMAP spec.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import camera as cam
from ..geometry.rotations import quat_to_mat
from .scene import INVALID, SfMData


def _quat_f32(R: np.ndarray) -> np.ndarray:
    """The unit quaternion (w, x, y, z), w >= 0, of one rotation in float32:
    Shepperd's candidate with the largest pivot (the first of equal ones),
    its squared norm accumulated in order with fused multiply-adds, one
    square root and a division — the rounding of the reference's
    `mat_to_quat` on the CPU, so that the text exports are the same bytes."""
    m = np.asarray(R, np.float32)
    one = np.float32(1.0)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    cand = np.array([
        [one + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
        [m[2, 1] - m[1, 2], one + m[0, 0] - m[1, 1] - m[2, 2], m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]],
        [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], one - m[0, 0] + m[1, 1] - m[2, 2], m[1, 2] + m[2, 1]],
        [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], one - m[0, 0] - m[1, 1] + m[2, 2]],
    ], np.float32)
    q = cand[int(np.argmax(np.diag(cand)))]
    s = np.float32(q[0] * q[0])
    for x in q[1:]:  # float32 products are exact in float64: one rounding, as a fused multiply-add
        s = np.float32(np.float64(x) * np.float64(x) + np.float64(s))
    q = q / np.sqrt(s)
    return q if q[0] >= 0 else -q


def export_colmap(scene: SfMData, out_dir: str) -> None:
    """Write cameras.txt / images.txt / points3D.txt."""
    os.makedirs(out_dir, exist_ok=True)

    # cameras.txt — map our models onto COLMAP camera models
    with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i in range(scene.n_intrinsics):
            w, h = int(scene.sizes[i, 0]), int(scene.sizes[i, 1])
            fx, fy = scene.scale[i]
            cx, cy = scene.offset[i] + 0.5 * scene.sizes[i]
            dk = int(scene.disto_kind[i])
            cid = int(scene.intrinsic_ids[i])
            if dk == cam.DISTO_NONE:
                f.write(f"{cid} PINHOLE {w} {h} {fx} {fy} {cx} {cy}\n")
            elif dk == cam.DISTO_RADIALK1:
                f.write(
                    f"{cid} SIMPLE_RADIAL {w} {h} {(fx+fy)/2} {cx} {cy} "
                    f"{scene.disto[i,0]}\n"
                )
            elif dk == cam.DISTO_BROWN:
                k1, k2, k3, t1, t2 = scene.disto[i, :5]
                f.write(
                    f"{cid} FULL_OPENCV {w} {h} {fx} {fy} {cx} {cy} "
                    f"{k1} {k2} {t1} {t2} {k3} 0 0 0\n"
                )
            else:  # RADIALK3 and the rest -> OPENCV (k1 k2 p1 p2)
                k1, k2 = scene.disto[i, 0], scene.disto[i, 1]
                f.write(
                    f"{cid} OPENCV {w} {h} {fx} {fy} {cx} {cy} {k1} {k2} 0 0\n"
                )

    # group observations by landmark then by view for the two files below
    obs_by_view: dict[int, list] = {v: [] for v in range(scene.n_views)}
    for o in range(scene.n_observations):
        obs_by_view[int(scene.obs_view[o])].append(o)

    with open(os.path.join(out_dir, "images.txt"), "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for v in range(scene.n_views):
            if scene.view_pose[v] == INVALID:
                continue
            p = int(scene.view_pose[v])
            R = scene.pose_R[p]
            c = scene.pose_c[p]
            t = -R @ c
            q = _quat_f32(R)
            vid = int(scene.view_ids[v])
            cid = int(scene.intrinsic_ids[scene.view_intrinsic[v]])
            name = os.path.basename(scene.view_paths[v]) or f"view_{vid}.jpg"
            f.write(
                f"{vid} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} {cid} {name}\n"
            )
            pts2d = []
            for o in obs_by_view[v]:
                u, w_ = scene.obs_uv[o]
                lid = int(scene.landmark_ids[scene.obs_landmark[o]])
                pts2d.append(f"{u} {w_} {lid}")
            f.write(" ".join(pts2d) + "\n")

    with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        order = np.argsort(scene.obs_landmark, kind="stable")
        bounds = np.searchsorted(
            scene.obs_landmark[order], np.arange(scene.n_landmarks + 1)
        )
        for l in range(scene.n_landmarks):
            X = scene.points[l]
            c = scene.colors[l]
            track = []
            for o in order[bounds[l] : bounds[l + 1]]:
                track.append(f"{int(scene.view_ids[scene.obs_view[o]])} {int(scene.obs_feature[o])}")
            f.write(
                f"{int(scene.landmark_ids[l])} {X[0]} {X[1]} {X[2]} "
                f"{c[0]} {c[1]} {c[2]} 0.5 " + " ".join(track) + "\n"
            )


def export_meshlab(scene: SfMData, out_dir: str, mesh_path: str | None = None) -> None:
    """Write a MeshLab project (.mlp) with raster cameras
    (ref: src/software/export/main_exportMeshlab.cpp)."""
    os.makedirs(out_dir, exist_ok=True)
    lines = ['<!DOCTYPE MeshLabDocument>', "<MeshLabProject>"]
    lines.append(" <MeshGroup>")
    if mesh_path:
        lines.append(f'  <MLMesh filename="{mesh_path}" label="mesh"/>')
    lines.append(" </MeshGroup>")
    lines.append(" <RasterGroup>")
    for v in range(scene.n_views):
        p = scene.view_pose[v]
        if p == INVALID:
            continue
        ii = scene.view_intrinsic[v]
        fx = scene.scale[ii, 0]
        w, h = int(scene.view_sizes[v, 0]), int(scene.view_sizes[v, 1])
        R = scene.pose_R[p]
        c = scene.pose_c[p]
        t = -R @ c
        rot = " ".join(
            str(x)
            for x in np.block(
                [[R, t[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]]
            ).ravel()
        )
        name = os.path.basename(scene.view_paths[v]) or f"view_{int(scene.view_ids[v])}"
        lines.append("  <MLRaster label=\"%s\">" % name)
        lines.append(
            f'   <VCGCamera TranslationVector="{t[0]} {t[1]} {t[2]} 1" '
            f'LensDistortion="0 0" ViewportPx="{w} {h}" '
            f'PixelSizeMm="1 1" FocalMm="{fx}" '
            f'RotationMatrix="{rot}"/>'
        )
        lines.append(f'   <Plane semantic="1" fileName="{scene.view_paths[v]}"/>')
        lines.append("  </MLRaster>")
    lines.append(" </RasterGroup>")
    lines.append("</MeshLabProject>")
    with open(os.path.join(out_dir, "project.mlp"), "w") as f:
        f.write("\n".join(lines))


def export_animated_camera(scene: SfMData, path: str, fps: float = 24.0) -> None:
    """Per-frame camera track as JSON (the Alembic-free analog of
    main_exportAnimatedCamera; frames ordered by view frame id)."""
    import json as _json

    frames = []
    order = np.argsort(scene.view_frames)
    for v in order:
        p = scene.view_pose[v]
        if p == INVALID:
            continue
        ii = scene.view_intrinsic[v]
        frames.append(
            {
                "frame": int(scene.view_frames[v]),
                "viewId": int(scene.view_ids[v]),
                "rotation": scene.pose_R[p].tolist(),
                "center": scene.pose_c[p].tolist(),
                "focal_px": float(scene.scale[ii, 0]),
                "principal_point": (
                    scene.offset[ii] + 0.5 * scene.sizes[ii]
                ).tolist(),
            }
        )
    with open(path, "w") as f:
        _json.dump({"fps": fps, "frames": frames}, f, indent=1)


def import_known_poses(scene: SfMData, poses_path: str) -> int:
    """Apply externally-known poses to a scene
    (ref: src/software/convert/main_importKnownPoses.cpp). The JSON format
    is the export_animated_camera schema or a {viewId: {rotation, center}}
    map. Returns the number of poses applied."""
    import json as _json

    with open(poses_path) as f:
        data = _json.load(f)
    if "frames" in data:
        entries = {int(fr["viewId"]): fr for fr in data["frames"]}
    else:
        entries = {int(k): v for k, v in data.items()}
    id2idx = {int(vid): i for i, vid in enumerate(scene.view_ids)}
    n = 0
    for vid, e in entries.items():
        if vid in id2idx:
            scene.set_pose(
                id2idx[vid], np.asarray(e["rotation"], float), np.asarray(e["center"], float)
            )
            n += 1
    return n


def import_colmap(model_dir: str) -> SfMData:
    """Read a COLMAP text model back into an SfMData scene."""
    sc = SfMData.empty()
    id2idx_intr = {}
    with open(os.path.join(model_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            p = line.split()
            cid, model, w, h = int(p[0]), p[1], int(p[2]), int(p[3])
            params = [float(x) for x in p[4:]]
            if model == "PINHOLE":
                fx, fy, cx, cy = params
                dk, dp = cam.DISTO_NONE, ()
            elif model == "SIMPLE_RADIAL":
                fx = fy = params[0]
                cx, cy = params[1:3]
                dk, dp = cam.DISTO_RADIALK1, (params[3],)
            elif model == "OPENCV":
                fx, fy, cx, cy, k1, k2 = params[:6]
                dk, dp = cam.DISTO_RADIALK3, (k1, k2, 0.0)
            elif model == "FULL_OPENCV":
                fx, fy, cx, cy, k1, k2, t1, t2, k3 = params[:9]
                dk, dp = cam.DISTO_BROWN, (k1, k2, k3, t1, t2)
            else:
                fx = fy = params[0]
                cx, cy = params[1:3]
                dk, dp = cam.DISTO_NONE, ()
            idx = sc.add_intrinsic(
                cid, w, h, fx, disto_kind=dk, disto_params=dp,
                offset=(cx - w / 2, cy - h / 2), focal_y_px=fy,
            )
            id2idx_intr[cid] = idx

    with open(os.path.join(model_dir, "images.txt")) as f:
        lines = [l for l in f if not l.startswith("#")]
    for k in range(0, len(lines) - 1, 2):
        p = lines[k].split()
        if len(p) < 10:
            continue
        vid = int(p[0])
        q = np.array([float(x) for x in p[1:5]])
        t = np.array([float(x) for x in p[5:8]])
        cid = int(p[8])
        name = p[9]
        ii = id2idx_intr[cid]
        w, h = int(sc.sizes[ii, 0]), int(sc.sizes[ii, 1])
        vi = sc.add_view(vid, ii, w, h, path=name)
        R = quat_to_mat(torch.as_tensor(q / np.linalg.norm(q), dtype=torch.float32)).numpy()
        sc.set_pose(vi, R, -R.T @ t)
    return sc


def export_mve2(scene: SfMData, out_dir: str) -> None:
    """MVE scene layout: synth_0.out bundler file + views/view_%04d.mve/meta.ini
    (ref: src/software/export/main_exportMVE2.cpp). Cameras use the bundler
    convention (world->cam R, t with the camera looking down -z)."""
    os.makedirs(out_dir, exist_ok=True)
    views_dir = os.path.join(out_dir, "views")
    os.makedirs(views_dir, exist_ok=True)
    valid = scene.valid_views()
    vid_to_seq = {int(v): k for k, v in enumerate(valid)}

    # Bundler flips y/z relative to our (x right, y down, z forward).
    flip = np.diag([1.0, -1.0, -1.0])
    with open(os.path.join(out_dir, "synth_0.out"), "w") as f:
        f.write("drews 1.0\n")
        f.write(f"{len(valid)} {scene.n_landmarks}\n")
        for v in valid:
            ii = int(scene.view_intrinsic[v])
            p = int(scene.view_pose[v])
            focal = float(scene.scale[ii, 0])
            R = flip @ scene.pose_R[p]
            t = -R @ scene.pose_c[p]
            f.write(f"{focal} 0 0\n")
            for r in R:
                f.write(f"{r[0]} {r[1]} {r[2]}\n")
            f.write(f"{t[0]} {t[1]} {t[2]}\n")
        X = scene.points
        col = (
            scene.point_colors
            if getattr(scene, "point_colors", None) is not None
            and len(getattr(scene, "point_colors", []))
            else np.full((scene.n_landmarks, 3), 128)
        )
        obs_by_lm = {}
        for o in range(scene.n_observations):
            obs_by_lm.setdefault(int(scene.obs_landmark[o]), []).append(o)
        for l in range(scene.n_landmarks):
            f.write(f"{X[l, 0]} {X[l, 1]} {X[l, 2]}\n")
            c = col[l]
            f.write(f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
            obs = [
                o
                for o in obs_by_lm.get(l, [])
                if int(scene.obs_view[o]) in vid_to_seq
            ]
            parts = [str(len(obs))]
            for o in obs:
                seq = vid_to_seq[int(scene.obs_view[o])]
                uv = scene.obs_uv[o]
                parts += [str(seq), str(o), f"{uv[0]}", f"{uv[1]}"]
            f.write(" ".join(parts) + "\n")

    for k, v in enumerate(valid):
        vdir = os.path.join(views_dir, f"view_{k:04d}.mve")
        os.makedirs(vdir, exist_ok=True)
        ii = int(scene.view_intrinsic[v])
        p = int(scene.view_pose[v])
        w, h = float(scene.sizes[ii, 0]), float(scene.sizes[ii, 1])
        fnorm = float(scene.scale[ii, 0]) / max(w, h)
        R = flip @ scene.pose_R[p]
        t = -R @ scene.pose_c[p]
        pp = (scene.offset[ii] + 0.5 * scene.sizes[ii]) / np.array([w, h])
        with open(os.path.join(vdir, "meta.ini"), "w") as f:
            f.write("[camera]\n")
            f.write(f"focal_length = {fnorm}\n")
            f.write(f"pixel_aspect = 1\n")
            f.write(f"principal_point = {pp[0]} {pp[1]}\n")
            f.write("rotation = " + " ".join(str(x) for x in R.ravel()) + "\n")
            f.write("translation = " + " ".join(str(x) for x in t) + "\n")
            f.write("[view]\n")
            f.write(f"id = {k}\nname = {int(scene.view_ids[v])}\n")


def export_pmvs(scene: SfMData, out_dir: str, level: int = 1, csize: int = 2) -> None:
    """PMVS working directory: txt/%08d.txt P-matrices + pmvs_options.txt
    (ref: src/software/export/main_exportPMVS.cpp)."""
    os.makedirs(os.path.join(out_dir, "txt"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "visualize"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "models"), exist_ok=True)
    valid = scene.valid_views()
    for k, v in enumerate(valid):
        K, R, c = scene.camera_matrices(v)
        t = -R @ c
        P = K @ np.concatenate([R, t[:, None]], axis=1)
        with open(os.path.join(out_dir, "txt", f"{k:08d}.txt"), "w") as f:
            f.write("CONTOUR\n")
            for row in P:
                f.write(f"{row[0]} {row[1]} {row[2]} {row[3]}\n")
    with open(os.path.join(out_dir, "pmvs_options.txt"), "w") as f:
        f.write(f"level {level}\ncsize {csize}\nthreshold 0.7\nwsize 7\n")
        f.write(f"minImageNum 3\nCPU 8\nsetEdge 0\nuseBound 0\nuseVisData 0\n")
        f.write(f"sequence -1\ntimages -1 0 {len(valid)}\noimages 0\n")


def export_usd(scene: SfMData, path: str, mesh=None) -> None:
    """USD ASCII (.usda) stage with the camera rig and optional mesh
    (ref: src/software/export/main_exportUSD.cpp — that one writes binary
    USD via the usd SDK; the .usda text encoding is part of the same spec
    and loads in any USD runtime)."""
    valid = scene.valid_views()
    lines = [
        "#usda 1.0",
        "(",
        '    upAxis = "Y"',
        "    metersPerUnit = 1",
        ")",
        "",
        'def Xform "scene"',
        "{",
    ]
    for v in valid:
        ii = int(scene.view_intrinsic[v])
        p = int(scene.view_pose[v])
        R = scene.pose_R[p]
        c = scene.pose_c[p]
        # camera-to-world, column-major 4x4; USD cameras look down -Z, our
        # convention looks down +Z: rotate pi about x.
        cam2world = np.eye(4)
        cam2world[:3, :3] = (np.diag([1.0, -1.0, -1.0]) @ R).T
        cam2world[:3, 3] = c
        w, h = float(scene.sizes[ii, 0]), float(scene.sizes[ii, 1])
        fx = float(scene.scale[ii, 0])
        # USD focal/aperture in tenths of world units (mm convention).
        aperture_h = 36.0
        focal_mm = fx / w * aperture_h
        mat = ", ".join(
            "(" + ", ".join(f"{cam2world[r, col]}" for r in range(4)) + ")"
            for col in range(4)
        )
        lines += [
            f'    def Camera "camera_{int(scene.view_ids[v])}"',
            "    {",
            f"        float focalLength = {focal_mm}",
            f"        float horizontalAperture = {aperture_h}",
            f"        float verticalAperture = {aperture_h * h / w}",
            f"        matrix4d xformOp:transform = ( {mat} )",
            '        uniform token[] xformOpOrder = ["xformOp:transform"]',
            "    }",
        ]
    if scene.n_landmarks:
        pts = ", ".join(
            f"({x[0]}, {x[1]}, {x[2]})" for x in np.asarray(scene.points)
        )
        lines += [
            '    def Points "structure"',
            "    {",
            f"        point3f[] points = [{pts}]",
            "    }",
        ]
    if mesh is not None:
        V, F = mesh
        pts = ", ".join(f"({p[0]}, {p[1]}, {p[2]})" for p in np.asarray(V))
        counts = ", ".join("3" for _ in range(len(F)))
        idx = ", ".join(str(int(i)) for i in np.asarray(F).ravel())
        lines += [
            '    def Mesh "surface"',
            "    {",
            f"        int[] faceVertexCounts = [{counts}]",
            f"        int[] faceVertexIndices = [{idx}]",
            f"        point3f[] points = [{pts}]",
            "    }",
        ]
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
