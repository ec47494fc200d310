"""Lidar point-cloud pipeline: merge, decimate, mesh.

A host copy of `alicevision_tpu/mvs/lidar.py` (numpy, as there); meshing
goes through the port's graph cut (`mesh/delaunay_graphcut.py`, its
max-flow in C++). The PLY reader and writer take and give the JAX
package's bytes, blockwise instead of a point at a time.

TPU-native counterpart of the reference's lidar path
(ref: src/software/pipeline/main_lidarMerging.cpp, main_lidarDecimating.cpp,
main_lidarMeshing.cpp; fuseCut/InputSet.hpp). An *input set* is a JSON list
of scans [{"ply": path, "origin": [x, y, z]}] — the origin is the scanner
position, which plays the role camera centers play for photogrammetric
fusion: every point carries a free-space ray to its sensor, and meshing is
the same Delaunay graph-cut as the MVS path (mesh/delaunay_graphcut.py).

E57 import (ref: dataio/E57Reader.hpp) goes through the native ASTM E2807
reader in `image/e57.py` (no external libE57 needed): each Data3D scan's
points are returned in world coordinates (scan pose applied) with the
scanner position as the ray origin.
"""

from __future__ import annotations

import json
import os

import numpy as np


def read_e57(path: str):
    """E57 scans -> [(points (N, 3) world, origin (3,)), ...] — the same
    shape `load_input_set` produces for PLY entries."""
    from ..image.e57 import read_e57 as _read

    data = _read(path)
    out = []
    for scan in data["scans"]:
        origin = scan["pose"][1] if scan["pose"] is not None else np.zeros(3)
        out.append((scan["points"], origin))
    return out


def load_cloud_ply(path: str) -> np.ndarray:
    """Points from an ASCII PLY (vertex elements only needed)."""
    with open(path) as f:
        assert f.readline().strip() == "ply"
        n_v = 0
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line == "end_header":
                break
        if n_v == 0:
            return np.zeros((0, 3))
        return np.loadtxt(f, usecols=(0, 1, 2), max_rows=n_v, ndmin=2, dtype=np.float64)


def save_cloud_ply(path: str, points: np.ndarray) -> None:
    """The JAX writer's bytes: each coordinate as numpy's `str` of its
    scalar. For float64 that is the shortest round-trip repr, which `%r` of
    a Python float gives blockwise at a fraction of the cost."""
    points = np.asarray(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        if points.dtype != np.float64:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
            return
        for k in range(0, len(points), 1 << 16):
            f.write("".join("%r %r %r\n" % tuple(p) for p in points[k:k + (1 << 16), :3].tolist()))


def load_input_set(path: str):
    """[(points (N_i, 3), origin (3,)), ...] from an input-set JSON."""
    with open(path) as f:
        entries = json.load(f)
    base = os.path.dirname(os.path.abspath(path))
    out = []
    for e in entries:
        ply = e["ply"]
        if not os.path.isabs(ply):
            ply = os.path.join(base, ply)
        if ply.lower().endswith(".e57"):
            for pts, origin in read_e57(ply):
                out.append(
                    (pts, np.asarray(e.get("origin", origin), float))
                )
            continue
        out.append((load_cloud_ply(ply), np.asarray(e.get("origin", [0, 0, 0]), float)))
    return out


def merge_scans(scans) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate scans into (points (P, 3), origins-per-point (P, 3))."""
    pts = np.concatenate([p for p, _ in scans])
    org = np.concatenate([np.tile(o, (len(p), 1)) for p, o in scans])
    return pts, org


def decimate_cloud(
    points: np.ndarray, origins: np.ndarray, cell_size: float
) -> tuple[np.ndarray, np.ndarray]:
    """Voxel-grid decimation keeping per-cell centroids and the origin of
    the first point in each cell (ref: main_lidarDecimating.cpp contract)."""
    keys = np.floor(points / cell_size).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    n = len(uniq)
    sums = np.zeros((n, 3))
    cnts = np.zeros(n)
    np.add.at(sums, inv, points)
    np.add.at(cnts, inv, 1.0)
    first = np.full(n, -1, np.int64)
    # first occurrence per cell
    order = np.arange(len(points))[::-1]
    first[inv[order]] = order
    return sums / cnts[:, None], origins[first]


def mesh_lidar(
    points: np.ndarray,
    origins: np.ndarray,
    max_points: int = 50000,
    **graph_cut_kwargs,
):
    """Delaunay graph-cut surface from a lidar cloud with per-point sensor
    origins (ref: main_lidarMeshing.cpp -> fuseCut pipeline)."""
    from ..mesh.delaunay_graphcut import graph_cut_surface

    if len(points) > max_points:
        sel = np.random.RandomState(0).choice(len(points), max_points, replace=False)
        points, origins = points[sel], origins[sel]
    vis_point = np.arange(len(points))
    return graph_cut_surface(points, vis_point, origins, **graph_cut_kwargs)
