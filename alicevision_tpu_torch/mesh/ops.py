"""Mesh operations: smoothing, decimation, cleanup, IO.

Port of `alicevision_tpu/mesh/ops.py` (ref: src/aliceVision/mesh/
MeshEnergyOpt.cpp Laplacian smoothing, ModQuadricMetricT.hpp quadric
decimation — here grid clustering and a batched multiple-choice QEM —,
MeshClean — here unreferenced/degenerate removal and largest-component
filtering —, Mesh.hpp OBJ/PLY IO). The smoothing is tensor code on the
device of the vertices it is given (`index_add_` for the reference's
`.at[].add`); connectivity manipulation and IO stay host numpy, copied.
"""

from __future__ import annotations

import numpy as np
import torch


def laplacian_smooth(
    vertices: torch.Tensor,
    faces,
    iterations: int = 5,
    lam: float = 0.5,
    mu: float = -0.53,
) -> torch.Tensor:
    """Taubin lambda/mu smoothing (shrinkage-compensated umbrella operator,
    the spirit of MeshEnergyOpt's smoothing). mu=0 gives plain Laplacian.

    `vertices` (V, 3) is a tensor; the smoothing runs on its device and in
    its dtype (the reference computes in float32). `faces` (F, 3) is an
    integer array or tensor. Returns the smoothed (V, 3) tensor."""
    x = vertices
    dev = x.device
    f = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]],
                   f[:, [1, 0]], f[:, [2, 1]], f[:, [0, 2]]])
    src, dst = e[:, 0], e[:, 1]
    V = x.shape[0]
    deg = torch.zeros(V, dtype=x.dtype, device=dev).index_add_(0, src, torch.ones_like(src, dtype=x.dtype))
    has_nbr = (deg > 0)[:, None]
    deg = deg.clamp(min=1.0)[:, None]

    def step(x, k):
        nbr_sum = torch.zeros_like(x).index_add_(0, src, x[dst])
        mean = nbr_sum / deg
        return torch.where(has_nbr, x + k * (mean - x), x)

    for _ in range(iterations):
        x = step(x, lam)
        if mu != 0.0:
            x = step(x, mu)
    return x


def decimate_grid(
    vertices: np.ndarray, faces: np.ndarray, cell_size: float
) -> tuple[np.ndarray, np.ndarray]:
    """Vertex-clustering decimation on a voxel grid (meshDecimate analog).

    Each occupied cell collapses to the centroid of its vertices; faces with
    repeated clusters are dropped."""
    keys = np.floor(vertices / cell_size).astype(np.int64)
    # Exact cell identity (hashing int triples collides on small grids).
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    n = len(uniq)
    sums = np.zeros((n, 3))
    cnts = np.zeros(n)
    np.add.at(sums, inv, vertices)
    np.add.at(cnts, inv, 1.0)
    new_v = sums / cnts[:, None]
    nf = inv[faces]
    keep = (
        (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
    )
    return new_v, nf[keep].astype(np.int32)


def decimate_qem(
    vertices: np.ndarray,
    faces: np.ndarray,
    target_faces: int,
    max_rounds: int = 50,
) -> tuple[np.ndarray, np.ndarray]:
    """Quadric-error-metric decimation (ref: mesh/ModQuadricMetricT.hpp on
    OpenMesh). Instead of a serial heap of collapses, each round scores ALL
    edges by QEM cost as batched 4x4 quadric algebra, then collapses a
    maximal independent set of the cheapest edges at once — the
    multiple-choice variant, which vectorizes and gives the same asymptotic
    quality. Collapse placement is the quadric-optimal point (fallback:
    midpoint when the 3x3 system is singular)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)

    for _ in range(max_rounds):
        if len(f) <= target_faces or len(f) == 0:
            break
        # Per-face plane quadrics K = p p^T, p = (n, -n.x0)/|n|.
        p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        n = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(nn, 1e-12)
        d = -np.sum(n * p0, axis=-1, keepdims=True)
        p = np.concatenate([n, d], axis=1)  # (F, 4)
        K = p[:, :, None] * p[:, None, :] * nn[:, :, None]  # area-weighted
        Q = np.zeros((len(v), 4, 4))
        for i in range(3):
            np.add.at(Q, f[:, i], K)
        # Candidate edges (unique, undirected).
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        e = np.unique(np.sort(e, axis=1), axis=0)
        Qe = Q[e[:, 0]] + Q[e[:, 1]]
        # Optimal placement: solve grad = 0 -> A x = -b with A = Qe[:3,:3].
        A = Qe[:, :3, :3]
        b = Qe[:, :3, 3]
        det = np.linalg.det(A)
        ok = np.abs(det) > 1e-12
        x_opt = 0.5 * (v[e[:, 0]] + v[e[:, 1]])
        if ok.any():
            x_opt[ok] = np.linalg.solve(A[ok], -b[ok][..., None])[..., 0]
        xh = np.concatenate([x_opt, np.ones((len(e), 1))], axis=1)
        cost = np.einsum("ei,eij,ej->e", xh, Qe, xh)
        # Greedy independent set over ascending cost (vectorized marking).
        order = np.argsort(cost)
        used = np.zeros(len(v), bool)
        sel = []
        budget = max(1, (len(f) - target_faces) // 2)
        for idx in order:
            a, bb = e[idx]
            if used[a] or used[bb]:
                continue
            used[a] = used[bb] = True
            sel.append(idx)
            if len(sel) >= budget:
                break
        if not sel:
            break
        sel = np.array(sel)
        # Collapse: map b -> a, move a to optimal point.
        remap = np.arange(len(v))
        remap[e[sel, 1]] = e[sel, 0]
        v = v.copy()
        v[e[sel, 0]] = x_opt[sel]
        f = remap[f]
        keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        f = f[keep]
    vv, ff = compact(v, f.astype(np.int64))
    return vv, ff


def largest_component(
    vertices: np.ndarray, faces: np.ndarray, keep_ratio: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Keep the largest connected face component (and any component above
    keep_ratio x its size) — the Mesher's small-segment removal."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    V = len(vertices)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    g = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(V, V))
    n_comp, label = connected_components(g, directed=False)
    if n_comp <= 1:
        return vertices, faces
    sizes = np.bincount(label, minlength=n_comp)
    main = sizes.argmax()
    ok_comp = np.zeros(n_comp, bool)
    ok_comp[main] = True
    if keep_ratio > 0:
        ok_comp |= sizes >= keep_ratio * sizes[main]
    keep_face = ok_comp[label[faces[:, 0]]]
    return compact(vertices, faces[keep_face])


def merge_meshes(
    v1: np.ndarray,
    f1: np.ndarray,
    v2: np.ndarray,
    f2: np.ndarray,
    weld_eps: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate two meshes, optionally welding coincident vertices
    (quantized to weld_eps). Counterpart of the reference's mergeMeshes
    tool (ref: src/software/pipeline/main_mergeMeshes.cpp; the reference's
    geogram boolean union is approximated by a weld — both produce one
    combined surface, we do not resolve self-intersections)."""
    v = np.concatenate([v1, v2], axis=0)
    f = np.concatenate([f1, f2 + len(v1)], axis=0).astype(np.int64)
    if weld_eps > 0:
        keys = np.round(v / weld_eps).astype(np.int64)
        _, first, inv = np.unique(
            keys, axis=0, return_index=True, return_inverse=True
        )
        v = v[first]
        f = inv[f]
        # drop degenerate faces produced by the weld
        good = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        f = f[good]
    return v, f.astype(np.int32)


def compact(vertices: np.ndarray, faces: np.ndarray):
    """Drop unreferenced vertices and reindex faces."""
    used = np.unique(faces)
    remap = -np.ones(len(vertices), np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[faces].astype(np.int32)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (batched accumulation)."""
    p0, p1, p2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(p1 - p0, p2 - p0)  # area-weighted
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray, colors=None):
    with open(path, "w") as f:
        if colors is not None:
            for v, c in zip(vertices, colors):
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]/255} {c[1]/255} {c[2]/255}\n")
        else:
            for v in vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def save_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray, colors=None):
    """ASCII PLY with faces (ref: mesh/Mesh.cpp save paths)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            for v, c in zip(vertices, colors):
                f.write(f"{v[0]} {v[1]} {v[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n")
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def load_ply_mesh(path: str):
    """ASCII PLY mesh reader (vertices + triangular faces)."""
    with open(path) as f:
        assert f.readline().strip() == "ply"
        n_v = n_f = 0
        props_per_vertex = 0
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                props_per_vertex += 1
            elif line == "end_header":
                break
        vs = np.zeros((n_v, 3))
        cols = None
        for i in range(n_v):
            parts = f.readline().split()
            vs[i] = [float(x) for x in parts[:3]]
            if props_per_vertex >= 6:
                if cols is None:
                    cols = np.zeros((n_v, 3), np.uint8)
                cols[i] = [int(float(x)) for x in parts[3:6]]
        fs = np.zeros((n_f, 3), np.int32)
        for i in range(n_f):
            parts = f.readline().split()
            fs[i] = [int(x) for x in parts[1:4]]
    return vs, fs, cols


def load_obj(path: str):
    vs, fs = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                vs.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                fs.append([int(x.split("/")[0]) - 1 for x in p[1:4]])
    return np.array(vs), np.array(fs, np.int32)
