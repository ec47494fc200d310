"""Manifold repair — the reference's MeshClean pass (a host copy of
`alicevision_tpu/mesh/clean.py`).

The graph-cut surface (and any fused/merged mesh) can contain degenerate
triangles, duplicated faces, edges shared by more than two faces, and
"bowtie" vertices whose incident faces form several disconnected fans.
The reference repairs these with per-vertex pointer surgery
(ref: src/aliceVision/mesh/MeshClean.hpp, meshPostProcessing.cpp); here the
repair is expressed as vectorized numpy passes over flat edge/face tables —
sorting and segment reductions instead of per-element linked-list walks.
Only the (rare) bowtie split iterates, and it iterates over the handful of
non-manifold vertices, not the mesh.

All functions take/return (vertices (V,3) f32, faces (F,3) int) arrays.
"""

from __future__ import annotations

import numpy as np

from .ops import compact


def _edge_keys(faces: np.ndarray) -> np.ndarray:
    """(3F, 2) undirected edge list, vertex-sorted within each edge."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return np.sort(e, axis=1)


def remove_degenerate_faces(
    vertices: np.ndarray, faces: np.ndarray, min_area: float = 0.0
) -> np.ndarray:
    """Drop faces with repeated vertices or (optionally) tiny area."""
    f = np.asarray(faces)
    ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    if min_area > 0.0:
        p0, p1, p2 = (vertices[f[:, i]] for i in range(3))
        area2 = np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
        ok &= area2 > 2.0 * min_area
    return f[ok]


def remove_duplicate_faces(faces: np.ndarray) -> np.ndarray:
    """Drop faces that reference the same vertex set (any winding)."""
    key = np.sort(faces, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    return faces[np.sort(first)]


def remove_nonmanifold_edges(
    faces: np.ndarray, vertices: np.ndarray | None = None
) -> np.ndarray:
    """Keep at most two faces per undirected edge.

    When an edge is shared by 3+ faces the dropped ones should be the fins
    (the reference's MeshClean similarly peels non-manifold fins before
    vertex surgery). Topology alone cannot always tell a fin from a lone
    surface face — both can have one hot edge and two boundary edges — so
    when `vertices` is given, faces on a hot edge are ranked geometrically:
    a genuine surface face has some other face on the edge it is near-
    coplanar with, a fin is incompatible with all of them. The face with
    the worst best-partner planarity is dropped first; ties fall back to
    (hot-edge count, boundary-edge count).
    """
    faces = np.asarray(faces)
    vertices = None if vertices is None else np.asarray(vertices, np.float64)
    while True:
        edges = _edge_keys(faces)
        uniq, inv, counts = np.unique(
            edges, axis=0, return_inverse=True, return_counts=True
        )
        over = counts[inv] > 2  # (3F,) this slot lies on a >2-face edge
        over3 = over.reshape(3, -1).T  # (F, 3)
        bad_face = over3.any(axis=1)
        if not bad_face.any():
            return faces
        # Greedy, but only over the faces that touch a hot edge: count every
        # face's contribution per hot edge (vectorized bincount over the
        # unique-edge ids), then walk the bad faces worst-first and drop
        # each one that still leaves some edge over-subscribed. Ties between
        # a fin and a genuine surface face are broken by boundary (count==1)
        # edges: fins dangle off the surface, surface faces have manifold
        # neighbours on their other edges.
        boundary3 = (counts[inv] == 1).reshape(3, -1).T  # (F, 3)
        score = (over3.sum(axis=1) * 4 + boundary3.sum(axis=1)).astype(np.float64)
        if vertices is not None:
            # geometric fin-ness: 1 - best |n_f . n_g| over partner faces
            # sharing a hot edge (winding-agnostic planarity)
            p0 = vertices[faces[:, 0]]
            n = np.cross(vertices[faces[:, 1]] - p0, vertices[faces[:, 2]] - p0)
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
            inv_cols = inv.reshape(3, -1)  # (3, F) unique-edge id per slot
            best_partner = np.zeros(len(faces))
            for eid in np.nonzero(counts > 2)[0]:
                f_ids = np.unique(np.nonzero((inv_cols == eid).any(axis=0))[0])
                plan = np.abs(n[f_ids] @ n[f_ids].T)
                np.fill_diagonal(plan, -1.0)
                best_partner[f_ids] = np.maximum(
                    best_partner[f_ids], plan.max(axis=1)
                )
            # fin-ness dominates; topological score breaks exact ties
            score = (1.0 - best_partner) * 100.0 + score
        hot_ids = np.nonzero(counts > 2)[0]
        hot_pos = -np.ones(len(uniq), np.int64)
        hot_pos[hot_ids] = np.arange(len(hot_ids))
        edge_cnt = counts[hot_ids].copy()
        inv_f = inv.reshape(3, -1).T  # (F, 3) unique-edge id per face edge
        keep = np.ones(len(faces), bool)
        bad_order = np.nonzero(bad_face)[0]
        bad_order = bad_order[np.argsort(-score[bad_order], kind="stable")]
        for f_id in bad_order:
            slots = hot_pos[inv_f[f_id]]
            slots = slots[slots >= 0]
            if (edge_cnt[slots] > 2).any():
                keep[f_id] = False
                edge_cnt[slots] -= 1
        faces = faces[keep]


def split_nonmanifold_vertices(
    vertices: np.ndarray, faces: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Duplicate "bowtie" vertices so each copy owns one connected fan.

    A vertex is non-manifold when its incident faces do not form a single
    edge-connected fan. Each extra fan gets its own copy of the vertex
    (identical position) — the same outcome as MeshClean's path surgery.
    """
    vertices = np.asarray(vertices)
    faces = np.asarray(faces).copy()
    F = len(faces)
    if F == 0:
        return vertices, faces

    # incidence: per vertex, the list of faces touching it
    fi = np.tile(np.arange(F), 3)
    vi = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    order = np.argsort(vi, kind="stable")
    vi_s, fi_s = vi[order], fi[order]
    starts = np.searchsorted(vi_s, np.arange(len(vertices) + 1))

    new_v: list[np.ndarray] = []
    next_id = len(vertices)
    for v in range(len(vertices)):
        f_ids = fi_s[starts[v] : starts[v + 1]]
        if len(f_ids) <= 1:
            continue
        # union-find over this vertex's faces: connected iff they share an
        # edge through v (i.e. share the *other* vertex of an edge at v)
        sub = faces[f_ids]
        # the two neighbors of v in each face
        neigh = np.empty((len(f_ids), 2), np.int64)
        for k, fverts in enumerate(sub):
            neigh[k] = [x for x in fverts if x != v][:2]
        parent = list(range(len(f_ids)))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        seen: dict[int, int] = {}
        for k in range(len(f_ids)):
            for w in neigh[k]:
                w = int(w)
                if w in seen:
                    ra, rb = find(seen[w]), find(k)
                    if ra != rb:
                        parent[ra] = rb
                else:
                    seen[w] = k
        roots = [find(k) for k in range(len(f_ids))]
        uniq_roots = sorted(set(roots))
        if len(uniq_roots) == 1:
            continue
        # first fan keeps v, later fans get fresh copies
        for r in uniq_roots[1:]:
            fan = f_ids[np.asarray([rt == r for rt in roots])]
            for f_id in fan:
                faces[f_id, faces[f_id] == v] = next_id
            new_v.append(vertices[v])
            next_id += 1
    if new_v:
        vertices = np.concatenate([vertices, np.stack(new_v)], axis=0)
    return vertices, faces


def boundary_loops(faces: np.ndarray) -> list[np.ndarray]:
    """Ordered vertex loops of boundary edges (edges with one face)."""
    edges = _edge_keys(faces)
    uniq, inv, counts = np.unique(
        edges, axis=0, return_inverse=True, return_counts=True
    )
    bnd = uniq[counts == 1]
    if len(bnd) == 0:
        return []
    nxt: dict[int, list[int]] = {}
    for a, b in bnd:
        nxt.setdefault(int(a), []).append(int(b))
        nxt.setdefault(int(b), []).append(int(a))
    visited: set[tuple[int, int]] = set()
    loops = []
    for a0, b0 in map(tuple, bnd):
        if (a0, b0) in visited:
            continue
        loop = [int(a0), int(b0)]
        visited.add((a0, b0))
        visited.add((b0, a0))
        while True:
            cur, prev = loop[-1], loop[-2]
            cands = [w for w in nxt.get(cur, []) if w != prev]
            cands = [
                w
                for w in cands
                if (min(cur, w), max(cur, w)) not in visited or w == loop[0]
            ]
            if not cands:
                break
            w = cands[0]
            if w == loop[0]:
                loops.append(np.asarray(loop, np.int64))
                break
            visited.add((min(cur, w), max(cur, w)))
            visited.add((max(cur, w), min(cur, w)))
            loop.append(w)
    return loops


def fill_small_holes(
    vertices: np.ndarray, faces: np.ndarray, max_edges: int = 8
) -> np.ndarray:
    """Fan-triangulate boundary loops with at most max_edges edges.

    Orientation follows the existing surface: the new fan is flipped when
    its normal disagrees with the loop's incident faces.
    """
    loops = boundary_loops(faces)
    add = []
    for loop in loops:
        n = len(loop)
        if n < 3 or n > max_edges:
            continue
        c = vertices[loop].mean(axis=0)
        ring = vertices[loop] - c
        loop_n = np.cross(ring, np.roll(ring, -1, axis=0)).sum(axis=0)
        # average normal of faces touching the loop
        touch = np.isin(faces, loop).any(axis=1)
        tf = faces[touch]
        p0, p1, p2 = (vertices[tf[:, i]] for i in range(3))
        surf_n = np.cross(p1 - p0, p2 - p0).sum(axis=0)
        flip = float(np.dot(loop_n, surf_n)) < 0
        for k in range(1, n - 1):
            tri = (loop[0], loop[k], loop[k + 1])
            add.append(tri[::-1] if flip else tri)
    if not add:
        return faces
    return np.concatenate([faces, np.asarray(add, faces.dtype)], axis=0)


def clean_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    min_area: float = 0.0,
    fill_holes_max_edges: int = 0,
    keep_largest: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Full MeshClean pass: degenerate + duplicate faces, non-manifold
    edges, bowtie vertices, optional small-hole filling and small-segment
    removal. Returns a compacted (vertices, faces)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    faces = remove_degenerate_faces(vertices, faces, min_area=min_area)
    faces = remove_duplicate_faces(faces)
    faces = remove_nonmanifold_edges(faces, vertices)
    vertices, faces = split_nonmanifold_vertices(vertices, faces)
    if fill_holes_max_edges > 2:
        faces = fill_small_holes(vertices, faces, fill_holes_max_edges)
    if keep_largest:
        from .ops import largest_component

        return largest_component(vertices, faces)
    return compact(vertices, faces.astype(np.int64))
