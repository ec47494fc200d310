"""Delaunay tetrahedralization + visibility graph-cut surface extraction.

Port of `alicevision_tpu/mesh/delaunay_graphcut.py` (ref:
src/aliceVision/fuseCut/Tetrahedralization.cpp:22-23 Geogram Delaunay,
GraphFiller.cpp:66-256 visibility votes, MaxFlow_AdjList.hpp s-t mincut,
Mesher.cpp:543+ facet extraction). Irregular geometry stays on the host, as
in both references: scipy's Delaunay, vectorized tet walks that locate the
samples of every visibility ray, and the s-t cut in the port's C++ max-flow
(`native.maxflow`, which raises where it cannot be built; the reference
falls back to scipy). The code is the reference's, copied.
"""

from __future__ import annotations

import time

import numpy as np
from scipy.spatial import Delaunay


def tetrahedralize(points: np.ndarray) -> Delaunay:
    """Delaunay of the fused cloud (Tetrahedralization equivalent)."""
    return Delaunay(points, qhull_options="QJ")  # joggle degenerate input


def _sample_ts(n_samples: int) -> np.ndarray:
    """Quadratic near-target sample spacing (see _segment_cells)."""
    n_near = (3 * n_samples) // 4
    ts_near = 1.0 - 0.25 * np.linspace(0.0, 1.0, n_near) ** 2  # (0.75, 1.0]
    ts_far = np.linspace(0.05, 0.75, n_samples - n_near)
    return np.concatenate([ts_far, ts_near[::-1]])


def _locate_walk(tri: Delaunay, X: np.ndarray, seed: np.ndarray,
                 max_steps: int = 96,
                 rng: np.random.RandomState | None = None,
                 Tm: np.ndarray | None = None):
    """Vectorized tet-walk point location: from `seed` simplices, step each
    query through the face opposite its most-negative barycentric
    coordinate until containment (the classic walk the reference's Geogram
    locate uses; qhull's find_simplex walk goes SUPERLINEAR past ~1M cells
    — measured 13 s at 1.2M cells vs 189 s at 3.1M for the same query
    load).

    The greedy face choice can CYCLE on near-degenerate tets (measured: a
    small non-converging tail kept ~the whole query load active for 256
    steps at 6.3M cells — 395 s of pure churn). After a greedy prefix the
    walk switches to the stochastic variant (uniform random face among the
    negative coordinates), which terminates with probability 1.

    Returns (simplex ids with -1 for not-found, exited_hull mask). A -1
    with exited_hull=False means the walk hit max_steps (degenerate
    pocket), NOT that the point is outside.

    `Tm` lets callers pass a pre-cast FLOAT32 transform table: the walk is
    bound by the (n, 4, 3) transform gathers, and tri.transform is f64 —
    casting once per surface extraction instead of per call halves the
    gathered bytes (the -1e-4 containment slack absorbs f32 rounding; a
    sample settling one cell over shifts a vote by one cell, which the
    aggregate is insensitive to)."""
    if Tm is None:
        Tm = tri.transform  # (S, 4, 3): rows 0..2 inverse affine, row 3 = r
    eps = -1e-4 if Tm.dtype == np.float32 else -1e-12
    nb = tri.neighbors
    if rng is None:
        rng = np.random.RandomState(0)
    X = X.astype(Tm.dtype, copy=False)
    N = len(X)
    out = np.full(N, -1, np.int64)
    exited = np.zeros(N, bool)
    act = np.nonzero(seed >= 0)[0]
    cur = seed[act].astype(np.int64)
    Xa = X[act]
    for step in range(max_steps):
        if len(act) == 0:
            break
        Tr = Tm[cur]  # (n, 4, 3)
        c3 = np.einsum("nij,nj->ni", Tr[:, :3], Xa - Tr[:, 3])
        bary = np.concatenate([c3, (1.0 - c3.sum(1))[:, None]], 1)  # (n, 4)
        if step < 24:  # greedy prefix: steepest descent face
            k = np.argmin(bary, 1)
        else:  # stochastic walk: random face among negative coords
            neg = bary < eps
            r = rng.random_sample(bary.shape)
            r[~neg] = -1.0
            k = np.argmax(r, 1)
        inside = bary[np.arange(len(act)), k] >= eps
        out[act[inside]] = cur[inside]
        rem = ~inside
        nxt = nb[cur[rem], k[rem]]
        alive = nxt >= 0  # stepping through a hull face -> outside
        rem_idx = act[rem]
        exited[rem_idx[~alive]] = True
        act = rem_idx[alive]
        cur = nxt[alive]
        Xa = X[act]
    return out, exited


def _segment_cells(tri: Delaunay, a: np.ndarray, b: np.ndarray,
                   n_samples: int, seed: np.ndarray | None = None,
                   Tm: np.ndarray | None = None):
    """Cells crossed by segments a->b (N, 3 each), by batched sampling.

    Cameras usually sit outside the convex hull, so uniform sampling along
    the segment wastes almost all queries — concentrate samples toward the
    target (quadratic spacing) with a small uniform prefix for carving.
    Returns (N, n_samples) simplex ids (-1 outside hull).

    With `seed` (a containing/incident simplex per segment's b-endpoint)
    the samples are located by COHERENT tet walks, nearest-to-b first,
    each sample seeded by the previous one's cell: total walk work is
    ~O(cells actually crossed). The hull is convex, so once a sample
    falls outside, every farther sample on that ray is outside too.
    Without seeds, falls back to qhull's find_simplex."""
    ts = _sample_ts(n_samples)
    if seed is None:
        pts = a[:, None, :] * (1 - ts[None, :, None]) + b[:, None, :] * ts[
            None, :, None
        ]
        flat = pts.reshape(-1, 3).astype(np.float64)
        # bbox prefilter: camera-side samples sit far OUTSIDE the hull, and
        # qhull's outside-hull find_simplex is its slow path (measured ~10x
        # the inside-query cost)
        lo = tri.min_bound - 1e-9
        hi = tri.max_bound + 1e-9
        inside = np.all((flat >= lo) & (flat <= hi), axis=1)
        simp = np.full(len(flat), -1, np.int64)
        if inside.any():
            simp[inside] = tri.find_simplex(flat[inside])
        return simp.reshape(len(a), n_samples)

    N = len(a)
    order = np.argsort(-ts)  # walk nearest-to-b first
    out = np.full((N, n_samples), -1, np.int64)
    cur_seed = seed.astype(np.int64).copy()
    alive = np.nonzero(cur_seed >= 0)[0]
    for j in order:
        if len(alive) == 0:
            break
        t = ts[j]
        X = a[alive] * (1.0 - t) + b[alive] * t
        res, exited = _locate_walk(tri, X, cur_seed[alive], Tm=Tm)
        out[alive, j] = res
        # a ray dies only on a CONFIRMED hull exit (convexity: all farther
        # samples are outside too); a max-steps walk keeps its previous
        # seed so the next sample retries from the last good cell
        found = res >= 0
        cur_seed[alive[found]] = res[found]
        alive = alive[~exited]
    return out


def _vertex_incident_simplex(tri: Delaunay, n_points: int) -> np.ndarray:
    """One incident simplex per vertex (walk seeds), vectorized."""
    vt = np.full(n_points, -1, np.int64)
    sim = tri.simplices
    vt[sim.ravel()] = np.repeat(np.arange(len(sim), dtype=np.int64), 4)
    return vt


def graph_cut_surface(
    points: np.ndarray,  # (P, 3) fused cloud
    vis_point: np.ndarray,  # (K,) point index of each visibility link
    vis_cam_center: np.ndarray,  # (K, 3) camera center of the link
    n_ray_samples: int = 24,
    behind_frac: float = 0.02,
    lambda_smooth: float = 0.5,
    capacity_scale: float = 100.0,
    empty_gain: float = 8.0,
    seconds: dict | None = None,
):
    """Extract the watertight-ish surface between empty and full space.

    Votes (GraphFiller semantics): cells crossed by a camera->point ray get
    EMPTY (source) capacity; the cell just behind the point along the ray
    gets FULL (sink) capacity. Facets between adjacent cells get a constant
    smoothness capacity; the s-t mincut labels cells and the surface is the
    set of facets between different labels.

    Returns (vertices (V, 3), faces (F, 3) int32). A `seconds` dict gets
    the wall seconds of the Delaunay, the votes, the cut and the facet
    extraction.
    """
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        now = time.perf_counter()
        seconds[name] = now - t0
        t0 = now

    tri = tetrahedralize(points)
    lap("delaunay")
    n_cells = len(tri.simplices)

    # --- accumulate votes -------------------------------------------------
    # every query is a seeded coherent tet walk (see _locate_walk): each
    # ray starts at a simplex incident to its own target VERTEX and walks
    # outward sample by sample — qhull's find_simplex goes superlinear
    # past ~1M cells (the reference buckets lookups in an octree for the
    # same reason, fuseCut/Octree.hpp)
    a = vis_cam_center.astype(np.float64)
    b = points[vis_point].astype(np.float64)
    vert_tet = _vertex_incident_simplex(tri, len(points))
    seeds = vert_tet[vis_point]
    Tm32 = tri.transform.astype(np.float32)  # cast ONCE (see _locate_walk)
    crossed = _segment_cells(
        tri, a, b * 0.999 + a * 0.001, n_ray_samples, seed=seeds, Tm=Tm32
    )

    flat = crossed.ravel()
    okf = flat >= 0
    empty_votes = np.bincount(
        flat[okf], minlength=n_cells
    ).astype(np.float64) * (empty_gain / n_ray_samples)

    # Sensor placement decides the prior on the space beyond the hull:
    # sensors OUTSIDE the hull (photogrammetry) see through it — beyond-hull
    # is empty; sensors INSIDE (panoramic lidar scanning a room) mean the
    # hull IS the surface and beyond it is matter.
    inside_out = (tri.find_simplex(np.unique(a, axis=0)) >= 0).mean() > 0.5

    # cell just behind each point
    behind_pts = b + (b - a) * behind_frac
    behind, _ = _locate_walk(tri, behind_pts, seeds, Tm=Tm32)
    ok = behind >= 0
    full_votes = np.bincount(
        behind[ok], minlength=n_cells
    ).astype(np.float64)
    # Inside-out scans put surface points ON the hull, so the behind-sample
    # exits it; vote the point's own cell FULL, strongly enough to beat the
    # near-point empty samples (the reference's t-edge forcing plays the
    # same role, GraphFiller.cpp:256).
    miss = ~ok
    if inside_out and miss.any():
        own, _ = _locate_walk(
            tri, b[miss] - (b[miss] - a[miss]) * behind_frac, seeds[miss],
            Tm=Tm32,
        )
        own_ok = own >= 0
        full_votes += np.bincount(
            own[own_ok], minlength=n_cells
        ).astype(np.float64) * (1.0 + empty_gain)

    lap("votes")

    # --- build flow graph + cut (native solver, float caps) ---------------
    from .. import native

    nb = tri.neighbors  # (n_cells, 4), -1 = hull boundary
    terminal = empty_votes - full_votes  # >0 source(empty), <0 sink(full)
    # Hull-boundary facets face infinite space: bias per the sensor prior.
    hull_sign = -1.0 if inside_out else 1.0
    hull_bonus = hull_sign * 0.25 * (nb < 0).sum(axis=1)
    terminal = terminal + hull_bonus

    # fully vectorized edge list (a Python loop over n_cells x 4 costs
    # minutes at the ~7M-cell scale of a 1M-point fusion)
    cell_ids = np.arange(n_cells, dtype=np.int64)
    emask = nb > cell_ids[:, None]
    eu = np.repeat(cell_ids, 4)[emask.ravel()]
    ev = nb.ravel()[emask.ravel()].astype(np.int64)
    lam = np.full(len(eu), lambda_smooth)
    _, cell_empty = native.maxflow(n_cells, eu, ev, lam, lam, terminal)
    lap("cut")

    # --- extract facets between empty and full cells (vectorized) ---------
    # local facet f of a tet = the 3 vertices excluding vertex f
    facet_idx = np.array(
        [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)], np.int64
    )
    cell_empty = np.asarray(cell_empty, bool)
    nb_valid = nb >= 0
    fmask = (
        cell_empty[:, None]
        & nb_valid
        & ~cell_empty[np.clip(nb, 0, n_cells - 1)]
    )  # (n_cells, 4): surface facets seen from their EMPTY side
    cells_f, fs = np.nonzero(fmask)
    verts_of_cell = tri.simplices[cells_f]  # (F, 4)
    faces = np.take_along_axis(
        verts_of_cell, facet_idx[fs], axis=1
    )  # (F, 3)
    # orient each face so its normal points toward the empty cell: the
    # excluded vertex (the tet apex) lies in the EMPTY cell; flip when the
    # normal points away from it
    p0 = points[faces[:, 0]]
    p1 = points[faces[:, 1]]
    p2 = points[faces[:, 2]]
    nrm = np.cross(p1 - p0, p2 - p0)
    centroid = (p0 + p1 + p2) / 3.0
    apex = points[verts_of_cell[np.arange(len(cells_f)), fs]]
    flip = np.einsum("fi,fi->f", nrm, apex - centroid) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    faces = faces.reshape(-1, 3)
    # compact vertices
    used = np.unique(faces)
    remap = -np.ones(len(points), np.int64)
    remap[used] = np.arange(len(used))
    lap("facets")
    return points[used], remap[faces].astype(np.int32)
