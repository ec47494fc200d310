"""Local bundle adjustment: graph-distance parameter states.

A copy of `alicevision_tpu/sfm/local_ba.py` (numpy only; the JAX package's
`sfm/__init__` imports JAX, so the port keeps its own). Counterpart of the
reference's local BA
(ref: src/aliceVision/sfm/LocalBundleAdjustmentGraph.hpp:27,148-182 —
distance from newly-resected views over the covisibility graph decides
REFINED / CONSTANT / FIXED parameter states, the big-scene speedup of the
sequential engine). Here the states feed the BAProblem masks: CONSTANT and
FIXED both map to `cam_fixed` (our solver's masks make the distinction
unnecessary — fixed cameras simply contribute residuals without updates),
and landmarks seen only by fixed cameras become `point_fixed`.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def covisibility_from_table(
    tbl_view: np.ndarray, tbl_mask: np.ndarray, min_shared: int = 8
):
    """Vectorized covisibility from the (T, K) bucketed track table."""
    T, K = tbl_view.shape
    iu, ju = np.triu_indices(K, 1)
    a = tbl_view[:, iu]  # (T, P)
    b = tbl_view[:, ju]
    ok = tbl_mask[:, iu] & tbl_mask[:, ju]
    lo = np.minimum(a, b)[ok]
    hi = np.maximum(a, b)[ok]
    key = lo.astype(np.int64) * (tbl_view.max() + 1) + hi
    uniq, counts = np.unique(key, return_counts=True)
    sel = counts >= min_shared
    base = tbl_view.max() + 1
    return [(int(k // base), int(k % base)) for k in uniq[sel]]


def covisibility_edges(obs_view: np.ndarray, obs_landmark: np.ndarray, min_shared: int = 8):
    """View pairs sharing >= min_shared landmarks (the covisibility graph)."""
    from collections import Counter

    order = np.argsort(obs_landmark, kind="stable")
    ov = obs_view[order]
    ol = obs_landmark[order]
    bounds = np.searchsorted(ol, np.arange(ol.max() + 2 if len(ol) else 1))
    cnt: Counter = Counter()
    for t in range(len(bounds) - 1):
        vs = np.unique(ov[bounds[t] : bounds[t + 1]])
        for i in range(len(vs)):
            for j in range(i + 1, len(vs)):
                cnt[(int(vs[i]), int(vs[j]))] += 1
    return [e for e, c in cnt.items() if c >= min_shared]


def graph_distances(n_views: int, edges, sources) -> np.ndarray:
    """BFS hop distance from the source set over the view graph."""
    adj = [[] for _ in range(n_views)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    dist = np.full(n_views, np.iinfo(np.int32).max, np.int64)
    q = deque()
    for s in sources:
        dist[s] = 0
        q.append(s)
    while q:
        u = q.popleft()
        for v in adj[u]:
            if dist[v] > dist[u] + 1:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def local_ba_fixed_mask(
    n_views: int,
    edges,
    new_views,
    posed: np.ndarray,
    dist_refine: int = 1,
) -> np.ndarray:
    """cam_fixed mask: views farther than dist_refine hops from the newly
    added views are held constant (LocalBundleAdjustmentGraph semantics:
    distance 0..dist_refine REFINED, beyond -> CONSTANT/FIXED)."""
    dist = graph_distances(n_views, edges, list(new_views))
    fixed = dist > dist_refine
    fixed |= ~posed
    # always keep at least two refined... if everything fixed, unfix new views
    if fixed[list(new_views)].any():
        fixed[list(new_views)] = False
    return fixed
