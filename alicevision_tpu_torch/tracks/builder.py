"""Track building: fuse pairwise matches into multi-view tracks.

Port of `alicevision_tpu/tracks/builder.py` (ref:
src/aliceVision/track/TracksBuilder.cpp:10-22, TracksBuilder.hpp:45-64).
Union-find over (view, feature) nodes is pointer chasing on the host, as in
the reference. Tracks are numbered by sorting on the union-find's root
labels, so every RANSAC input downstream follows those labels: `_union_find`
is the reference package's native algorithm (union by size, path halving,
edges in order; `alicevision_tpu/native/tracks_native.cpp:25-51`) written
as a plain Python loop, and gives the same roots. It is the only
implementation (no compiled library, no fallback): about a second per
million match edges, where the stage reads files for longer.

Fork filtering matches the reference: a track with two features in one
view is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Tracks(NamedTuple):
    # flat observation SoA, sorted by track id
    track_ids: np.ndarray  # (O,) int32 — contiguous 0..T-1
    views: np.ndarray  # (O,) int32 view index
    features: np.ndarray  # (O,) int32 feature index within the view
    n_tracks: int

    def lengths(self) -> np.ndarray:
        return np.bincount(self.track_ids, minlength=self.n_tracks)


def _union_find(a: np.ndarray, b: np.ndarray, n_nodes: int) -> np.ndarray:
    """Root label of every node after the unions (a[i], b[i]) in order:
    union by size (the larger root wins, the first on a tie), path halving."""
    parent = list(range(n_nodes))
    size = [1] * n_nodes

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(a.tolist(), b.tolist()):
        if not (0 <= u < n_nodes and 0 <= v < n_nodes):
            continue
        ru, rv = find(u), find(v)
        if ru == rv:
            continue
        if size[ru] < size[rv]:
            ru, rv = rv, ru
        parent[rv] = ru
        size[ru] += size[rv]
    return np.array([find(i) for i in range(n_nodes)], np.int64)


def build_tracks(pair_matches: dict, n_features_per_view: dict, min_track_length: int = 2) -> Tracks:
    """Fuse matches into tracks.

    pair_matches: {(view_i, view_j): (K, 2) int array of feature index pairs}
    n_features_per_view: {view: feature capacity} — defines node numbering.
    """
    views = sorted(n_features_per_view)
    offsets = {}
    total = 0
    for v in views:
        offsets[v] = total
        total += int(n_features_per_view[v])

    ea, eb = [], []
    used = np.zeros(total, bool)
    for (vi, vj), m in pair_matches.items():
        m = np.asarray(m)
        if len(m) == 0:
            continue
        na = offsets[vi] + m[:, 0]
        nb = offsets[vj] + m[:, 1]
        ea.append(na)
        eb.append(nb)
        used[na] = True
        used[nb] = True
    nodes = np.nonzero(used)[0]
    if len(nodes) == 0:
        return Tracks(np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int32), 0)
    roots = _union_find(np.concatenate(ea), np.concatenate(eb), total)[nodes]

    view_of = np.zeros(total, np.int32)
    feat_of = np.zeros(total, np.int32)
    for v in views:
        o = offsets[v]
        n = int(n_features_per_view[v])
        view_of[o : o + n] = v
        feat_of[o : o + n] = np.arange(n)

    # group by root
    order = np.argsort(roots, kind="stable")
    nodes_s = nodes[order]
    roots_s = roots[order]
    uniq, start = np.unique(roots_s, return_index=True)
    comp_id = np.zeros(len(nodes_s), np.int64)
    comp_id[start] = 1
    comp_id = np.cumsum(comp_id) - 1  # 0..T-1 per node
    tv = view_of[nodes_s]
    tf = feat_of[nodes_s]

    # fork filter (duplicate views in a track, found by sorting
    # (track, view) keys) and length filter
    T = len(uniq)
    key = comp_id * (tv.max() + 2) + tv
    ks = np.sort(key)
    bad_tracks = np.unique(ks[1:][ks[1:] == ks[:-1]] // (tv.max() + 2))
    good = np.ones(T, bool)
    good[bad_tracks] = False
    good &= np.bincount(comp_id, minlength=T) >= min_track_length

    keep = good[comp_id]
    remap = -np.ones(T, np.int64)
    kept_tracks = np.nonzero(good)[0]
    remap[kept_tracks] = np.arange(len(kept_tracks))
    return Tracks(
        track_ids=remap[comp_id[keep]].astype(np.int32),
        views=tv[keep].astype(np.int32),
        features=tf[keep].astype(np.int32),
        n_tracks=len(kept_tracks),
    )


def tracks_in_views(tracks: Tracks, view_set) -> np.ndarray:
    """Track ids observed in at least 2 of the given views
    (ref: tracksUtils::getCommonTracksInImages)."""
    mask = np.isin(tracks.views, list(view_set))
    cnt = np.bincount(tracks.track_ids[mask], minlength=tracks.n_tracks)
    return np.nonzero(cnt >= 2)[0]


def observations_table(tracks: Tracks, features_xy: dict) -> np.ndarray:
    """(O, 2) pixel coords aligned with the flat track arrays.
    features_xy: {view: (F, 2) array of keypoint coordinates}."""
    out = np.zeros((len(tracks.views), 2), np.float64)
    for v, xy in features_xy.items():
        sel = tracks.views == v
        out[sel] = np.asarray(xy)[tracks.features[sel]]
    return out
