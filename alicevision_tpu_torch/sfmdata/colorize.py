"""Landmark colorization: sample each landmark's color from one view (a
host copy of `alicevision_tpu/sfmdata/colorize.py`).

Mirrors the reference's colorizeTracks greedy assignment
(ref: src/aliceVision/sfmData/colorize.cpp:23-123): views are sorted by
how many landmarks they observe; each landmark is colored from the
highest-cardinality view observing it, point-sampled at its clamped
observation pixel — so every image is loaded at most once.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def colorize_tracks(
    sc, image_loader: Callable[[int], np.ndarray]
) -> np.ndarray:
    """Color all landmarks of an SfMData in place.

    image_loader(view_index) -> (H, W) grayscale float [0,1], (H, W, 3)
    float [0,1] or uint8 image for that view. Returns the (L, 3) uint8
    colors (also written to sc.colors)."""
    L = len(sc.points)
    colors = np.full((L, 3), 255, np.uint8)
    if L == 0 or len(sc.obs_view) == 0:
        sc.colors = colors
        return colors

    n_views = len(sc.view_ids)
    card = np.bincount(sc.obs_view, minlength=n_views)
    order = np.argsort(-card, kind="stable")
    rank = np.empty(n_views, np.int64)
    rank[order] = np.arange(n_views)

    obs_rank = rank[sc.obs_view]
    best = np.full(L, np.iinfo(np.int64).max)
    np.minimum.at(best, sc.obs_landmark, obs_rank)
    cand = np.nonzero(obs_rank == best[sc.obs_landmark])[0]
    _, first = np.unique(sc.obs_landmark[cand], return_index=True)
    chosen = cand[first]  # one observation per landmark

    for v in np.unique(sc.obs_view[chosen]):
        sel = chosen[sc.obs_view[chosen] == v]
        img = np.asarray(image_loader(int(v)))
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        H, W = img.shape[:2]
        uv = sc.obs_uv[sel]
        x = np.clip(np.round(uv[:, 0]).astype(np.int64), 0, W - 1)
        y = np.clip(np.round(uv[:, 1]).astype(np.int64), 0, H - 1)
        colors[sc.obs_landmark[sel]] = img[y, x]

    sc.colors = colors
    return colors


def npy_folder_loader(sc, images_folder: str):
    """Loader for the pipeline's prepared-image folders (<viewId>.npy)."""
    import os

    def load(v: int) -> np.ndarray:
        return np.load(
            os.path.join(images_folder, f"{int(sc.view_ids[v])}.npy")
        )

    return load
