"""Middlebury MVS dataset import.

A host copy of `alicevision_tpu/sfmdata/middlebury.py`.
Counterpart of the reference's Middlebury loader
(ref: src/aliceVision/sfmDataIO/middlebury.cpp, used by
src/software/pipeline/main_importMiddlebury.cpp). The `*_par.txt` format:
first line = image count, then one line per image:
`name k11..k33 r11..r33 t1 t2 t3` with x_cam = R x_world + t.
"""

from __future__ import annotations

import os

import numpy as np

from .scene import SfMData


def import_middlebury(par_path: str, images_folder: str | None = None) -> SfMData:
    folder = images_folder or os.path.dirname(par_path)
    with open(par_path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    pos = 1
    sc = SfMData.empty()
    for i in range(n):
        name = tokens[pos]
        vals = np.array([float(t) for t in tokens[pos + 1 : pos + 22]])
        pos += 22
        K = vals[0:9].reshape(3, 3)
        R = vals[9:18].reshape(3, 3)
        t = vals[18:21]
        c = -R.T @ t
        w, h = 640, 480
        path = os.path.join(folder, name)
        if os.path.exists(path):
            try:
                from ..image.io import read_image

                im = read_image(path)
                h, w = im.shape[:2]
            except Exception:
                pass
        ii = sc.add_intrinsic(
            i,
            w,
            h,
            float(K[0, 0]),
            focal_y_px=float(K[1, 1]),
            offset=(float(K[0, 2]) - 0.5 * w, float(K[1, 2]) - 0.5 * h),
        )
        vi = sc.add_view(i, ii, w, h, path=path, frame_id=i)
        sc.set_pose(vi, R, c)
    return sc
