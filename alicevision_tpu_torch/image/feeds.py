"""Frame feeds: image folders, video files, SfM scenes.

Port of `alicevision_tpu/image/feeds.py`.
Counterpart of the reference's dataio module
(ref: src/aliceVision/dataio/ImageFeed.cpp, VideoFeed.cpp, SfMDataFeed.cpp
behind FeedProvider.hpp — uniform frame iteration for localization and
keyframe tools). Python generators with a common (image, name, intrinsics?)
yield. Video is read by the port's MJPEG AVI reader (`image/avi.py`), with
no OpenCV: the JAX package's feed goes through `cv2.VideoCapture`.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from .io import read_image

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp", ".exr", ".npy"}


def image_feed(folder: str, grayscale: bool = True) -> Iterator[tuple]:
    """Yield (image, filename) for every image in a folder (ImageFeed)."""
    for f in sorted(os.listdir(folder)):
        if os.path.splitext(f)[1].lower() in _IMAGE_EXTS:
            yield read_image(os.path.join(folder, f), grayscale=grayscale), f


def video_feed(path: str, grayscale: bool = True, stride: int = 1) -> Iterator[tuple]:
    """Yield (frame, index) from an MJPEG AVI (VideoFeed): float32 RGB in
    [0, 1], or its Rec.601 grey, every `stride`-th frame. Other codecs and
    containers raise ValueError (`image/avi.py`)."""
    from .avi import read_frames

    for frame, i in read_frames(path, stride):
        img = frame.astype(np.float32) / 255.0
        if grayscale:
            img = img @ np.array([0.299, 0.587, 0.114], np.float32)
        yield img, i


def sfm_feed(scene, grayscale: bool = True) -> Iterator[tuple]:
    """Yield (image, view_id, intrinsic_row) for views of an SfMData scene
    (SfMDataFeed); the row is the scene's torch `Intrinsics` table indexed
    at the view's intrinsic."""
    intr = scene.intrinsics_table()
    for v in range(scene.n_views):
        path = scene.view_paths[v]
        if not path or not os.path.exists(path):
            continue
        ii = int(scene.view_intrinsic[v])
        row = type(intr)(*(a[ii] for a in intr))
        yield read_image(path, grayscale=grayscale), int(scene.view_ids[v]), row


def feed_provider(source: str, **kw) -> Iterator[tuple]:
    """Dispatch on the source type (FeedProvider)."""
    if os.path.isdir(source):
        return image_feed(source, **kw)
    ext = os.path.splitext(source)[1].lower()
    if ext in (".sfm", ".json"):
        from .. import sfmdata

        return sfm_feed(sfmdata.load(source), **kw)
    if ext in (".mp4", ".avi", ".mov", ".mkv"):
        return video_feed(source, **kw)
    if ext in _IMAGE_EXTS:
        def single():
            yield read_image(source, grayscale=kw.get("grayscale", True)), os.path.basename(source)

        return single()
    raise ValueError(f"unsupported feed source: {source}")
