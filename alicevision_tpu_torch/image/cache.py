"""Byte-capacity LRU image cache.

A host copy of `alicevision_tpu/image/cache.py`.
TPU-native counterpart of the reference's ImageCache
(ref: src/aliceVision/image/ImageCache.hpp:77-96,194-199 — LRU keyed by
(path, downscale) with a byte budget; and mvsUtils/ImagesCache.hpp:33).
Host-side by design: images live in host RAM and are fed to the chip per
stage; the cache bounds RAM the way the reference bounds it for OpenMP
feature-extraction and depth-map workers.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np


class ImageCache:
    """LRU keyed by (path, downscale); eviction by total byte size.

    read_fn(path) -> np.ndarray is pluggable so the cache also serves
    masks, depth maps, and .npy intermediates.
    """

    def __init__(self, capacity_bytes: int = 4 << 30, read_fn: Callable | None = None):
        if read_fn is None:
            from .io import read_image as read_fn  # noqa: PLW0127
        self._read = read_fn
        self.capacity = int(capacity_bytes)
        self._lock = threading.Lock()
        self._items: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, path: str, downscale: int = 1) -> np.ndarray:
        key = (path, int(downscale))
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                self.hits += 1
                return self._items[key]
        img = self._read(path)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        img = np.ascontiguousarray(img)
        with self._lock:
            self.misses += 1
            if key not in self._items:
                self._items[key] = img
                self._bytes += img.nbytes
                while self._bytes > self.capacity and len(self._items) > 1:
                    _, old = self._items.popitem(last=False)
                    self._bytes -= old.nbytes
            return self._items[key]

    def __contains__(self, key) -> bool:
        with self._lock:
            return (key if isinstance(key, tuple) else (key, 1)) in self._items

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._bytes = 0
