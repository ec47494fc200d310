"""Reference-compatible feature and match file IO.

A copy of `alicevision_tpu/features/io.py` (host numpy).

Formats match the C++ reference bit-for-bit so outputs interoperate:
  * ``<viewId>.<desc>.feat`` — text, one "x y scale orientation" per line
    (ref: src/aliceVision/feature/PointFeature.hpp:78-86);
  * ``<viewId>.<desc>.desc`` — binary, size_t count then raw descriptors
    (ref: src/aliceVision/feature/Descriptor.hpp readDescsFromBinFile);
  * ``matches.txt`` — "I J / nbDescType / descType nbMatches / i j ..."
    (ref: src/aliceVision/matching/io.cpp:28-80).
"""

from __future__ import annotations

import os

import numpy as np


def save_feat(path: str, xy: np.ndarray, scale: np.ndarray, orientation: np.ndarray):
    with open(path, "w") as f:
        for (x, y), s, o in zip(np.asarray(xy), np.asarray(scale), np.asarray(orientation)):
            f.write(f"{x} {y} {s} {o}\n")


def load_feat(path: str):
    data = np.loadtxt(path, ndmin=2, dtype=np.float64)
    if data.size == 0:
        data = data.reshape(0, 4)
    return data[:, :2], data[:, 2], data[:, 3]


def save_desc(path: str, desc: np.ndarray):
    """Binary descriptor file: uint64 count + raw data (uint8 for SIFT)."""
    desc = np.asarray(desc)
    with open(path, "wb") as f:
        f.write(np.uint64(len(desc)).tobytes())
        f.write(np.ascontiguousarray(desc).tobytes())


def load_desc(path: str, dim: int = 128, dtype=np.uint8):
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), np.uint64)[0])
        data = np.frombuffer(f.read(), dtype)
    return data.reshape(n, dim)


def save_matches_txt(path: str, pair_matches: dict, desc_type: str = "sift"):
    """pair_matches: {(I, J): (K, 2) int arrays}."""
    with open(path, "w") as f:
        for (i, j), m in sorted(pair_matches.items()):
            m = np.asarray(m)
            f.write(f"{i} {j}\n1\n{desc_type} {len(m)}\n")
            for a, b in m:
                f.write(f"{a} {b}\n")


def load_matches_txt(path: str) -> dict:
    out: dict = {}
    with open(path) as f:
        tokens = f.read().split()
    k = 0
    while k < len(tokens):
        i, j, nb_desc = int(tokens[k]), int(tokens[k + 1]), int(tokens[k + 2])
        k += 3
        all_m = []
        for _ in range(nb_desc):
            # descType string then count
            n = int(tokens[k + 1])
            k += 2
            m = np.array(tokens[k : k + 2 * n], np.int64).reshape(n, 2)
            k += 2 * n
            all_m.append(m)
        out[(i, j)] = np.concatenate(all_m) if all_m else np.zeros((0, 2), np.int64)
    return out


def save_view_features(
    folder: str, view_id: int, feats: dict, desc_type: str = "sift", quantize=None
):
    """Write the reference pair (<id>.<type>.feat + .desc) from our
    fixed-capacity feature dict (masked rows dropped)."""
    v = np.asarray(feats["valid"]).astype(bool)
    xy = np.asarray(feats["xy"])[v]
    sc = np.asarray(feats["scale"])[v]
    ori = np.asarray(feats["orientation"])[v]
    desc = np.asarray(feats["desc"])[v]
    if quantize is None:
        quantize = desc.dtype != np.uint8
    if quantize:
        desc = np.clip(desc * 512.0, 0, 255).astype(np.uint8)
    save_feat(os.path.join(folder, f"{view_id}.{desc_type}.feat"), xy, sc, ori)
    save_desc(os.path.join(folder, f"{view_id}.{desc_type}.desc"), desc)


def load_view_features(folder: str, view_id: int, desc_type: str = "sift"):
    xy, sc, ori = load_feat(os.path.join(folder, f"{view_id}.{desc_type}.feat"))
    desc = load_desc(os.path.join(folder, f"{view_id}.{desc_type}.desc"))
    return {
        "xy": xy,
        "scale": sc,
        "orientation": ori,
        "desc": desc.astype(np.float32) / 512.0,
        "valid": np.ones(len(xy), bool),
    }
