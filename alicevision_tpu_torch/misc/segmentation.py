"""Semantic segmentation masks with tiled inference.

Port of `alicevision_tpu/misc/segmentation.py`: the tiling and feathering
harness and the classical sky scorer are host numpy and scipy as there
(copied); `onnx_model` runs the port's own ONNX executor
(`utils/onnx_rt.py`) on the caller's device. Counterpart of the
reference's ONNX-backed segmentation
(ref: src/aliceVision/segmentation/segmentation.hpp:28-58 tiled inference,
:119-120 ONNX Runtime session).

`onnx_model` has no onnxruntime branch (it would take the network off the
device when the package is present); `have_onnxruntime` stays a probe. A
graph that declares several outputs gives its first, as ONNX Runtime's
`sess.run(None, ...)[0]` does (the JAX package stacks them, ROADMAP §3).
"""

from __future__ import annotations

import numpy as np


def segment_tiled(
    image: np.ndarray,  # (H, W, C) float
    model,  # callable (tile (h, w, C)) -> (h, w) or (h, w, K) scores
    tile: int = 512,
    overlap: int = 64,
) -> np.ndarray:
    """Run `model` over overlapping tiles and blend with linear feathering
    (the reference's tiled-inference scheme for large images)."""
    H, W = image.shape[:2]
    step = tile - overlap
    first = model(image[: min(tile, H), : min(tile, W)])
    K = 1 if first.ndim == 2 else first.shape[-1]
    acc = np.zeros((H, W, K), np.float64)
    wacc = np.zeros((H, W, 1), np.float64)

    def feather(h, w):
        wy = np.minimum(np.arange(h) + 1, np.arange(h)[::-1] + 1)
        wx = np.minimum(np.arange(w) + 1, np.arange(w)[::-1] + 1)
        f = np.minimum(wy[:, None], wx[None, :]).astype(np.float64)
        return (f / f.max())[..., None]

    ys = list(range(0, max(H - overlap, 1), step))
    xs = list(range(0, max(W - overlap, 1), step))
    for y0 in ys:
        for x0 in xs:
            y1, x1 = min(y0 + tile, H), min(x0 + tile, W)
            out = model(image[y0:y1, x0:x1])
            if out.ndim == 2:
                out = out[..., None]
            f = feather(y1 - y0, x1 - x0)
            acc[y0:y1, x0:x1] += out * f
            wacc[y0:y1, x0:x1] += f
    res = acc / np.maximum(wacc, 1e-9)
    return res[..., 0] if K == 1 else res


def sky_mask_classical(image: np.ndarray) -> np.ndarray:
    """Heuristic sky scorer for (h, w, 3) RGB tiles in [0, 1]: bright,
    blue-dominant, low-texture regions score high."""
    import scipy.ndimage as ndi

    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    lum = 0.299 * r + 0.587 * g + 0.114 * b
    blueness = np.clip(b - np.maximum(r, g) + 0.5, 0, 1)
    grad = np.hypot(*np.gradient(ndi.gaussian_filter(lum, 1.0)))
    smooth = np.exp(-40.0 * grad)
    return np.clip(blueness * smooth * np.clip(lum * 1.5, 0, 1), 0, 1)


def segment_sky(image: np.ndarray, threshold: float = 0.35) -> np.ndarray:
    """Binary sky mask for an RGB image (main_imageSegmentation's common
    use-case), via the tiled harness + classical fallback model."""
    score = segment_tiled(image, sky_mask_classical)
    return score > threshold


def have_onnxruntime() -> bool:
    try:
        import onnxruntime  # noqa: F401

        return True
    except ImportError:
        return False


def onnx_model(model_path: str, input_name: str | None = None, device="cuda"):
    """A tile callable for `segment_tiled` over an `.onnx` network (the
    reference's ORT session, segmentation.hpp:119-120): the port's
    `OnnxModel` on `device`, the tile in as NCHW float32, the graph's first
    output back as (h, w, K) numpy."""
    from ..utils.onnx_rt import OnnxModel

    net = OnnxModel(model_path, device=device)
    iname = input_name or net.input_names[0]

    def run(tile: np.ndarray) -> np.ndarray:
        x = np.asarray(tile, np.float32)
        if x.ndim == 2:
            x = x[..., None]
        x = np.transpose(x, (2, 0, 1))[None]  # NCHW
        out = net(**{iname: x})
        if isinstance(out, tuple):  # several outputs: the first, as sess.run(None, ...)[0]
            out = out[0]
        out = out.float().cpu().numpy() if out.is_floating_point() else out.cpu().numpy()
        if out.ndim == 4:  # (1, K, h, w) -> (h, w, K)
            out = np.transpose(out[0], (1, 2, 0))
        elif out.ndim == 3:
            out = out[0]
        return out

    return run
