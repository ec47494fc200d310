"""Video keyframe selection: sharpness + motion scoring, smart selection.

Port of `alicevision_tpu/keyframe/selector.py`, the counterpart of the
reference's keyframe module (ref: src/aliceVision/keyframe/KeyframeSelector.hpp:66-98;
KeyframeSelector.cpp:195-340 smart selection, :996-1062 computeSharpness,
:1104-1190 estimateFlow). Scoring parity:

  * sharpness score = MAX over a sliding window (stride = windowSize/4) of
    the standard deviation of the image Laplacian, computed from integral
    images (KeyframeSelector.cpp:996-1062): all windows at once from two
    cumsum tables;
  * flow score = MEDIAN over cells of the mean per-cell displacement
    magnitude (estimateFlow's motionByCell, :1161-1190). The reference's
    DeepFlow is replaced by PYRAMIDAL block matching (coarse-to-fine
    integer search refined per level, evaluated as stacked shifted-
    difference maps). The median averages the two middle cells of an even
    count, as `jnp.median` does (`torch.median` takes the lower one);
  * smart selection follows the reference exactly: accumulate flow scores
    until `pxDisplacement % of min(W, H)`, adjust the step by +-0.5 until
    the keyframe count lands in [minOutFrames, maxOutFrames] (regular
    sampling once the step hits 0), then pick per subsequence the frame
    maximizing sharpness x a triangular center-weight in [1, 2]
    (KeyframeSelector.cpp:195-340). The selection itself is host numpy.

Images are (H, W) tensors on the device the scores run on.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..image.filtering import gaussian_blur


def _integral(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 2-D integral image (cv::integral semantics)."""
    s = torch.cumsum(torch.cumsum(x, dim=0), dim=1)
    return F.pad(s, (1, 0, 1, 0))


def sharpness_score(img: torch.Tensor, window_size: int = 200) -> torch.Tensor:
    """Max windowed Laplacian-stddev (computeSharpness, .cpp:996-1062).

    All sliding windows (stride windowSize/4) are evaluated in one shot
    from the integral and squared-integral tables of the Laplacian."""
    H, W = img.shape
    window_size = int(min(window_size, H, W))
    lap = (
        -4.0 * img
        + torch.roll(img, 1, 0)
        + torch.roll(img, -1, 0)
        + torch.roll(img, 1, 1)
        + torch.roll(img, -1, 1)
    )
    s1 = _integral(lap)
    s2 = _integral(lap * lap)
    step = max(window_size // 4, 1)
    ys = np.unique(np.r_[np.arange(0, H - window_size + 1, step), H - window_size])
    xs = np.unique(np.r_[np.arange(0, W - window_size + 1, step), W - window_size])
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    gy = torch.as_tensor(gy.ravel(), device=img.device)
    gx = torch.as_tensor(gx.ravel(), device=img.device)
    w = window_size

    def box(tbl):
        return tbl[gy + w, gx + w] + tbl[gy, gx] - tbl[gy, gx + w] - tbl[gy + w, gx]

    n = float(w * w)
    var = (box(s2) - box(s1) ** 2 / n) / n
    return torch.sqrt(var.clamp(min=0.0).max())


def block_flow_field(
    a: torch.Tensor, b: torch.Tensor, block: int = 16, search: int = 4,
    levels: int = 3,
) -> tuple:
    """Pyramidal block-matching flow: per-block (dy, dx) at full scale.

    Coarse-to-fine: the search at level l covers +-search * 2^l pixels at
    full resolution, so large displacements are captured without widening
    the per-level stack. Everything is batched shifted-difference maps.
    Each level past the coarsest reads the largest initial displacement on
    the host, once, as the JAX package does."""
    # proper image pyramid: low-pass before each decimation — raw striding
    # aliases (a 3 px shift decimated by 2 lands on opposite sample phases
    # and the coarse SAD matches noise, measured as sign-flipped flow)
    pyr = [(a, b)]
    for _ in range(levels - 1):
        pa, pb = pyr[-1]
        pyr.append((gaussian_blur(pa, 1.0)[::2, ::2], gaussian_blur(pb, 1.0)[::2, ::2]))
    flows = None
    dev = a.device
    for lvl in range(levels - 1, -1, -1):
        al, bl = pyr[lvl]
        H, W = al.shape
        nby, nbx = max(H // block, 1), max(W // block, 1)
        Hc, Wc = nby * block, nbx * block
        al = al[:Hc, :Wc]
        bl = bl[:Hc, :Wc]
        if flows is None:
            init = torch.zeros((2, nby, nbx), dtype=torch.float32, device=dev)
        else:
            # upsample the coarser flow (in this level's pixel units);
            # edge-pad when the finer block grid is more than 2x the
            # coarser one (odd sizes)
            def up(f):
                f = (f * 2.0).repeat_interleave(2, 0).repeat_interleave(2, 1)
                f = F.pad(
                    f[None, None],
                    (0, max(nbx - f.shape[1], 0), 0, max(nby - f.shape[0], 0)),
                    mode="replicate",
                )[0, 0]
                return f[:nby, :nbx]

            init = torch.stack([up(flows[0]), up(flows[1])])
        init_px = init.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :Hc, :Wc].to(torch.int64)
        pad = search + int(max(1, float(init_px.abs().max()) if flows is not None else 1))
        b_pad = F.pad(bl[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
        ys = torch.arange(Hc, device=dev)[:, None]
        xs = torch.arange(Wc, device=dev)[None, :]
        best_sad = torch.full((nby, nbx), float("inf"), device=dev)
        best_y = torch.zeros((nby, nbx), device=dev)
        best_x = torch.zeros((nby, nbx), device=dev)
        for dy in range(-search, search + 1):
            for dx in range(-search, search + 1):
                yy = (ys + init_px[0] + dy + pad).clamp(0, Hc + 2 * pad - 1)
                xx = (xs + init_px[1] + dx + pad).clamp(0, Wc + 2 * pad - 1)
                diff = (al - b_pad[yy, xx]).abs()
                sad = diff.reshape(nby, block, nbx, block).sum(dim=(1, 3))
                better = sad < best_sad
                best_sad = torch.where(better, sad, best_sad)
                best_y = torch.where(better, init[0] + dy, best_y)
                best_x = torch.where(better, init[1] + dx, best_x)
        flows = (best_y, best_x)
    return flows


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the two middle ones averaged for an even
    count (`jnp.median`)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def block_flow_displacement(
    a: torch.Tensor, b: torch.Tensor, block: int = 16, search: int = 4,
    levels: int = 2,
) -> torch.Tensor:
    """Flow score: MEDIAN over cells of the displacement magnitude
    (estimateFlow's median over motionByCell, .cpp:1161-1190)."""
    dy, dx = block_flow_field(a, b, block=block, search=search, levels=levels)
    return _median(torch.sqrt(dy * dy + dx * dx))


def select_keyframes_regular(n_frames: int, step: int) -> np.ndarray:
    """Fixed-stride selection (KeyframeSelector regular mode)."""
    return np.arange(0, n_frames, step)


def _subsequence_limits(flow_scores, step):
    limits = [0]
    acc = 0.0
    n = len(flow_scores)
    for i in range(1, n - 1):
        acc += flow_scores[i] if flow_scores[i] > -1.0 else 0.0
        if acc >= step:
            limits.append(i)
            acc = 0.0
    limits.append(n - 1)
    return limits


def select_keyframes_smart(
    frames: list,
    px_displacement: float = 10.0,
    min_out_frames: int = 1,
    max_out_frames: int | None = None,
    sharpness_window: int = 200,
    flow_cell: int = 16,
    # legacy knobs: sharp_window maps onto sharpness_window and
    # motion_threshold onto the accumulation step; min_gap/max_gap have NO
    # counterpart in the reference's smart selection and are IGNORED with a
    # DeprecationWarning (KeyframeSelector.cpp:195-340 paces subsequences
    # purely by accumulated motion).
    min_gap: int | None = None,
    max_gap: int | None = None,
    motion_threshold: float | None = None,
    sharp_window: int | None = None,
    device="cuda",
) -> np.ndarray:
    """Smart selection with the reference's exact structure
    (KeyframeSelector.cpp:195-340): motion-accumulated subsequence limits
    with +-0.5 step adaptation toward [minOutFrames, maxOutFrames], then
    the center-weighted sharpest frame per subsequence. `frames` are host
    (H, W) arrays; the scores run on `device`."""
    import warnings

    if min_gap is not None or max_gap is not None:
        warnings.warn(
            "min_gap/max_gap are not part of the reference smart selection "
            "and are ignored; pace subsequences with px_displacement / "
            "motion_threshold instead",
            DeprecationWarning,
            stacklevel=2,
        )
    if sharp_window is not None:
        sharpness_window = sharp_window
    n = len(frames)
    if n == 0:
        return np.zeros(0, np.int64)
    if n == 1:
        return np.zeros(1, np.int64)
    dev = resolve_device(device)
    H, W = np.asarray(frames[0]).shape
    if max_out_frames is None:
        max_out_frames = n
    imgs = [torch.tensor(np.asarray(f, np.float32), device=dev) for f in frames]
    sharp = np.array([float(sharpness_score(f, sharpness_window)) for f in imgs])
    flow = np.full(n, -1.0)
    for i in range(1, n):
        flow[i] = float(block_flow_displacement(imgs[i], imgs[i - 1], block=flow_cell))
    if motion_threshold is not None:  # legacy parametrization: direct step
        step = float(motion_threshold)
    else:
        step = px_displacement * min(W, H) / 100.0

    limits = _subsequence_limits(flow, step)
    n_key = len(limits) - 1
    if not (min_out_frames <= n_key <= max_out_frames):
        diff = 0.5
        if n_key < min_out_frames:
            while len(limits) - 1 < min_out_frames and step > 0.0:
                step = max(0.0, step - diff)
                if step == 0.0:
                    stride = n // min_out_frames + 1
                    limits = [0] + list(range(1, n - 1, stride)) + [n - 1]
                    break
                limits = _subsequence_limits(flow, step)
        else:
            while len(limits) - 1 > max_out_frames:
                step += diff
                limits = _subsequence_limits(flow, step)

    selected = []
    for i in range(1, len(limits)):
        lo, hi = limits[i - 1], limits[i]
        idx = np.arange(lo, hi)
        if len(idx) == 0:
            idx = np.array([lo])
        j = idx[int(np.argmax(sharp[idx] * _center_weights(len(idx))))]
        selected.append(int(j))
    return np.array(sorted(set(selected)), np.int64)


def _center_weights(size: int) -> np.ndarray:
    """The reference's deque-built center weights (KeyframeSelector.cpp
    smart selection): 2.0 at the middle frame (odd size) or at BOTH middle
    frames (even size), stepping outward by 2/(size-1) — so even sizes get
    endpoints 1 + 1/(size-1), odd sizes exactly 1.0."""
    if size <= 1:
        return np.full(max(size, 1), 2.0)
    pos = np.arange(size, dtype=np.float64)
    if size % 2:
        dist = np.abs(pos - (size - 1) / 2.0)
    else:
        dist = np.where(pos < size / 2, size / 2 - 1 - pos, pos - size / 2)
    return 2.0 - dist * (2.0 / (size - 1))
