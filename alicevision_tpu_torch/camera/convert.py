"""Distortion model conversion and undistortion-map export.

Port of `alicevision_tpu/camera/convert.py` (ref:
src/software/convert/main_convertDistortion.cpp — refit one distortion
model with another by sampling the image domain;
src/software/export/main_exportDistortion.cpp — undistortion STMaps).

The refit is a Gauss-Newton on a dense grid of normalized points on the
intrinsic row's device: residuals and Jacobian (`torch.func.jacfwd`) in
float32 as the reference computes them, the small normal equations solved
in float64 (`numeric.solve64`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..numeric import solve64
from . import models as m

# the parameters a target model fits, the rest stay 0
_N_ACTIVE = {m.DISTO_RADIALK1: 1, m.DISTO_RADIALK3: 3, m.DISTO_BROWN: 5, m.DISTO_FISHEYE: 4, m.DISTO_FISHEYE1: 1,
             m.DISTO_NONE: 0}


def _sample_grid(intr_row, n: int = 24) -> torch.Tensor:
    """Normalized-plane samples covering the image domain."""
    w, h = float(intr_row.size[0]), float(intr_row.size[1])
    dev = intr_row.size.device
    xs = torch.linspace(0.0, w, n, device=dev)
    ys = torch.linspace(0.0, h, n, device=dev)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    return m.ima2cam(intr_row, torch.stack([gx, gy], -1).reshape(-1, 2))


def fit_distortion(intr_row, target_kind: int, iters: int = 20, n_grid: int = 24) -> np.ndarray:
    """Fit `target_kind` distortion parameters reproducing the source
    intrinsic's distortion field over the image domain, on the row's
    device. Returns the new parameter row (DISTO_PARAMS,)."""
    n_active = _N_ACTIVE.get(int(target_kind), m.DISTO_PARAMS)
    if n_active == 0:
        return np.zeros(m.DISTO_PARAMS)
    dev = intr_row.size.device
    # undistorted normalized grid -> distorted by the SOURCE model
    p_und = m.remove_distortion(intr_row.disto_kind, intr_row.disto, _sample_grid(intr_row, n_grid))
    target = m.add_distortion(intr_row.disto_kind, intr_row.disto, p_und)
    kind = torch.tensor(int(target_kind), dtype=torch.int32, device=dev)

    def residuals(params):
        return (m.add_distortion(kind, params, p_und) - target).reshape(-1)

    params = torch.zeros(m.DISTO_PARAMS, dtype=torch.float32, device=dev)
    mask = (torch.arange(m.DISTO_PARAMS, device=dev) < n_active).to(torch.float32)
    eye = torch.eye(m.DISTO_PARAMS, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = residuals(params)
        J = torch.func.jacfwd(residuals)(params) * mask[None, :]
        step = solve64(J.T @ J + 1e-9 * eye, (J.T @ r)[:, None])[:, 0]
        params = params - step * mask
    return params.cpu().numpy()


def convert_intrinsic_distortion(scene, intrinsic_idx: int, target_kind: int, device="cuda"):
    """In-place conversion of one intrinsic's distortion model, fitted on
    `device`."""
    row = scene.intrinsics_table(device=resolve_device(device)).row(intrinsic_idx)
    params = fit_distortion(row, target_kind)
    scene.disto_kind[intrinsic_idx] = np.int32(target_kind)
    scene.disto[intrinsic_idx] = params
    return params


def _stmap(intr_row, hw, remove: bool) -> np.ndarray:
    if hw is None:
        hw = (int(intr_row.size[1]), int(intr_row.size[0]))
    H, W = hw
    dev = intr_row.size.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5], -1).to(torch.float32)
    p = m.ima2cam(intr_row, pix)
    p = (m.remove_distortion if remove else m.add_distortion)(intr_row.disto_kind, intr_row.disto, p)
    stmap = m.cam2ima(intr_row, p) / torch.tensor([W, H], dtype=torch.float32, device=dev)
    # STMap convention: t axis bottom-up
    stmap = torch.stack([stmap[..., 0], 1.0 - stmap[..., 1]], -1)
    return stmap.cpu().numpy().astype(np.float32)


def undistort_stmap(intr_row, hw=None) -> np.ndarray:
    """(H, W, 2) STMap: for each output (undistorted) pixel, the normalized
    [0,1]^2 source coordinate in the distorted image
    (ref: main_exportDistortion.cpp `--exportSTMaps`)."""
    return _stmap(intr_row, hw, remove=False)


def distort_stmap(intr_row, hw=None) -> np.ndarray:
    """Inverse map: for each distorted pixel, the undistorted source."""
    return _stmap(intr_row, hw, remove=True)
