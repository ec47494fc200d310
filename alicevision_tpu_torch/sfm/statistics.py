"""Reconstruction statistics + HTML report.

Port of `alicevision_tpu/sfm/statistics.py` (ref:
src/aliceVision/sfm/sfmStatistics.cpp — residual/track-length/observation
histograms; sfm/generateReport.cpp + dependencies/htmlDoc — the HTML
summary written by the incremental pipeline). The reprojection residuals
go through the port's camera model on `device`; the rest are host
reductions over the flat observation SoA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..sfmdata import INVALID, SfMData


def reprojection_residuals(scene: SfMData, device="cuda") -> np.ndarray:
    """Per-observation reprojection error in pixels (full camera model),
    in float32 as the reference computes it."""
    from .. import camera as cam
    from ..geometry.rotations import mat_to_quat, quat_rotate

    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    posed = scene.view_pose[scene.obs_view] != INVALID
    ov = scene.obs_view[posed]
    ol = scene.obs_landmark[posed]
    q = mat_to_quat(t(scene.pose_R[scene.view_pose[ov]]))
    x_cam = quat_rotate(q, t(scene.points[ol]) - t(scene.pose_c[scene.view_pose[ov]]))
    intr = scene.intrinsics_table(device=dev)
    idx = torch.as_tensor(scene.view_intrinsic[ov], dtype=torch.int64, device=dev)
    rows = cam.Intrinsics(*(a[idx] for a in intr))
    pix = cam.project_cam(rows, x_cam)
    return torch.linalg.norm(pix - t(scene.obs_uv[posed]), dim=-1).cpu().numpy()


def _track_lengths(scene: SfMData) -> np.ndarray:
    if not scene.n_landmarks:
        return np.zeros(0)
    return np.bincount(scene.obs_landmark, minlength=scene.n_landmarks)


def scene_statistics(scene: SfMData, device="cuda") -> dict:
    """Counts, residual and track-length summaries of a scene."""
    res = reprojection_residuals(scene, device) if scene.n_observations else np.zeros(0)
    track_len = _track_lengths(scene)
    obs_per_view = (
        np.bincount(scene.obs_view, minlength=scene.n_views)
        if scene.n_observations
        else np.zeros(scene.n_views)
    )
    return {
        "n_views": scene.n_views,
        "n_posed": int((scene.view_pose != INVALID).sum()),
        "n_intrinsics": scene.n_intrinsics,
        "n_landmarks": scene.n_landmarks,
        "n_observations": scene.n_observations,
        "residuals_px": {
            "mean": float(res.mean()) if len(res) else 0.0,
            "median": float(np.median(res)) if len(res) else 0.0,
            "p95": float(np.percentile(res, 95)) if len(res) else 0.0,
            "max": float(res.max()) if len(res) else 0.0,
        },
        "track_length": {
            "mean": float(track_len.mean()) if len(track_len) else 0.0,
            "max": int(track_len.max()) if len(track_len) else 0,
        },
        "observations_per_view": {
            "mean": float(obs_per_view.mean()),
            "min": int(obs_per_view.min()) if len(obs_per_view) else 0,
        },
    }


def _histogram_svg(values, bins=30, width=420, height=120, color="#4a7"):
    """Tiny inline SVG histogram (the htmlDoc/vectorGraphics analog)."""
    if len(values) == 0:
        return "<svg/>"
    hist, edges = np.histogram(values, bins=bins)
    m = hist.max() or 1
    bw = width / bins
    bars = []
    for k, h in enumerate(hist):
        bh = height * h / m
        bars.append(
            f'<rect x="{k * bw:.1f}" y="{height - bh:.1f}" width="{bw - 1:.1f}" '
            f'height="{bh:.1f}" fill="{color}"/>'
        )
    return (
        f'<svg width="{width}" height="{height + 18}" xmlns="http://www.w3.org/2000/svg">'
        + "".join(bars)
        + f'<text x="2" y="{height + 14}" font-size="11">'
        f"[{edges[0]:.2f} .. {edges[-1]:.2f}]</text></svg>"
    )


def generate_html_report(scene: SfMData, path: str, title: str = "SfM report", device="cuda") -> dict:
    """Write the reconstruction summary HTML (generateReport.cpp analog)."""
    stats = scene_statistics(scene, device)
    res = reprojection_residuals(scene, device) if scene.n_observations else np.zeros(0)
    rows = "".join(
        f"<tr><td>{k}</td><td>{v}</td></tr>"
        for k, v in [
            ("views", stats["n_views"]),
            ("posed views", stats["n_posed"]),
            ("intrinsics", stats["n_intrinsics"]),
            ("landmarks", stats["n_landmarks"]),
            ("observations", stats["n_observations"]),
            ("mean residual (px)", f"{stats['residuals_px']['mean']:.3f}"),
            ("median residual (px)", f"{stats['residuals_px']['median']:.3f}"),
            ("p95 residual (px)", f"{stats['residuals_px']['p95']:.3f}"),
            ("mean track length", f"{stats['track_length']['mean']:.2f}"),
        ]
    )
    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title>
<style>body{{font-family:sans-serif;margin:2em}}td{{padding:2px 12px}}</style>
</head><body>
<h1>{title}</h1>
<table border="0">{rows}</table>
<h2>Reprojection residuals (px)</h2>{_histogram_svg(res)}
<h2>Track lengths</h2>{_histogram_svg(_track_lengths(scene), color="#47a")}
</body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return stats
