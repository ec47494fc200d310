"""SVG visualisation writers for keypoints / matches / tracks.

A host copy of `alicevision_tpu/utils/svg.py`.
Counterpart of the reference's vectorGraphics helper + export tools
(ref: src/dependencies/vectorGraphics/svgDrawer.hpp, used by
src/software/export/main_exportKeypoints.cpp, main_exportMatches.cpp,
main_exportTracks.cpp). Host-side text emission only.
"""

from __future__ import annotations

import os


def _header(w, h, images=()):
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" '
        f'xmlns:xlink="http://www.w3.org/1999/xlink" width="{w}" height="{h}">'
    ]
    for href, x, y, iw, ih in images:
        parts.append(
            f'<image xlink:href="{href}" x="{x}" y="{y}" '
            f'width="{iw}" height="{ih}"/>'
        )
    return parts


def write_keypoints_svg(path, wh, xy, scale=None, image_path=None, color="yellow"):
    """One circle per keypoint, radius = feature scale (exportKeypoints)."""
    w, h = int(wh[0]), int(wh[1])
    imgs = [(os.path.basename(image_path), 0, 0, w, h)] if image_path else []
    parts = _header(w, h, imgs)
    for k in range(len(xy)):
        r = float(scale[k]) if scale is not None else 2.0
        parts.append(
            f'<circle cx="{float(xy[k][0]):.2f}" cy="{float(xy[k][1]):.2f}" '
            f'r="{max(r, 1.0):.2f}" stroke="{color}" fill="none" stroke-width="1"/>'
        )
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def write_matches_svg(path, wh1, wh2, xy1, xy2, image1=None, image2=None):
    """Side-by-side pair with one line per match (exportMatches)."""
    w1, h1 = int(wh1[0]), int(wh1[1])
    w2, h2 = int(wh2[0]), int(wh2[1])
    imgs = []
    if image1:
        imgs.append((os.path.basename(image1), 0, 0, w1, h1))
    if image2:
        imgs.append((os.path.basename(image2), w1, 0, w2, h2))
    parts = _header(w1 + w2, max(h1, h2), imgs)
    for k in range(len(xy1)):
        x1, y1 = float(xy1[k][0]), float(xy1[k][1])
        x2, y2 = float(xy2[k][0]) + w1, float(xy2[k][1])
        hue = (k * 47) % 360
        parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="hsl({hue},90%,50%)" stroke-width="0.5"/>'
        )
        parts.append(f'<circle cx="{x1:.1f}" cy="{y1:.1f}" r="2" fill="yellow"/>')
        parts.append(f'<circle cx="{x2:.1f}" cy="{y2:.1f}" r="2" fill="yellow"/>')
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))


def write_tracks_svg(path, wh, polylines, image_path=None):
    """Per-track polylines across consecutive views (exportTracks)."""
    w, h = int(wh[0]), int(wh[1])
    imgs = [(os.path.basename(image_path), 0, 0, w, h)] if image_path else []
    parts = _header(w, h, imgs)
    for k, line in enumerate(polylines):
        pts = " ".join(f"{float(x):.1f},{float(y):.1f}" for x, y in line)
        hue = (k * 47) % 360
        parts.append(
            f'<polyline points="{pts}" fill="none" '
            f'stroke="hsl({hue},90%,50%)" stroke-width="1"/>'
        )
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
