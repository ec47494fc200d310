"""Synthetic multi-view ground-truth scenes for tests and benchmarks.

Port of `alicevision_tpu/utils/synthetic.py` (ref:
src/aliceVision/multiview/NViewDataSet.hpp:21-74, the NRealisticCamerasRing
fixture). Cameras sit on a ring looking at the origin; points are sampled
in a ball; projections are exact (optionally noised).

The random draws come from a `torch.Generator` seeded with `seed`, on the
CPU, so a scene is the same on every device. They differ from the JAX
package's `jax.random` draws: to reproduce one of its scenes, pass its
`points` (and `noise`) arrays in.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import camera as cam
from .. import geometry as geo
from ..device import resolve_device


class SyntheticScene(NamedTuple):
    poses: geo.Pose  # batched (n_views,)
    intrinsics: cam.Intrinsics  # single shared row (unbatched)
    points: torch.Tensor  # (n_points, 3) world
    observations: torch.Tensor  # (n_views, n_points, 2) pixels
    visible: torch.Tensor  # (n_views, n_points) bool (in front + in image)


def _ball(gen: torch.Generator, n: int) -> torch.Tensor:
    """n points uniform in the unit ball (a normal direction, radius U^(1/3))."""
    d = torch.randn((n, 3), generator=gen)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    return d * torch.rand((n, 1), generator=gen) ** (1.0 / 3.0)


def ring_scene(
    n_views: int = 12,
    n_points: int = 200,
    radius: float = 5.0,
    image_size=(1920, 1080),
    focal_px: float = 1200.0,
    noise_px: float = 0.0,
    disto_kind: int = cam.DISTO_NONE,
    disto_params=(),
    seed: int = 0,
    point_extent: float = 1.5,
    points=None,
    noise=None,
    device="cuda",
) -> SyntheticScene:
    """Cameras on a ring of given radius in the z=0 plane, looking at the
    origin. `points` (n_points, 3) and `noise` (n_views, n_points, 2, in
    units of noise_px) replace the generator's draws when given."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    drawn_points = point_extent * _ball(gen, n_points)
    drawn_noise = torch.randn((n_views, n_points, 2), generator=gen)
    points = drawn_points if points is None else torch.as_tensor(points, dtype=torch.float32)
    noise = drawn_noise if noise is None else torch.as_tensor(noise, dtype=torch.float32)
    points = points.to(dev)

    angles = torch.arange(n_views, dtype=torch.float32, device=dev) * (2.0 * math.pi / n_views)
    centers = radius * torch.stack(
        [torch.cos(angles), torch.sin(angles), torch.zeros_like(angles)], dim=-1
    )

    # Look-at rotation: camera z axis points from center to origin.
    fwd = -centers / torch.linalg.norm(centers, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(fwd.shape)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right, dim=-1)
    # Rows of R are the camera axes expressed in world coords (world->cam).
    R = torch.stack([right, down, fwd], dim=-2)
    poses = geo.pose_from_Rc(R, centers)

    intr = cam.make_intrinsics(
        image_size[0], image_size[1], focal_px,
        disto_kind=disto_kind, disto_params=disto_params, device=dev,
    )
    x_cam = geo.transform(
        geo.Pose(q=poses.q[:, None, :], c=poses.c[:, None, :]), points[None, :, :]
    )  # (V, P, 3)
    obs = cam.project_cam(intr, x_cam)
    if noise_px > 0:
        obs = obs + noise_px * noise.to(dev)

    w, h = image_size
    visible = (
        (x_cam[..., 2] > 0.1)
        & (obs[..., 0] >= 0)
        & (obs[..., 0] < w)
        & (obs[..., 1] >= 0)
        & (obs[..., 1] < h)
    )
    return SyntheticScene(poses=poses, intrinsics=intr, points=points, observations=obs, visible=visible)


def normalized_obs(scene: SyntheticScene) -> torch.Tensor:
    """Observations lifted to the (undistorted) normalized camera plane."""
    p = cam.ima2cam(scene.intrinsics, scene.observations)
    return cam.remove_distortion(scene.intrinsics.disto_kind, scene.intrinsics.disto, p)


def ring_scene_sfmdata(
    n_views: int = 10,
    n_points: int = 100,
    image_size=(1920, 1080),
    focal_px: float = 1200.0,
    noise_px: float = 0.0,
    seed: int = 0,
    points=None,
    noise=None,
    device="cuda",
):
    """Synthetic ring scene as a full SfMData, the generateSampleScene
    fixture (ref: sfmDataIO/sceneSample.hpp:18 generateSampleScene).
    `points` and `noise` replace the generator's draws as in `ring_scene`."""
    import numpy as np

    from ..sfmdata.scene import SfMData

    syn = ring_scene(
        n_views=n_views, n_points=n_points, image_size=image_size, focal_px=focal_px,
        noise_px=noise_px, seed=seed, points=points, noise=noise, device=device,
    )
    sc = SfMData.empty()
    w, h = image_size
    ii = sc.add_intrinsic(1000, w, h, focal_px)
    R = geo.quat_to_mat(syn.poses.q).cpu().numpy().astype(np.float64)
    c = syn.poses.c.cpu().numpy().astype(np.float64)
    for v in range(n_views):
        vi = sc.add_view(100 + v, ii, w, h, path=f"view_{v:04d}.jpg", frame_id=v)
        sc.set_pose(vi, R[v], c[v])
    vis = syn.visible.cpu().numpy()
    obs = syn.observations.cpu().numpy()
    vv, ll = np.nonzero(vis)
    sc.set_structure(syn.points.cpu().numpy().astype(np.float64), ll.astype(np.int32), vv.astype(np.int32),
                     obs[vv, ll])
    return sc
