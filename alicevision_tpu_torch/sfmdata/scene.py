"""SfMData — the central scene model, as struct-of-arrays.

Host copy of `alicevision_tpu/sfmdata/scene.py`: flat aligned numpy arrays
plus id<->index tables (views index into an intrinsics table and a pose
table; landmarks are (L, 3) points; observations are one flat SoA block).
The compute path pulls torch tensors of the arrays (`intrinsics_table`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import camera as cam

INVALID = -1


@dataclasses.dataclass
class SfMData:
    # --- views -----------------------------------------------------------
    view_ids: np.ndarray  # (V,) int64 — external ids (stable across IO)
    view_intrinsic: np.ndarray  # (V,) int32 index into intrinsics table
    view_pose: np.ndarray  # (V,) int32 index into pose table, INVALID if none
    view_sizes: np.ndarray  # (V, 2) int32 (w, h)
    view_paths: list  # list[str]
    view_frames: np.ndarray  # (V,) int64 frame ids
    view_metadata: list  # list[dict]

    # --- intrinsics ------------------------------------------------------
    intrinsic_ids: np.ndarray  # (I,) int64
    cam_kind: np.ndarray  # (I,) int32
    disto_kind: np.ndarray  # (I,) int32
    scale: np.ndarray  # (I, 2) f64 — fx, fy px
    offset: np.ndarray  # (I, 2) f64 — principal point offset from center
    sizes: np.ndarray  # (I, 2) int32
    disto: np.ndarray  # (I, DISTO_PARAMS) f64
    sensor_size: np.ndarray  # (I, 2) f64 mm — for focal mm round-trip
    intrinsic_extra: list  # list[dict] — serial, locks, etc. for round-trip

    # --- poses -----------------------------------------------------------
    pose_ids: np.ndarray  # (P,) int64
    pose_R: np.ndarray  # (P, 3, 3) f64 world->cam
    pose_c: np.ndarray  # (P, 3) f64 centers
    pose_locked: np.ndarray  # (P,) bool

    # --- landmarks -------------------------------------------------------
    landmark_ids: np.ndarray  # (L,) int64
    points: np.ndarray  # (L, 3) f64
    colors: np.ndarray  # (L, 3) uint8
    desc_types: list  # list[str]

    # --- observations (flat SoA) ----------------------------------------
    obs_landmark: np.ndarray  # (O,) int32 index into landmarks
    obs_view: np.ndarray  # (O,) int32 index into views
    obs_uv: np.ndarray  # (O, 2) f64 pixels
    obs_scale: np.ndarray  # (O,) f64
    obs_feature: np.ndarray  # (O,) int64

    # --- scene-model constraints (panorama/nodal pipelines) --------------
    #   constraints2d: {"view_i", "uv_i" (2,), "view_j", "uv_j" (2,)}
    #   rotation_priors: {"view_i", "view_j", "R_j_i" (3,3) — second_R_first}
    constraints2d: list = dataclasses.field(default_factory=list)
    rotation_priors: list = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    @staticmethod
    def empty() -> "SfMData":
        z = lambda *s: np.zeros(s)  # noqa: E731
        zi = lambda *s: np.zeros(s, np.int64)  # noqa: E731
        return SfMData(
            view_ids=zi(0),
            view_intrinsic=np.zeros(0, np.int32),
            view_pose=np.zeros(0, np.int32),
            view_sizes=np.zeros((0, 2), np.int32),
            view_paths=[],
            view_frames=zi(0),
            view_metadata=[],
            intrinsic_ids=zi(0),
            cam_kind=np.zeros(0, np.int32),
            disto_kind=np.zeros(0, np.int32),
            scale=z(0, 2),
            offset=z(0, 2),
            sizes=np.zeros((0, 2), np.int32),
            disto=z(0, cam.DISTO_PARAMS),
            sensor_size=z(0, 2),
            intrinsic_extra=[],
            pose_ids=zi(0),
            pose_R=z(0, 3, 3),
            pose_c=z(0, 3),
            pose_locked=np.zeros(0, bool),
            landmark_ids=zi(0),
            points=z(0, 3),
            colors=np.zeros((0, 3), np.uint8),
            desc_types=[],
            obs_landmark=np.zeros(0, np.int32),
            obs_view=np.zeros(0, np.int32),
            obs_uv=z(0, 2),
            obs_scale=z(0),
            obs_feature=zi(0),
        )

    # --- counts ----------------------------------------------------------
    @property
    def n_views(self) -> int:
        return len(self.view_ids)

    @property
    def n_intrinsics(self) -> int:
        return len(self.intrinsic_ids)

    @property
    def n_poses(self) -> int:
        return len(self.pose_ids)

    @property
    def n_landmarks(self) -> int:
        return len(self.landmark_ids)

    @property
    def n_observations(self) -> int:
        return len(self.obs_landmark)

    # --- accessors -------------------------------------------------------
    def valid_views(self) -> np.ndarray:
        """Indices of views with a pose and an intrinsic
        (ref: SfMData::getValidViews, SfMData.hpp:119)."""
        return np.nonzero(
            (self.view_pose != INVALID) & (self.view_intrinsic != INVALID)
        )[0]

    def camera_matrices(self, view_idx: int):
        """(K, R, c) for one posed view, float64 numpy (ref:
        mvsUtils/MultiViewParams.hpp:86 per-camera P/K/R/C tables)."""
        ii = int(self.view_intrinsic[view_idx])
        p = int(self.view_pose[view_idx])
        fx, fy = self.scale[ii]
        pp = self.offset[ii] + 0.5 * self.sizes[ii]
        K = np.array([[fx, 0.0, pp[0]], [0.0, fy, pp[1]], [0.0, 0.0, 1.0]])
        return K, self.pose_R[p], self.pose_c[p]

    def intrinsics_table(self, dtype=torch.float32, device="cpu") -> cam.Intrinsics:
        """Batched torch Intrinsics for the compute path."""

        def t(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        return cam.Intrinsics(
            cam_kind=t(self.cam_kind, torch.int32),
            disto_kind=t(self.disto_kind, torch.int32),
            scale=t(self.scale, dtype),
            offset=t(self.offset, dtype),
            size=t(self.sizes, dtype),
            disto=t(self.disto, dtype),
        )

    # --- mutation helpers (host-side scene building) ---------------------
    def add_intrinsic(
        self,
        intrinsic_id: int,
        w: int,
        h: int,
        focal_px: float,
        cam_kind: int = cam.CAM_PINHOLE,
        disto_kind: int = cam.DISTO_NONE,
        disto_params=(),
        offset=(0.0, 0.0),
        sensor_mm=(36.0, 24.0),
        focal_y_px: Optional[float] = None,
    ) -> int:
        d = np.zeros(cam.DISTO_PARAMS)
        d[: len(disto_params)] = disto_params
        self.intrinsic_ids = np.append(self.intrinsic_ids, intrinsic_id)
        self.cam_kind = np.append(self.cam_kind, np.int32(cam_kind))
        self.disto_kind = np.append(self.disto_kind, np.int32(disto_kind))
        self.scale = np.vstack([self.scale, [focal_px, focal_y_px or focal_px]])
        self.offset = np.vstack([self.offset, list(offset)])
        self.sizes = np.vstack([self.sizes, [w, h]]).astype(np.int32)
        self.disto = np.vstack([self.disto, d])
        self.sensor_size = np.vstack([self.sensor_size, list(sensor_mm)])
        self.intrinsic_extra.append({})
        return self.n_intrinsics - 1

    def add_view(
        self,
        view_id: int,
        intrinsic_idx: int,
        w: int,
        h: int,
        path: str = "",
        frame_id: int = 0,
        metadata: Optional[dict] = None,
    ) -> int:
        self.view_ids = np.append(self.view_ids, view_id)
        self.view_intrinsic = np.append(self.view_intrinsic, np.int32(intrinsic_idx))
        self.view_pose = np.append(self.view_pose, np.int32(INVALID))
        self.view_sizes = np.vstack([self.view_sizes, [w, h]]).astype(np.int32)
        self.view_paths.append(path)
        self.view_frames = np.append(self.view_frames, frame_id)
        self.view_metadata.append(metadata or {})
        return self.n_views - 1

    def set_pose(self, view_idx: int, R: np.ndarray, c: np.ndarray, locked=False):
        """Attach/overwrite the pose of a view (pose_id = view_id)."""
        existing = self.view_pose[view_idx]
        if existing != INVALID:
            self.pose_R[existing] = R
            self.pose_c[existing] = c
            self.pose_locked[existing] = locked
            return existing
        self.pose_ids = np.append(self.pose_ids, self.view_ids[view_idx])
        self.pose_R = np.concatenate([self.pose_R, R[None]], axis=0)
        self.pose_c = np.vstack([self.pose_c, c])
        self.pose_locked = np.append(self.pose_locked, locked)
        self.view_pose[view_idx] = self.n_poses - 1
        return self.n_poses - 1

    def set_structure(
        self,
        points: np.ndarray,
        obs_landmark: np.ndarray,
        obs_view: np.ndarray,
        obs_uv: np.ndarray,
        obs_scale: Optional[np.ndarray] = None,
        obs_feature: Optional[np.ndarray] = None,
        colors: Optional[np.ndarray] = None,
        landmark_ids: Optional[np.ndarray] = None,
        desc_type: str = "sift",
    ):
        L = len(points)
        O = len(obs_landmark)  # noqa: E741
        self.points = np.asarray(points, np.float64)
        self.landmark_ids = (
            np.arange(L, dtype=np.int64) if landmark_ids is None else landmark_ids
        )
        self.colors = np.full((L, 3), 255, np.uint8) if colors is None else colors
        self.desc_types = [desc_type] * L
        self.obs_landmark = np.asarray(obs_landmark, np.int32)
        self.obs_view = np.asarray(obs_view, np.int32)
        self.obs_uv = np.asarray(obs_uv, np.float64)
        self.obs_scale = (
            np.zeros(O) if obs_scale is None else np.asarray(obs_scale, np.float64)
        )
        self.obs_feature = (
            np.arange(O, dtype=np.int64) if obs_feature is None else obs_feature
        )
