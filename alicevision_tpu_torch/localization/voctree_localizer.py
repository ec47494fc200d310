"""Retrieval-based localization + rig localization.

Port of `alicevision_tpu/localization/voctree_localizer.py`, the
counterpart of the reference's VoctreeLocalizer (ref:
src/aliceVision/localization/VoctreeLocalizer.hpp:34-153: vocabulary tree
retrieval of similar database views, 2D-3D matching against the landmarks
those views observe, P3P AC-RANSAC, pose refine) and of rig resection
(ref: localization/rigResection.cpp: non-central PnP over the rig's
cameras with known sub-poses).

Retrieval is one bag-of-words quantization and one tf-idf product on the
device; the 2D-3D matching is a brute-force product restricted to the
retrieved views' observations; the rig resection makes frame-pose
hypotheses with per-camera P3P and scores them over all cameras'
correspondences (consensus across the rig replaces OpenGV's GP3P minimal
solver), then a 6-parameter Gauss-Newton polishes the frame pose on the
inliers, its Jacobian by `torch.func.jacfwd` where the reference takes
`jax.linearize` columns.

Random draws come from `torch.Generator`s (the tree's k-means seeds, the
RANSAC samples); `tree=` and `idx=` pass the reference's instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.rotations import so3_exp
from ..matching.voctree import VocTree, VocTreeDatabase, bow_vector, build_database, build_voctree
from ..numeric import f32_matmuls
from .localizer import LocalizationResult, _f32, match_ratio, resect_padded


class VoctreeLocalizer:
    """Scene database: a vocabulary tree over the landmark observations'
    descriptors + a per-view inverted index of (landmark, descriptor)."""

    def __init__(
        self,
        points: np.ndarray,  # (L, 3)
        obs_landmark: np.ndarray,  # (O,)
        obs_view: np.ndarray,  # (O,)
        obs_desc: np.ndarray,  # (O, D) descriptor of each observation
        branching: int = 8,
        depth: int = 2,
        seed: int = 0,
        max_train: int = 20000,
        tree: VocTree | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.points = np.asarray(points)
        self.obs_landmark = np.asarray(obs_landmark)
        self.obs_view = np.asarray(obs_view)
        self.obs_desc = np.asarray(obs_desc, np.float32)
        self.view_ids = np.unique(self.obs_view)
        if tree is None:
            train = self.obs_desc
            if len(train) > max_train:
                train = train[np.random.RandomState(seed).choice(len(train), max_train, replace=False)]
            gen = torch.Generator(device=self.device).manual_seed(seed)
            tree = build_voctree(gen, _f32(train, self.device), n_children=branching, n_levels=depth)
        self.tree: VocTree = tree
        self._desc_dev = _f32(self.obs_desc, self.device)
        bows = []
        self._view_obs = {}
        for v in self.view_ids:
            rows = np.nonzero(self.obs_view == v)[0]
            self._view_obs[int(v)] = rows
            d = self._desc_dev[torch.from_numpy(rows).to(self.device)]
            bows.append(bow_vector(self.tree, d, torch.ones(len(rows), dtype=torch.bool, device=self.device)))
        self.db: VocTreeDatabase = build_database(self.tree, torch.stack(bows))

    @f32_matmuls
    def retrieve(self, query_desc: np.ndarray, top_k: int = 4) -> np.ndarray:
        """Most similar database views for a query image (view ids)."""
        bow = bow_vector(self.tree, _f32(query_desc, self.device),
                         torch.ones(len(query_desc), dtype=torch.bool, device=self.device))
        v = bow / torch.sum(bow).clamp(min=1.0) * self.db.idf
        v = v / torch.linalg.norm(v).clamp(min=1e-12)
        sim = self.db.tfidf @ v
        k = min(top_k, len(self.view_ids))
        return self.view_ids[torch.topk(sim, k).indices.cpu().numpy()]

    def correspondences(self, query_desc, query_norm, views, ratio: float = 0.85):
        """2D-3D correspondences of a query against the observations of
        `views`: (world (M, 3), obs (M, 2), ratio matches before the
        landmark de-duplication)."""
        rows = np.concatenate([self._view_obs[int(v)] for v in views])
        idx2 = match_ratio(query_desc, self.obs_desc[rows], ratio, self.device)
        sel = np.nonzero(idx2 >= 0)[0]
        # several query features may hit observations of one landmark:
        # keep one (query, landmark) pair each
        lm = self.obs_landmark[rows][idx2[sel]]
        _, first = np.unique(np.stack([sel, lm]), axis=1, return_index=True)
        keep = np.unique(first)
        return self.points[lm[keep]], np.asarray(query_norm)[sel[keep]], len(sel)

    def localize(
        self,
        generator: torch.Generator | None,
        query_desc: np.ndarray,
        query_norm: np.ndarray,  # (N, 2) undistorted normalized coords
        focal_px: float,
        im_size: tuple,
        top_k: int = 4,
        ratio: float = 0.85,
        min_inliers: int = 12,
        n_hyps: int = 256,
        max_error_px: float = 4.0,
        idx=None,
        seconds: dict | None = None,
    ) -> LocalizationResult:
        """Retrieve, match, resect. idx (n_hyps, 3): RANSAC samples to use
        instead of drawing them. `seconds`, when given, accumulates the
        time of each step ("retrieval", "matching", "resection")."""
        clock = _Clock(seconds, self.device)
        views = self.retrieve(query_desc, top_k)
        clock.lap("retrieval")
        world, obs, n_matched = self.correspondences(query_desc, query_norm, views, ratio)
        clock.lap("matching")
        if n_matched < min_inliers:
            return LocalizationResult(np.eye(3), np.zeros(3), 0, False)
        R, t, ni = resect_padded(generator, world, obs, focal_px, im_size, n_hyps, max_error_px, idx=idx,
                                 device=self.device)
        clock.lap("resection")
        if ni < min_inliers:
            return LocalizationResult(np.eye(3), np.zeros(3), ni, False)
        return LocalizationResult(R, -R.T @ t, ni, True)


class _Clock:
    """Accumulates the seconds between laps into a dict (a no-op without
    one), synchronizing a CUDA device first."""

    def __init__(self, seconds: dict | None, device):
        import time

        self._time, self.seconds, self.device = time.perf_counter, seconds, torch.device(device)
        self.t0 = self._time()

    def lap(self, name: str):
        if self.seconds is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = self._time()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.t0
        self.t0 = now


class RigLocalizationResult(NamedTuple):
    R_frame: np.ndarray  # (3, 3) world->frame
    c_frame: np.ndarray  # (3,)
    n_inliers: int
    success: bool


def _frame_from_view(R_v, c_v, R_s, t_s):
    """Invert the rig chain: R_f = R_sᵀ R_v, c_f = c_v + R_fᵀ R_sᵀ t_s."""
    R_f = R_s.T @ R_v
    return R_f, c_v + R_f.T @ (R_s.T @ t_s)


def _rig_residuals(params, R0, c0, world, obs, sub_R, sub_t, sub_idx, valid):
    """Reprojection residuals of all rig correspondences at the frame pose
    exp(params[:3]) R0, c0 + params[3:], normalized-plane units; and the
    depths."""
    R_f = so3_exp(params[:3][None])[0] @ R0
    c_f = c0 + params[3:]
    xf = (world - c_f) @ R_f.T
    xc = (sub_R[sub_idx] @ xf[..., None])[..., 0] + sub_t[sub_idx]
    z = torch.where(torch.abs(xc[:, 2]) < 1e-9, torch.full_like(xc[:, 2], 1e-9), xc[:, 2])
    return (xc[:, :2] / z[:, None] - obs) * valid[:, None], z


@f32_matmuls
def rig_resection(
    generator: torch.Generator | None,
    world_per_cam: list,  # [(N_k, 3)] 3D matches of camera k
    obs_per_cam: list,  # [(N_k, 2)] normalized undistorted obs
    sub_R: np.ndarray,  # (S, 3, 3) known rig sub-poses
    sub_t: np.ndarray,  # (S, 3)
    focal_px: float,
    im_size: tuple,
    min_inliers: int = 12,
    n_hyps: int = 256,
    max_error_px: float = 4.0,
    gn_iters: int = 10,
    idx_per_cam: list | None = None,
    device="cuda",
) -> RigLocalizationResult:
    """Localize the rig frame from per-camera 2D-3D correspondences with
    known sub-poses (rigResection.cpp analog; consensus over the whole rig
    replaces the non-central GP3P minimal solver). idx_per_cam[k]
    (n_hyps // S, 3): camera k's RANSAC samples, instead of drawing them."""
    dev = resolve_device(device)
    S = len(world_per_cam)
    sub_R = np.asarray(sub_R)
    sub_t = np.asarray(sub_t)
    world = np.concatenate([np.asarray(w) for w in world_per_cam])
    obs = np.concatenate([np.asarray(o) for o in obs_per_cam])
    sub_idx = np.concatenate([np.full(len(world_per_cam[k]), k) for k in range(S)])
    n = len(world)
    if n < min_inliers:
        return RigLocalizationResult(np.eye(3), np.zeros(3), 0, False)
    thr = max_error_px / focal_px

    # frame-pose hypotheses from per-camera robust P3P
    cands = []
    for k in range(S):
        wk, ok = np.asarray(world_per_cam[k]), np.asarray(obs_per_cam[k])
        if len(wk) < 4:
            continue
        R_v, t_v, ni = resect_padded(generator, wk, ok, focal_px, im_size, n_hyps // max(S, 1), max_error_px,
                                     idx=None if idx_per_cam is None else idx_per_cam[k], device=dev)
        if ni >= 4:
            cands.append(_frame_from_view(R_v, -R_v.T @ t_v, sub_R[k], sub_t[k]))
    if not cands:
        return RigLocalizationResult(np.eye(3), np.zeros(3), 0, False)

    # score every frame candidate over all cameras' correspondences
    w_t, o_t = _f32(world, dev), _f32(obs, dev)
    si = torch.from_numpy(sub_idx).to(dev)
    sR, st = _f32(sub_R, dev), _f32(sub_t, dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    zero6 = torch.zeros(6, dtype=torch.float32, device=dev)

    def inliers(R_f, c_f):
        r, z = _rig_residuals(zero6, _f32(R_f, dev), _f32(c_f, dev), w_t, o_t, sR, st, si, ones)
        return ((torch.linalg.norm(r, dim=-1) < thr) & (z > 0)).cpu().numpy()

    best = None
    for R_f, c_f in cands:
        inl = inliers(R_f, c_f)
        if best is None or inl.sum() > best[0]:
            best = (int(inl.sum()), R_f, c_f, inl)
    ni, R_f, c_f, inl = best
    if ni < min_inliers:
        return RigLocalizationResult(np.eye(3), np.zeros(3), ni, False)

    # Gauss-Newton polish of the 6-dof frame pose on the inliers
    vmask = _f32(inl, dev)
    R0, c0 = _f32(R_f, dev), _f32(c_f, dev)

    def res_fn(p):
        return _rig_residuals(p, R0, c0, w_t, o_t, sR, st, si, vmask)[0].reshape(-1)

    p = zero6
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    for _ in range(gn_iters):
        r = res_fn(p)
        J = torch.func.jacfwd(res_fn)(p)  # (2n, 6)
        step = -torch.linalg.solve(J.T @ J + 1e-9 * eye6, J.T @ r)
        p_new = p + step
        if float(torch.sum(res_fn(p_new) ** 2)) < float(torch.sum(r * r)):
            p = p_new
    R_out = so3_exp(p[:3][None])[0].cpu().numpy() @ np.asarray(R_f)
    c_out = np.asarray(c_f) + p[3:].cpu().numpy()
    # inliers at the polished pose
    return RigLocalizationResult(R_out, c_out, int(inliers(R_out, c_out).sum()), True)
