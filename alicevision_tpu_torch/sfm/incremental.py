"""Incremental structure-from-motion engine.

Port of `alicevision_tpu/sfm/incremental.py` (ref:
src/aliceVision/sfm/pipeline/sequential/ReconstructionEngine_sequentialSfM.cpp
:174-231 process, :407-520 incremental loop; params .hpp:41-110). The control
flow (which view next, when to BA) and the bookkeeping (track tables,
scores, masks) stay on the host in numpy; every numeric step runs batched
on the engine's device and comes back in one device-to-host copy
(`_to_host`):

  * initial pair: AC-RANSAC essential (5-point) + cheirality on the common
    tracks of all candidate pairs at once (makeInitialPair3D, .hpp:231);
  * resection: robust P3P + Gauss-Newton refit for a whole group of views;
  * triangulation: masked N-view DLT over the (T, K) track table with
    reprojection / angle / depth gates (sfmTriangulation.cpp);
  * bundle adjustment: `sfm.ba.ba_solve` over the full (T, K) problem with
    growing validity masks, and `ba_solve_joint` for the shared
    intrinsics.

Every random draw comes from one `torch.Generator` on the device, seeded
from `config.seed`. The reference's TPU transport (packed single-buffer
fetches, the relay's fixed batch widths and capacity buckets, its BA loop
switch) has no counterpart here: batches are as wide as their data.

Operating point as the reference: BA after every added group, outlier
removal at 4 px, min triangulation angle 3 deg (.hpp:60-99).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import camera as cam
from .. import multiview as mv
from .. import robust
from ..device import resolve_device
from ..geometry.rotations import mat_to_quat, quat_to_mat
from ..tracks.builder import Tracks
from . import ba as ba_mod


@dataclasses.dataclass
class IncrementalConfig:
    max_reproj_px: float = 4.0  # outlier gate (hpp:96 maxReprojectionError)
    min_angle_deg: float = 3.0  # triangulation angle gate (hpp:88)
    min_angle_init_deg: float = 5.0  # initial pair baseline gate (hpp:86)
    # localizerEstimatorError defaults to INFINITY in the reference and
    # lets AC-RANSAC adapt the threshold (.hpp:70)
    resection_max_error_px: float = 1e6
    n_ransac_hyps: int = 256
    group_add: int = 30  # BA group size after warmup (hpp:60)
    ba_max_outliers: int = 50  # re-BA while outliers >= this (hpp:96)
    max_track_obs: int = 16  # K of the triangulation/BA tables
    ba_max_iters: int = 20
    min_track_inliers_resection: int = 12
    min_pts_init: int = 50
    seed: int = 0
    # local BA: above this many posed views, cameras beyond
    # local_ba_distance covisibility hops from the new views are held
    local_ba_min_views: int = 50
    local_ba_distance: int = 1
    # LO-RANSAC per-track triangulation (NViewsTriangulationLORansac.hpp:48)
    robust_triangulation: bool = False
    # pyramid-coverage scoring (computeCandidateImageScore, .cpp:1453-1473)
    pyramid_base: int = 2
    pyramid_depth: int = 5
    # refine the shared intrinsics with the poses (every group early, then
    # whenever the posed-view count doubles)
    refine_intrinsics: bool = True
    # initial pair: the best angle x coverage score of the top-N candidates
    init_pair_candidates: int = 10


class IncrementalResult:
    def __init__(self, n_views):
        self.pose_R = np.zeros((n_views, 3, 3))
        self.pose_c = np.zeros((n_views, 3))
        self.posed = np.zeros(n_views, bool)
        self.points = None  # (T, 3)
        self.point_valid = None  # (T,)
        self.history: list = []


def _to_host(*tensors):
    """The tensors as float64 numpy arrays, through one device-to-host copy
    (bools come back as 0.0 / 1.0)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i : i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


def _host_intrinsics(intr) -> cam.Intrinsics:
    """Numpy copy of an Intrinsics table (tensors or arrays): int32 kinds,
    float32 values, as the device computes them."""
    def host(x, dt):
        return (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(dt)

    return cam.Intrinsics(*(host(x, np.int32 if n.endswith("kind") else np.float32)
                            for n, x in zip(cam.Intrinsics._fields, intr)))


class IncrementalSfM:
    """Drives the reconstruction from tracks + per-view features, computing
    on `device` ("cuda" by default; it raises without a CUDA device unless
    the caller passes "cpu")."""

    def __init__(
        self,
        tracks: Tracks,
        features_xy: dict,
        intr_table: cam.Intrinsics,
        view_intrinsic: np.ndarray,
        image_sizes: np.ndarray,
        config: IncrementalConfig = IncrementalConfig(),
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = config
        self.tracks = tracks
        self.view_intrinsic = np.asarray(view_intrinsic, np.int32)
        self.image_sizes = np.asarray(image_sizes)
        self.intr_np = _host_intrinsics(intr_table)
        self.n_views = len(view_intrinsic)
        self.T = tracks.n_tracks
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        # wall seconds by step (initial pair, resection, triangulation, BA,
        # joint BA, normalization), each ending in its host copy
        self.seconds: dict = {}

        # flat observation SoA + pixel coords
        self.obs_track = np.asarray(tracks.track_ids)
        self.obs_view = np.asarray(tracks.views)
        O = len(self.obs_track)
        self.obs_uv = np.zeros((O, 2), np.float32)
        for v, xy in features_xy.items():
            sel = self.obs_view == v
            self.obs_uv[sel] = np.asarray(xy)[np.asarray(tracks.features)[sel]]

        # undistorted normalized coords per observation (for E / P3P)
        self._recompute_obs_norm()

        # (T, K) table of observation indices: stable sort + group-offset
        # subtraction gives each observation its slot
        K = config.max_track_obs
        order = np.argsort(self.obs_track, kind="stable")
        sorted_t = self.obs_track[order]
        bounds = np.searchsorted(sorted_t, np.arange(self.T + 1))
        slot = np.arange(O) - bounds[sorted_t]
        keep = slot < K
        self.tbl_obs = np.zeros((self.T, K), np.int64)
        self.tbl_mask = np.zeros((self.T, K), bool)
        self.tbl_obs[sorted_t[keep], slot[keep]] = order[keep]
        self.tbl_mask[sorted_t[keep], slot[keep]] = True
        self.tbl_view = np.where(self.tbl_mask, self.obs_view[self.tbl_obs], 0)

        # per-view observation lists: one sort, then split
        vorder = np.argsort(self.obs_view, kind="stable")
        vbounds = np.searchsorted(self.obs_view[vorder], np.arange(self.n_views + 1))
        self.view_obs = [vorder[vbounds[v] : vbounds[v + 1]] for v in range(self.n_views)]

        # per-observation pyramid cell at each level (coverage score): cell
        # = col + width * row on a width x width grid, width = base^(l+1)
        D = config.pyramid_depth
        wh = self.image_sizes[self.obs_view].astype(np.float64)
        self.pyr_cells = np.zeros((O, D), np.int32)
        self.pyr_ncells = np.zeros(D, np.int64)
        for lvl in range(D):
            width = config.pyramid_base ** (lvl + 1)
            cx = np.clip((self.obs_uv[:, 0] * width / wh[:, 0]).astype(np.int64), 0, width - 1)
            cy = np.clip((self.obs_uv[:, 1] * width / wh[:, 1]).astype(np.int64), 0, width - 1)
            self.pyr_cells[:, lvl] = cx + width * cy
            self.pyr_ncells[lvl] = width * width
        self.pyr_weights = 2.0 ** (D - 1 - np.arange(D))

        self.res = IncrementalResult(self.n_views)
        self.res.points = np.zeros((self.T, 3))
        self.res.point_valid = np.zeros(self.T, bool)
        self.obs_inlier = np.ones(O, bool)
        self._im_wh = (float(np.max(self.image_sizes[:, 0])), float(np.max(self.image_sizes[:, 1])))

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _timed(self, step: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[step] = self.seconds.get(step, 0.0) + time.perf_counter() - t0

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _intr_tensors(self) -> cam.Intrinsics:
        return cam.Intrinsics(*(self._tensor(x, torch.int32 if n.endswith("kind") else torch.float32)
                                for n, x in zip(cam.Intrinsics._fields, self.intr_np)))

    # ------------------------------------------------------------------
    # Initial pair
    # ------------------------------------------------------------------
    def candidate_pairs(self, top: int = 20):
        """Pairs ranked by number of common tracks (over the (T, K) table:
        K*(K-1)/2 slot pairs, encoded keys, one unique)."""
        K = self.cfg.max_track_obs
        keys = []
        V = self.n_views
        for i in range(K):
            for j in range(i + 1, K):
                m = self.tbl_mask[:, i] & self.tbl_mask[:, j]
                if not m.any():
                    continue
                vi = self.tbl_view[m, i].astype(np.int64)
                vj = self.tbl_view[m, j].astype(np.int64)
                keys.append(np.minimum(vi, vj) * V + np.maximum(vi, vj))
        if not keys:
            return []
        uniq, counts = np.unique(np.concatenate(keys), return_counts=True)
        order = np.argsort(-counts)[:top]
        return [(int(k // V), int(k % V)) for k in uniq[order]]

    def _pair_coverage_score(self, view, obs_idx):
        """Pyramid coverage score of a view restricted to given observation
        rows (ref: computeCandidateImageScore .cpp:1453-1473)."""
        cells = self.pyr_cells[obs_idx]
        return sum(len(np.unique(cells[:, lvl])) * self.pyr_weights[lvl] for lvl in range(self.cfg.pyramid_depth))

    def _pair_obs(self, vi, vj):
        """Common tracks and their observations in the two views."""
        oi = self.view_obs[vi]
        oj = self.view_obs[vj]
        common, ii, jj = np.intersect1d(self.obs_track[oi], self.obs_track[oj], return_indices=True)
        return common, oi[ii], oj[jj]

    def _evaluate_initial_pairs(self, cand_pairs):
        """Robust relative pose + baseline/coverage score for a list of
        candidate pairs in one batched call (ref: .cpp:1414-1424 — score =
        angle_score * min(coverage_i, coverage_j)). Returns (score,
        commit payload) for every pair that passes the hard gates."""
        cfg = self.cfg
        pair_data = []
        for vi, vj in cand_pairs:
            common, oi, oj = self._pair_obs(vi, vj)
            if len(common) >= cfg.min_pts_init:
                pair_data.append((vi, vj, common, oi, oj))
        if not pair_data:
            return []
        B, cap = len(pair_data), max(len(d[2]) for d in pair_data)
        x1 = np.zeros((B, cap, 2), np.float32)
        x2 = np.zeros((B, cap, 2), np.float32)
        valid = np.zeros((B, cap), bool)
        for g, (_, _, common, oi, oj) in enumerate(pair_data):
            n = len(common)
            x1[g, :n] = self.obs_norm[oi]
            x2[g, :n] = self.obs_norm[oj]
            valid[g, :n] = True
        with self._timed("initial_pair"):
            R_b, c2_b, X_b, good_b, med_b, ngood_b = _to_host(*_init_pair_eval_batch(
                self.generator, self._tensor(x1), self._tensor(x2), self._tensor(valid, torch.bool),
                self._focal_mean, self._im_wh, cfg.n_ransac_hyps, cfg.resection_max_error_px,
            ))
        out = []
        for g, (vi, vj, common, oi, oj) in enumerate(pair_data):
            n = len(common)
            good = good_b[g, :n] > 0.5
            if int(ngood_b[g]) < cfg.min_pts_init:
                continue
            med_ang = float(med_b[g])
            if not np.isfinite(med_ang) or med_ang < cfg.min_angle_init_deg:
                continue
            coverage = min(self._pair_coverage_score(vi, oi[good]), self._pair_coverage_score(vj, oj[good]))
            # reasonable-angle window: reward mid-range baselines, keep the
            # ordering of extreme ones (the reference uses [min_angle; 40])
            angle_score = med_ang if med_ang <= 40.0 else max(80.0 - med_ang, 1.0)
            out.append((angle_score * coverage, (vi, vj, R_b[g], c2_b[g], common[good], X_b[g, :n][good])))
        return out

    def _commit_initial_pair(self, vi, vj, R, c2, track_ids, X):
        self.res.pose_R[vi] = np.eye(3)
        self.res.pose_c[vi] = 0.0
        self.res.pose_R[vj] = R
        self.res.pose_c[vj] = c2
        self.res.posed[[vi, vj]] = True
        self.res.points[track_ids] = X
        self.res.point_valid[track_ids] = True
        self.res.history.append(("init", vi, vj, len(track_ids)))

    def try_initial_pair(self, vi: int, vj: int) -> bool:
        evs = self._evaluate_initial_pairs([(vi, vj)])
        if not evs:
            return False
        self._commit_initial_pair(*evs[0][1])
        return True

    def initialize(self) -> bool:
        """Commit the candidate pair with the best angle x coverage score;
        all candidates are evaluated in one batched call."""
        evs = self._evaluate_initial_pairs(self.candidate_pairs(top=self.cfg.init_pair_candidates))
        if not evs:
            return False
        self._commit_initial_pair(*max(evs, key=lambda ev: ev[0])[1])
        return True

    # ------------------------------------------------------------------
    # Resection
    # ------------------------------------------------------------------
    def _usable(self):
        return self.res.point_valid[self.obs_track] & ~self.res.posed[self.obs_view] & self.obs_inlier

    def view_scores(self):
        """Per unposed view: pyramid-coverage score over observations of
        valid tracks (findNextBestViews, ref .cpp:1453-1473 + weights
        :233-251): one unique() over encoded (view, level, cell) keys."""
        idx = np.nonzero(self._usable())[0]
        scores = np.zeros(self.n_views, np.float64)
        if len(idx) == 0:
            return scores
        views = self.obs_view[idx].astype(np.int64)
        max_cells = int(self.pyr_ncells.max())
        for lvl in range(self.cfg.pyramid_depth):
            uniq = np.unique(views * max_cells + self.pyr_cells[idx, lvl])
            np.add.at(scores, uniq // max_cells, self.pyr_weights[lvl])
        # a minimal usable-track count regardless of coverage
        scores[np.bincount(views, minlength=self.n_views) < self.cfg.min_track_inliers_resection] = 0.0
        return scores

    def view_usable_counts(self):
        """Per unposed view: number of observations of valid tracks."""
        return np.bincount(self.obs_view[self._usable()], minlength=self.n_views).astype(np.int64)

    def resect_views(self, views) -> list:
        """Robust-P3P resection of a group of views, 8 a batched call (the
        reference resects its findNextBestViews group in an OpenMP loop,
        .cpp:407-520). Returns the views posed."""
        cfg = self.cfg
        cand = []
        for v in views:
            obs_idx = self.view_obs[int(v)]
            tr = self.obs_track[obs_idx]
            usable = self.res.point_valid[tr]
            if usable.sum() >= cfg.min_track_inliers_resection:
                cand.append((int(v), self.res.points[tr[usable]], self.obs_norm[obs_idx[usable]]))
        posed = []
        CHUNK = 8  # bounds the (B, 4 n_hyps, N) residual tensor
        for s in range(0, len(cand), CHUNK):
            chunk = cand[s : s + CHUNK]
            B, cap = len(chunk), max(len(c[1]) for c in chunk)
            world = np.zeros((B, cap, 3), np.float32)
            obs = np.zeros((B, cap, 2), np.float32)
            valid = np.zeros((B, cap), bool)
            for g, (_, w, o) in enumerate(chunk):
                world[g, : len(w)] = w
                obs[g, : len(w)] = o
                valid[g, : len(w)] = True
            with self._timed("resection"):
                rp = robust.robust_resection_p3p_batch(
                    self.generator, self._tensor(world), self._tensor(obs), self._focal_mean, self._im_wh,
                    self._tensor(valid, torch.bool), n_hyps=cfg.n_ransac_hyps,
                    max_error_px=cfg.resection_max_error_px,
                )
                R_b, t_b, ninl_b = _to_host(rp.R, rp.t, rp.n_inliers)
            for g, (v, _, _) in enumerate(chunk):
                if int(ninl_b[g]) < cfg.min_track_inliers_resection:
                    continue
                R = R_b[g]
                self.res.pose_R[v] = R
                self.res.pose_c[v] = -R.T @ t_b[g]
                self.res.posed[v] = True
                self.res.history.append(("resect", v, int(ninl_b[g])))
                posed.append(v)
        return posed

    def resect_view(self, v: int) -> bool:
        return bool(self.resect_views([v]))

    # ------------------------------------------------------------------
    # Triangulation
    # ------------------------------------------------------------------
    def _projections(self, dtype=np.float32):
        """Per-view [R | -R c] (normalized camera: K = I)."""
        P = np.zeros((self.n_views, 3, 4), dtype)
        P[:, :3, :3] = self.res.pose_R
        P[:, :, 3] = -np.einsum("vij,vj->vi", self.res.pose_R, self.res.pose_c)
        return P

    def _triangulate_rows(self, rows):
        """Gated triangulation of the table rows `rows` from the posed
        views: (X (n, 3) NaN where a gate fails, enough (n,))."""
        cfg = self.cfg
        tv = self.tbl_view[rows]
        m = self.tbl_mask[rows] & self.res.posed[tv] & self.obs_inlier[self.tbl_obs[rows]]
        gate = _triangulate_gated_robust if cfg.robust_triangulation else _triangulate_gated
        with self._timed("triangulation"):
            (X,) = _to_host(gate(
                self._tensor(self._projections()[tv]),
                self._tensor(self.obs_norm[self.tbl_obs[rows]]),
                self._tensor(m, torch.bool),
                self._tensor(self.res.pose_c[tv]),
                cfg.max_reproj_px / self._focal_mean,
                np.radians(cfg.min_angle_deg),
            ))
        return X, m.sum(1) >= 2

    def triangulate_all(self):
        X, enough = self._triangulate_rows(np.arange(self.T))
        ok = np.isfinite(X).all(axis=1) & enough
        self.res.points[ok] = X[ok]
        self.res.point_valid = ok

    def triangulate_tracks(self, track_ids):
        """Incremental triangulation of the given tracks only (the
        reference's triangulate() touches only tracks seeing the newly
        resected views)."""
        track_ids = np.asarray(track_ids, np.int64)
        if len(track_ids) == 0:
            return
        X, enough = self._triangulate_rows(track_ids)
        ok = np.isfinite(X).all(axis=1) & enough
        self.res.points[track_ids[ok]] = X[ok]
        self.res.point_valid[track_ids] = ok

    # ------------------------------------------------------------------
    # Bundle adjustment over the full masked problem
    # ------------------------------------------------------------------
    def _obs_table_mask(self):
        return (
            self.tbl_mask
            & self.res.posed[self.tbl_view]
            & self.res.point_valid[:, None]
            & self.obs_inlier[self.tbl_obs]
        )

    def _make_problem(self, m, cam_fixed) -> ba_mod.BAProblem:
        """The (T, K) BA problem, built directly on the device."""
        t = self._tensor
        return ba_mod.BAProblem(
            cam_q=mat_to_quat(t(self.res.pose_R)),
            cam_c=t(self.res.pose_c),
            points=t(self.res.points),
            intr=self._intr_tensors(),
            obs_cam=t(self.tbl_view, torch.int32),
            obs_intr=t(self.view_intrinsic[self.tbl_view], torch.int32),
            obs_uv=t(self.obs_uv[self.tbl_obs]),
            obs_mask=t(m, torch.bool),
            cam_fixed=t(cam_fixed, torch.bool),
            point_fixed=t(~self.res.point_valid, torch.bool),
        )

    def _gauge_fixed(self, n_fixed: int = 2):
        cam_fixed = ~self.res.posed.copy()
        cam_fixed[np.nonzero(self.res.posed)[0][:n_fixed]] = True
        return cam_fixed

    def _take_solution(self, R, c, pts):
        self.res.pose_R = R
        self.res.pose_c = c
        self.res.points = np.where(self.res.point_valid[:, None], pts, self.res.points)

    def bundle_adjust(self, fix_gauge: int = 2, new_views=None):
        cfg = self.cfg
        m = self._obs_table_mask()
        cam_fixed = self._gauge_fixed(fix_gauge)
        # local BA on large scenes: hold cameras far from the new views
        if new_views and int(self.res.posed.sum()) > cfg.local_ba_min_views:
            from .local_ba import covisibility_from_table, local_ba_fixed_mask

            edges = covisibility_from_table(self.tbl_view, m)
            cam_fixed |= local_ba_fixed_mask(
                self.n_views, edges, new_views, self.res.posed, dist_refine=cfg.local_ba_distance
            )
        with self._timed("ba"):
            res = ba_mod.ba_solve(self._make_problem(m, cam_fixed), max_iters=25)
            R, c, pts, cost0, cost1, iters = _to_host(
                quat_to_mat(res.cam_q), res.cam_c, res.points, res.cost_initial, res.cost_final, res.n_iters
            )
        self._take_solution(R, c, pts)
        self.res.history.append(("ba", float(cost0), float(cost1), int(iters)))

    def remove_outliers(self):
        """Flag observations with reprojection error above the gate
        (ref: sfmFilters.cpp removeOutliers), in float64 on the host."""
        cfg = self.cfg
        tr = self.obs_track
        Xh = np.concatenate([self.res.points, np.ones((self.T, 1))], axis=1)
        proj = np.einsum("oij,oj->oi", self._projections(np.float64)[self.obs_view], Xh[tr])
        z = proj[:, 2]
        uvn = proj[:, :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)[:, None]
        err = np.linalg.norm(uvn - self.obs_norm, axis=-1) * self._focal_mean
        bad = (err > cfg.max_reproj_px) | (z <= 0)
        relevant = self.res.posed[self.obs_view] & self.res.point_valid[tr]
        flagged = bad & relevant & self.obs_inlier
        self.obs_inlier = self.obs_inlier & ~flagged
        # drop tracks that lost support
        m = self.tbl_mask & self.res.posed[self.tbl_view] & self.obs_inlier[self.tbl_obs]
        self.res.point_valid &= m.sum(1) >= 2
        self._last_outlier_tracks = np.unique(tr[flagged])
        return int(flagged.sum())

    # ------------------------------------------------------------------
    def refine_intrinsics_now(self):
        """Jointly refine poses, points and the shared intrinsics
        (`ba_solve_joint`, the reference refines intrinsics inside every
        Ceres BA, BundleAdjustment.hpp REFINE_INTRINSICS_*), then refresh
        the normalized observations. The principal point joins from 8
        posed views; distortion orders grow with the live observations
        (k1 below 3000, k1..k2 below 10000, then all)."""
        m = self._obs_table_mask()
        n_posed = int(self.res.posed.sum())
        n_obs_live = int(m.sum())
        order = 1 if n_obs_live < 3000 else (2 if n_obs_live < 10000 else None)
        with self._timed("joint_ba"):
            res = ba_mod.ba_solve_joint(
                self._make_problem(m, self._gauge_fixed(2)), max_iters=15,
                refine_pp=n_posed >= 8, disto_max_order=order,
            )
            R, c, pts, scale, offset, disto = _to_host(
                quat_to_mat(res.cam_q), res.cam_c, res.points, res.intr.scale, res.intr.offset, res.intr.disto
            )
        self._take_solution(R, c, pts)
        self.intr_np = self.intr_np._replace(
            scale=scale.astype(np.float32), offset=offset.astype(np.float32), disto=disto.astype(np.float32)
        )
        self._recompute_obs_norm()
        self.res.history.append(("refine_intrinsics", float(np.mean(self.intr_np.scale))))

    def _recompute_obs_norm(self):
        """Undistorted normalized coordinates of every observation under
        the current intrinsics, computed on the device."""
        with self._timed("normalize"):
            intr = self._intr_tensors()
            idx = self._tensor(self.view_intrinsic[self.obs_view], torch.int64)
            rows = cam.Intrinsics(*(x[idx] for x in intr))
            p = cam.ima2cam(rows, self._tensor(self.obs_uv))
            (norm,) = _to_host(cam.remove_distortion(rows.disto_kind, rows.disto, p))
        self.obs_norm = norm.astype(np.float32)
        self._focal_mean = float(np.mean(self.intr_np.scale))

    # ------------------------------------------------------------------
    def seed_from_sfmdata(self, sc, view_map=None):
        """Pre-populate the engine from an existing reconstruction (the
        reference's SfM augmentation, .cpp:183-223). sc's landmark_ids are
        track indices of this engine's track set (to_sfmdata writes them
        so); view_map maps an sc view index to an engine view index."""
        vm = (lambda v: v) if view_map is None else view_map
        for v in np.asarray(sc.valid_views()):
            ev = vm(int(v))
            p = int(sc.view_pose[int(v)])
            self.res.pose_R[ev] = sc.pose_R[p]
            self.res.pose_c[ev] = sc.pose_c[p]
            self.res.posed[ev] = True
        ids = np.asarray(sc.landmark_ids)
        keep = (ids >= 0) & (ids < self.T)
        self.res.points[ids[keep]] = np.asarray(sc.points)[keep]
        self.res.point_valid[ids[keep]] = True
        self.res.history.append(("seed", int(self.res.posed.sum()), int(keep.sum())))

    def process(self, max_iterations: int = 1000) -> IncrementalResult:
        if self.res.posed.sum() < 2:  # else: seeded scene — resume/augment
            if not self.initialize():
                raise RuntimeError("no valid initial pair found")
        self.triangulate_all()
        self.bundle_adjust()
        self.remove_outliers()
        self.triangulate_all()
        next_refine_at = 4

        it = 0
        while it < max_iterations:
            it += 1
            scores = self.view_scores()
            best = scores.max()
            if best <= 0:
                break
            # group: views within 75% of the best score, up to group_add
            group_cap = 1 if int(self.res.posed.sum()) < 4 else self.cfg.group_add
            group = [v for v in np.argsort(-scores) if scores[v] >= 0.75 * best][:group_cap]
            new_views = self.resect_views(group)
            if not new_views:
                break
            # only tracks seeing the new views can change
            new_obs = np.concatenate([self.view_obs[v] for v in new_views])
            self.triangulate_tracks(np.unique(self.obs_track[new_obs]))
            n_posed = int(self.res.posed.sum())
            # refine every group until the scene is established, then on the
            # doubling cadence
            if self.cfg.refine_intrinsics and (n_posed <= 4 * self.cfg.group_add or n_posed >= next_refine_at):
                self.refine_intrinsics_now()
                next_refine_at = max(next_refine_at * 2, n_posed + 1)
            self.bundle_adjust(new_views=new_views)
            for _ in range(5):
                # re-BA only while the outlier count stays above
                # bundleAdjustmentMaxOutliers (hpp:96)
                if self.remove_outliers() < self.cfg.ba_max_outliers:
                    break
                self.triangulate_tracks(self._last_outlier_tracks)
                self.bundle_adjust(new_views=new_views)
        return self.res

    # ------------------------------------------------------------------
    def to_sfmdata(self, view_ids=None):
        """Export the reconstruction as an SfMData scene; landmark_ids are
        track indices."""
        from ..sfmdata import SfMData

        sc = SfMData.empty()
        intr = self.intr_np
        for i in range(len(np.atleast_1d(intr.cam_kind))):
            sc.add_intrinsic(
                1000 + i,
                int(np.atleast_2d(intr.size)[i, 0]),
                int(np.atleast_2d(intr.size)[i, 1]),
                float(np.atleast_2d(intr.scale)[i, 0]),
                cam_kind=int(np.atleast_1d(intr.cam_kind)[i]),
                disto_kind=int(np.atleast_1d(intr.disto_kind)[i]),
                disto_params=tuple(np.atleast_2d(intr.disto)[i]),
                offset=tuple(np.atleast_2d(intr.offset)[i]),
                focal_y_px=float(np.atleast_2d(intr.scale)[i, 1]),
            )
        ids = view_ids if view_ids is not None else np.arange(self.n_views)
        for v in range(self.n_views):
            vi = sc.add_view(int(ids[v]), int(self.view_intrinsic[v]), int(self.image_sizes[v, 0]),
                             int(self.image_sizes[v, 1]))
            if self.res.posed[v]:
                sc.set_pose(vi, self.res.pose_R[v], self.res.pose_c[v])
        valid_t = np.nonzero(self.res.point_valid)[0]
        remap = -np.ones(self.T, np.int64)
        remap[valid_t] = np.arange(len(valid_t))
        keep_obs = self.res.point_valid[self.obs_track] & self.res.posed[self.obs_view] & self.obs_inlier
        sc.set_structure(
            self.res.points[valid_t],
            remap[self.obs_track[keep_obs]],
            self.obs_view[keep_obs],
            self.obs_uv[keep_obs],
            landmark_ids=valid_t.astype(np.int64),
        )
        return sc


# ---------------------------------------------------------------------------
# batched device steps
# ---------------------------------------------------------------------------


def _init_pair_eval_batch(generator, x1, x2, valid, focal_mean, im_size, n_hyps, max_error_px, idx=None):
    """All initial-pair candidates in one batched call: robust relative pose,
    two-view triangulation, cheirality/angle gating and the masked median
    triangulation angle of each pair (makeInitialPair3D evaluation,
    .cpp:1414-1424). x1, x2: (B, N, 2) normalized; valid (B, N). Returns
    (R (B, 3, 3), c2 (B, 3), X (B, N, 3), good (B, N), median angle in
    degrees (B,), n_good (B,))."""
    R, t, rm = robust.robust_relative_pose(
        generator, x1, x2, focal_mean, im_size, valid=valid, n_hyps=n_hyps, max_error_px=max_error_px, idx=idx,
    )
    eye34 = torch.eye(3, 4, dtype=x1.dtype, device=x1.device)
    P2 = torch.cat([R, t[..., None]], dim=-1)
    X = mv.triangulate_dlt(eye34.expand(P2.shape)[:, None], P2[:, None], x1, x2)  # (B, N, 3)
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    d2 = X - c2[:, None, :]
    cosang = torch.sum(X * d2, -1) / (torch.linalg.norm(X, dim=-1) * torch.linalg.norm(d2, dim=-1) + 1e-12)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    good = rm.inliers & (X[..., 2] > 0) & (ang > 0.5) & valid
    n_good = torch.sum(good, dim=-1)
    ang_sorted, _ = torch.sort(torch.where(good, ang, torch.full_like(ang, torch.inf)), dim=-1)
    med = torch.gather(ang_sorted, -1, torch.clamp((n_good - 1) // 2, 0, ang.shape[-1] - 1)[..., None])[..., 0]
    return R, c2, X, good, med, n_good


def _gate(X, Pb, uv, mask, centers, max_err_norm, min_angle_rad):
    """The reprojection / depth / triangulation-angle gates of (T, 3)
    points against their (T, K) observations under `mask`: a boolean (T,)."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    proj = torch.einsum("tkij,tj->tki", Pb, Xh)
    z = proj[..., 2]
    uvp = proj[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)[..., None]
    err = torch.linalg.norm(uvp - uv, dim=-1)
    ok_err = torch.where(mask, (err < max_err_norm) & (z > 0), torch.ones_like(mask))
    # the largest pairwise triangulation angle across observing views
    d = X[:, None, :] - centers
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    cosang = dn @ dn.transpose(-1, -2)
    pair_m = mask[:, :, None] & mask[:, None, :]
    ang = torch.where(pair_m, torch.arccos(torch.clamp(cosang, -1.0, 1.0)), torch.zeros_like(cosang))
    return torch.all(ok_err, dim=1) & (torch.amax(ang, dim=(1, 2)) > min_angle_rad)


def _triangulate_gated(Pb, uv, mask, centers, max_err_norm, min_angle_rad):
    """Masked N-view DLT + reprojection/angle/depth gates. Pb: (T, K, 3, 4)
    in normalized camera units; uv: (T, K, 2); centers: (T, K, 3). Returns
    (T, 3) with NaN rows where a gate fails."""
    X = mv.triangulate_nview(Pb, uv, mask)
    good = _gate(X, Pb, uv, mask, centers, max_err_norm, min_angle_rad)
    return torch.where(good[:, None], X, torch.full_like(X, torch.nan))


def _triangulate_gated_robust(Pb, uv, mask, centers, max_err_norm, min_angle_rad):
    """LO-RANSAC variant: view-pair hypotheses voted by the whole track, a
    masked refit on the inliers, then the same gates over the inlier views
    (ref: NViewsTriangulationLORansac.hpp:48)."""
    X, inl, valid = mv.triangulate_nview_robust(Pb, uv, mask=mask, threshold_px=max_err_norm)
    good = valid & _gate(X, Pb, uv, inl, centers, max_err_norm, min_angle_rad)
    return torch.where(good[:, None], X, torch.full_like(X, torch.nan))
