"""Modular incremental engine: the bootstrap / expansion decomposition.

Port of `alicevision_tpu/sfm/expansion.py` (host numpy over the port's
`IncrementalSfM`, whose steps compute on its device), the counterpart of
the reference's v3.3 modular incremental SfM
(ref: src/aliceVision/sfm/pipeline/expanding/ExpansionProcess.hpp:20-31 ->
ExpansionIteration -> ExpansionChunk.hpp:18, pluggable ExpansionPolicy
(ExpansionPolicyLegacy.hpp:15), SfmResection / SfmTriangulation / SfmBundle
units; driven by main_tracksBuilding / main_sfmBootstraping /
main_sfmExpanding, main_sfmExpanding.cpp:206-211). The same batched
primitives as IncrementalSfM, exposed as separable, externally-drivable
steps with checkpointable state between them. `ExpansionProcess` takes
any object with a `process(engine)` method as its post-process, such as
`ExpansionPostProcessRig` (the rig BA of `sfm/rig_sequence.py` on the
engine's device).
"""

from __future__ import annotations

import numpy as np

from .incremental import IncrementalSfM


class ExpansionPolicyLegacy:
    """View-selection policy: score = observations of valid landmarks,
    relative-threshold grouping (ExpansionPolicyLegacy semantics)."""

    def __init__(self, rel_threshold: float = 0.75, chunk_cap: int = 30):
        self.rel_threshold = rel_threshold
        self.chunk_cap = chunk_cap

    def select(self, engine: IncrementalSfM) -> list:
        scores = engine.view_scores()  # pyramid-coverage score
        best = scores.max()
        if best <= 0:
            return []
        n_posed = int(engine.res.posed.sum())
        cap = 1 if n_posed < 4 else self.chunk_cap
        cands = np.argsort(-scores)
        return [int(v) for v in cands if scores[v] >= self.rel_threshold * best][:cap]


class LbaPolicyConnexity:
    """Local-BA policy: cameras beyond `distance` covisibility hops from
    the chunk's new views are held constant
    (ref: expanding/LbaPolicyConnexity.hpp + ConnexityGraph.hpp)."""

    def __init__(self, distance: int = 1):
        self.distance = distance

    def fixed_mask(self, engine: IncrementalSfM, new_views: list) -> np.ndarray:
        from .local_ba import covisibility_from_table, local_ba_fixed_mask

        m = engine._obs_table_mask()
        edges = covisibility_from_table(engine.tbl_view, m)
        return local_ba_fixed_mask(
            engine.n_views, edges, new_views, engine.res.posed,
            dist_refine=self.distance,
        )


class ExpansionHistory:
    """Per-iteration bookkeeping + checkpointable engine state
    (ref: expanding/ExpansionHistory.hpp — epochs, per-iteration stats).

    save()/load() serialize the engine's mutable reconstruction state to
    .npz so a crashed expansion resumes mid-reconstruction (the in-loop
    analog of the stage-file contract)."""

    def __init__(self):
        self.epochs: list = []

    def record(self, engine: IncrementalSfM, added: list):
        self.epochs.append(
            {
                "epoch": len(self.epochs),
                "added_views": list(added),
                "n_posed": int(engine.res.posed.sum()),
                "n_landmarks": int(engine.res.point_valid.sum()),
            }
        )

    @staticmethod
    def save(engine: IncrementalSfM, path: str):
        np.savez_compressed(
            path,
            pose_R=engine.res.pose_R,
            pose_c=engine.res.pose_c,
            posed=engine.res.posed,
            points=engine.res.points,
            point_valid=engine.res.point_valid,
            obs_inlier=engine.obs_inlier,
            intr_scale=np.asarray(engine.intr_np.scale),
            intr_offset=np.asarray(engine.intr_np.offset),
            intr_disto=np.asarray(engine.intr_np.disto),
        )

    @staticmethod
    def load(engine: IncrementalSfM, path: str):
        with np.load(path) as z:
            engine.res.pose_R = z["pose_R"]
            engine.res.pose_c = z["pose_c"]
            engine.res.posed = z["posed"]
            engine.res.points = z["points"]
            engine.res.point_valid = z["point_valid"]
            engine.obs_inlier = z["obs_inlier"]
            engine.intr_np = engine.intr_np._replace(
                scale=z["intr_scale"],
                offset=z["intr_offset"],
                disto=z["intr_disto"],
            )
        engine._recompute_obs_norm()


class ExpansionPostProcessRig:
    """Post-expansion rig calibration (ref: ExpansionPostProcessRig.cpp):
    when views carry rig (frame, sub) assignments, calibrate the shared
    sub-poses and re-solve the scene over frame poses + sub-poses."""

    def __init__(self, view_frame, view_sub, n_sub: int, rounds: int = 8):
        self.view_frame = np.asarray(view_frame)
        self.view_sub = np.asarray(view_sub)
        self.n_sub = n_sub
        self.rounds = rounds

    def process(self, engine: IncrementalSfM):
        from .rig_sequence import solve_rig_sequence

        res = engine.res
        keep = res.point_valid[engine.obs_track] & res.posed[engine.obs_view] & engine.obs_inlier
        R_v, c_v, sub_R, sub_t, _, _, pts, _ = solve_rig_sequence(
            res.pose_R,
            res.pose_c,
            res.posed,
            self.view_frame,
            self.view_sub,
            self.n_sub,
            res.points[res.point_valid],
            engine.intr_np,
            # landmarks re-indexed compactly for the rig problem
            np.searchsorted(np.nonzero(res.point_valid)[0], engine.obs_track[keep]),
            engine.obs_view[keep],
            engine.view_intrinsic[engine.obs_view[keep]],
            engine.obs_uv[keep],
            rounds=self.rounds,
            device=engine.device,
        )
        posed = res.posed
        res.pose_R[posed] = R_v[posed]
        res.pose_c[posed] = c_v[posed]
        res.points[res.point_valid] = pts[: int(res.point_valid.sum())]
        res.history.append(("rig_postprocess", self.n_sub))
        return sub_R, sub_t


class ExpansionChunk:
    """One chunk: resect the selected views, triangulate, bundle, filter
    (ExpansionChunk::process)."""

    def __init__(self, engine: IncrementalSfM):
        self.engine = engine

    def process(self, views: list) -> int:
        e = self.engine
        added = [v for v in views if e.resect_view(v)]
        if not added:
            return 0
        e.triangulate_all()
        e.bundle_adjust(new_views=added)
        for _ in range(5):
            if e.remove_outliers() == 0:
                break
            e.triangulate_all()
            e.bundle_adjust(new_views=added)
        return len(added)


class ExpansionIteration:
    """One iteration: policy selects a chunk, the chunk processes it."""

    def __init__(self, engine: IncrementalSfM, policy=None):
        self.engine = engine
        self.policy = policy or ExpansionPolicyLegacy()
        self.chunk = ExpansionChunk(engine)

    def process(self) -> int:
        views = self.policy.select(self.engine)
        if not views:
            return 0
        return self.chunk.process(views)


class ExpansionProcess:
    """Drives iterations until exhaustion (ExpansionProcess::process).

    Supports the reference's "SfM augmentation" behavior: if the engine
    already has posed views (e.g. restored from a checkpoint), bootstrap is
    skipped and expansion continues from the existing scene
    (ReconstructionEngine_sequentialSfM.cpp:183-223)."""

    def __init__(self, engine: IncrementalSfM, policy=None, max_iterations=1000,
                 history: "ExpansionHistory | None" = None,
                 post_process=None, checkpoint_path: str | None = None):
        self.engine = engine
        self.iteration = ExpansionIteration(engine, policy)
        self.max_iterations = max_iterations
        self.history = history or ExpansionHistory()
        self.post_process = post_process
        self.checkpoint_path = checkpoint_path

    def bootstrap(self) -> bool:
        if self.engine.res.posed.any():
            return True  # augmentation mode — scene already initialized
        if not self.engine.initialize():
            return False
        self.engine.triangulate_all()
        self.engine.bundle_adjust()
        self.engine.remove_outliers()
        self.engine.triangulate_all()
        return True

    def process(self):
        if not self.bootstrap():
            raise RuntimeError("bootstrap failed: no valid initial pair")
        for _ in range(self.max_iterations):
            before = self.engine.res.posed.copy()
            if self.iteration.process() == 0:
                break
            added = np.nonzero(self.engine.res.posed & ~before)[0].tolist()
            self.history.record(self.engine, added)
            if self.checkpoint_path:
                ExpansionHistory.save(self.engine, self.checkpoint_path)
        if self.post_process is not None:
            self.post_process.process(self.engine)
        return self.engine.res
