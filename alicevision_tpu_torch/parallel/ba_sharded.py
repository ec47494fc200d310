"""Distributed Schur-complement BA: landmark blocks sharded across ranks.

Port of `alicevision_tpu/parallel/ba_sharded.py` on `torch.distributed`.
Each rank owns a contiguous block of the landmarks (and their observation
rows) and forms its partial contributions to the reduced camera system
with `sfm/ba.py`'s own pieces; the camera-sized terms (U, g_c, b, the
dense -B B^T or each PCG matvec's landmark sum, the costs) are summed with
one `all_reduce` each, and every rank solves the camera step redundantly
and back-substitutes its own points (ref: the DENSE_SCHUR / SPARSE_SCHUR
split of src/aliceVision/sfm/bundle/BundleAdjustmentCeres.cpp:216-231).
Every branch of the LM and CG loops reads a summed value, so the ranks
leave each loop together.

The JAX package steers XLA's partitioner with `ba._SPMD_FORMS`; that is
TPU transport and has no port. Sums over ranks associate differently from
one process's sums, so a sharded solve agrees with `ba_solve` to float32
rounding, not bit for bit; on a one-rank mesh it is `ba_solve` itself.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from .. import camera as cam
from ..numeric import f32_matmuls
from ..sfm import ba as ba_mod
from . import distributed
from .mesh import AXES, Mesh, shard_leading

# the landmark-major fields of a BAProblem (split over the ranks; the rest
# is replicated)
_LANDMARK_FIELDS = ("points", "obs_cam", "obs_intr", "obs_uv", "obs_mask", "point_fixed", "obs_sub")


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def pad_problem_for_mesh(problem: ba_mod.BAProblem, n_shards: int) -> ba_mod.BAProblem:
    """Pad the landmark dimension so it divides the shard count: the padded
    landmarks are fixed and have no observation."""
    L = problem.points.shape[0]
    Lp = _round_up(max(L, n_shards), n_shards)
    if Lp == L:
        return problem
    pad = Lp - L

    def padL(a, value=0):
        return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), value)])

    return problem._replace(
        points=padL(problem.points),
        obs_cam=padL(problem.obs_cam),
        obs_intr=padL(problem.obs_intr),
        obs_uv=padL(problem.obs_uv),
        obs_mask=padL(problem.obs_mask),
        point_fixed=padL(problem.point_fixed, True),
        obs_sub=None if problem.obs_sub is None else padL(problem.obs_sub),
    )


def shard_problem(problem: ba_mod.BAProblem, mesh: Mesh) -> ba_mod.BAProblem:
    """This rank's problem: the landmarks padded to a multiple of the mesh's
    ranks and split over all of them (both axes, as the JAX package's
    `P(("view", "landmark"))`), this rank's contiguous block kept; the
    cameras and intrinsics whole."""
    problem = pad_problem_for_mesh(problem, mesh.size)
    return problem._replace(**{
        f: shard_leading(mesh, AXES, getattr(problem, f))
        for f in _LANDMARK_FIELDS if getattr(problem, f) is not None
    })


def make_sharded_ba(mesh: Mesh, max_iters: int = 25, **solve_kw):
    """The distributed `ba_solve` bound to a mesh: a function of this rank's
    block (`shard_problem`) that returns the BAResult every rank shares,
    with `points` this rank's block. `solve_kw` are ba_solve's options
    (solver, loop, cg_iters, ...); "auto" picks the solver for the
    landmarks of all ranks. The options' defaults are ba_solve's own."""
    bound = inspect.signature(ba_mod.ba_solve).bind(None, max_iters, **solve_kw)
    bound.apply_defaults()
    kw = dict(bound.arguments)
    del kw["problem"]
    reduce = None if mesh.size == 1 else (lambda t: distributed.all_reduce(t, mesh.group))

    @f32_matmuls
    def solve(local: ba_mod.BAProblem) -> ba_mod.BAResult:
        return ba_mod._lm_solve(local, **kw, reduce=reduce, n_landmarks=local.points.shape[0] * mesh.size)

    return solve


def gather_points(points: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block of points, in landmark order (all ranks get it)."""
    if mesh.size == 1:
        return points
    blocks = distributed.all_gather(points, mesh.group)
    return torch.cat([blocks[i] for i in mesh.group_positions()])


def solve_sharded(problem: ba_mod.BAProblem, mesh: Mesh, max_iters: int = 25, **solve_kw):
    """Solve the whole `problem` (every rank passes the same) with its
    landmarks sharded over the mesh. Returns the BAResult with the padded
    landmarks' points of all ranks, as the JAX package's global array."""
    res = make_sharded_ba(mesh, max_iters, **solve_kw)(shard_problem(problem, mesh))
    return res._replace(points=gather_points(res.points, mesh))


def problem_arrays(problem: ba_mod.BAProblem) -> dict:
    """A BAProblem as a flat dict of numpy arrays (`intr.<field>` for the
    intrinsics), for an `.npz` that every rank reads."""
    out = {}
    for name in ba_mod.BAProblem._fields:
        v = getattr(problem, name)
        if name == "intr":
            out.update({f"intr.{k}": np.asarray(getattr(v, k).cpu()) for k in cam.Intrinsics._fields})
        elif v is not None:
            out[name] = np.asarray(v.cpu())
    return out


def problem_from_arrays(arrays: dict, device="cuda") -> ba_mod.BAProblem:
    """`problem_arrays`'s inverse, on `device`."""
    from ..device import resolve_device

    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    intr = cam.Intrinsics(*(t(arrays[f"intr.{k}"]) for k in cam.Intrinsics._fields))
    return ba_mod.BAProblem(**{
        name: intr if name == "intr" else (t(arrays[name]) if name in arrays else None)
        for name in ba_mod.BAProblem._fields
    })
