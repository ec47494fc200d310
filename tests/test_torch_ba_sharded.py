"""The port's landmark-sharded BA (parallel/ba_sharded.py) on 2 and 4 gloo
ranks against the port's single-process ba_solve and the JAX package's
solve_sharded on 2 and 4 virtual devices, at tests/test_sharded_ba.py's
tolerances (cost_initial rtol 1e-4, cost_final rtol 1e-3 atol 1e-4, cam_c
atol 5e-3), with the dense and the PCG solver; the padding equal to JAX's
arrays; and one rank equal to ba_solve bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from alicevision_tpu.parallel import ba_sharded as jbs
from alicevision_tpu.parallel.mesh import make_mesh as jmake_mesh
from alicevision_tpu_torch.convert import ba_problem_from_numpy
from alicevision_tpu_torch.parallel import ba_sharded as tbs
from alicevision_tpu_torch.parallel import distributed as tdist
from alicevision_tpu_torch.parallel.mesh import make_mesh
from alicevision_tpu_torch.sfm import ba as tba
from test_sharded_ba import _problem
from torch_rank_targets import HERE

torch.set_num_threads(1)

MAX_ITERS = 12
RANKS = (2, 4)


def _numpy(problem):
    return jax.tree_util.tree_map(np.asarray, problem)


@pytest.fixture(scope="module")
def problems():
    """The JAX test's problem (10 views, 300 landmarks, 6 a track), once."""
    jp = _problem()
    return jp, ba_problem_from_numpy(_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def jax_sharded(problems):
    """JAX's solve_sharded on 2 and 4 virtual devices."""
    jp, _ = problems
    out = {}
    for n in RANKS:
        mesh = jmake_mesh(n_view=1, n_landmark=n, devices=jax.devices()[:n])
        out[n] = jax.tree_util.tree_map(np.asarray, jbs.solve_sharded(jp, mesh, max_iters=MAX_ITERS))
    return out


@pytest.fixture(scope="module")
def port_sharded(problems, tmp_path_factory):
    """The port's solve_sharded on 2 and 4 gloo ranks, both solvers, every
    rank's result."""
    _, tp = problems
    arrays = dict(tbs.problem_arrays(tp), solvers=np.asarray("dense,pcg"), max_iters=np.asarray(MAX_ITERS))
    return {n: tdist.launch_local("torch_rank_targets:ba_solve_rank", n, arrays,
                                  str(tmp_path_factory.mktemp(f"ba{n}")), timeout=120.0, path=[HERE])
            for n in RANKS}


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_pad_problem_matches(problems, n):
    jp, tp = problems
    ref = _numpy(jbs.pad_problem_for_mesh(_numpy(jp), n))
    out = tbs.pad_problem_for_mesh(tp, n)
    for name in ("points", "obs_cam", "obs_intr", "obs_uv", "obs_mask", "point_fixed", "cam_q", "cam_c"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_shard_problem_blocks(problems):
    _, tp = problems
    mesh = make_mesh(2, 2, ranks=range(4))
    padded = tbs.pad_problem_for_mesh(tp, 4)
    blocks = []
    for r in range(4):
        local = tbs.shard_problem(tp, dataclasses.replace(mesh, rank=r))
        assert local.points.shape[0] == padded.points.shape[0] // 4
        assert torch.equal(local.cam_q, tp.cam_q) and torch.equal(local.intr.scale, tp.intr.scale)
        blocks.append(local.obs_uv)
    assert torch.equal(torch.cat(blocks), padded.obs_uv)


def _held(got, want):
    """tests/test_sharded_ba.py's tolerances."""
    assert np.isclose(float(got["cost_initial"]), float(want["cost_initial"]), rtol=1e-4)
    assert np.isclose(float(got["cost_final"]), float(want["cost_final"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["cam_c"], want["cam_c"], atol=5e-3)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
@pytest.mark.parametrize("n", RANKS)
def test_sharded_ba_matches(problems, jax_sharded, port_sharded, n, solver):
    _, tp = problems
    ranks = port_sharded[n]
    res = {k.split(".", 1)[1]: v for k, v in ranks[0].items() if k.startswith(solver + ".")}
    # every rank took the same steps and holds the same cameras and points
    for other in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(other[k], ranks[0][k])
    single = tba.ba_solve(tbs.pad_problem_for_mesh(tp, n), max_iters=MAX_ITERS, solver=solver)
    _held(res, {k: np.asarray(v) for k, v in single._asdict().items()})
    _held(res, {k: np.asarray(v) for k, v in jax_sharded[n]._asdict().items()})
    assert float(res["cost_final"]) < 0.2 * float(res["cost_initial"])
    assert res["points"].shape == (tbs.pad_problem_for_mesh(tp, n).points.shape[0], 3)
    np.testing.assert_allclose(res["points"][:300], single.points.numpy()[:300], atol=5e-3)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_one_rank_is_ba_solve(problems, solver):
    """On a one-rank mesh no collective runs and the solve is ba_solve's."""
    _, tp = problems
    mesh = make_mesh()
    tdist.reset_comm_bytes()
    out = tbs.solve_sharded(tp, mesh, max_iters=MAX_ITERS, solver=solver)
    ref = tba.ba_solve(tp, max_iters=MAX_ITERS, solver=solver)
    assert tdist.comm_bytes == {}
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
