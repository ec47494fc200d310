"""The port's rank runtime and mesh (parallel/distributed.py, mesh.py)
against the JAX package's on the 8 virtual CPU devices: mesh layouts and
their asserts, the placements of shard_leading / replicated, the view
ranges of every rank, and init_distributed's single-process and no-card
behaviour."""

import jax
import numpy as np
import pytest
import torch

from alicevision_tpu.parallel import distributed as jdist
from alicevision_tpu.parallel import mesh as jmesh
from alicevision_tpu_torch.parallel import distributed as tdist
from alicevision_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

LAYOUTS = [(None, None), (2, None), (None, 2), (2, 4), (4, 2), (8, 1), (1, 8), (None, 8), (8, None)]


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("n_view,n_landmark", LAYOUTS)
def test_make_mesh_layout_matches(n_view, n_landmark):
    devices = jax.devices()
    assert len(devices) == 8
    ref = jmesh.make_mesh(n_view, n_landmark, devices=devices)
    out = tmesh.make_mesh(n_view, n_landmark, ranks=[d.id for d in devices])
    np.testing.assert_array_equal(out.ranks, _ids(ref))
    assert out.axis_names == tuple(ref.axis_names)
    assert out.shape == dict(ref.shape)
    assert out.size == ref.devices.size


@pytest.mark.parametrize("n_view,n_landmark", [(3, None), (None, 3), (3, 3), (2, 2)])
def test_make_mesh_asserts_match(n_view, n_landmark):
    with pytest.raises(AssertionError):
        jmesh.make_mesh(n_view, n_landmark, devices=jax.devices())
    with pytest.raises(AssertionError):
        tmesh.make_mesh(n_view, n_landmark, ranks=range(8))


def test_make_mesh_without_group_is_one_rank():
    mesh = tmesh.make_mesh()
    assert mesh.ranks.tolist() == [[0]] and mesh.rank == 0 and mesh.group is None


@pytest.mark.parametrize("axis", ["view", "landmark", ("view", "landmark")])
@pytest.mark.parametrize("n_view,n_landmark", [(2, 4), (4, 2), (1, 8)])
def test_shard_leading_places_as_named_sharding(axis, n_view, n_landmark):
    """Each rank's block is the slice JAX's NamedSharding puts on the
    device with that id; replicated is the whole array everywhere."""
    devices = jax.devices()
    ref_mesh = jmesh.make_mesh(n_view, n_landmark, devices=devices)
    mesh = tmesh.make_mesh(n_view, n_landmark, ranks=[d.id for d in devices])
    x = np.arange(16 * 3).reshape(16, 3)
    placed = jmesh.shard_leading(ref_mesh, axis).devices_indices_map(x.shape)
    whole = jmesh.replicated(ref_mesh).devices_indices_map(x.shape)
    for d in devices:
        np.testing.assert_array_equal(tmesh.shard_leading(mesh, axis, x, rank=d.id), x[placed[d]])
        np.testing.assert_array_equal(tmesh.replicated(mesh, x), x[whole[d]])
    if mesh.axis_size(axis) > 1:
        with pytest.raises(ValueError):
            tmesh.shard_leading(mesh, axis, np.zeros((mesh.axis_size(axis) + 1, 2)))


@pytest.mark.parametrize("n_views", [1, 7, 8, 40, 41])
@pytest.mark.parametrize("n_proc", [1, 2, 3, 4])
def test_host_local_view_range_matches(monkeypatch, n_views, n_proc):
    for p in range(n_proc):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        monkeypatch.setattr(jax, "process_count", lambda: n_proc)
        monkeypatch.setattr(tdist, "process_index", lambda p=p: p)
        monkeypatch.setattr(tdist, "process_count", lambda: n_proc)
        assert tdist.host_local_view_range(n_views) == jdist.host_local_view_range(n_views)


def test_single_process_runtime(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.init_distributed(device="cpu") is False
    assert jdist.init_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert tdist.is_primary() and tdist.process_count() == 1
    assert tdist.local_device("cpu") == torch.device("cpu")


def test_init_distributed_needs_a_card_for_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.init_distributed()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.local_device()


def test_launch_local_times_out_and_reports_failures(tmp_path):
    """A rank that never returns is killed at the caller's timeout; a rank
    that raises makes launch_local raise with its output."""
    from torch_rank_targets import HERE

    with pytest.raises(TimeoutError):
        tdist.launch_local("torch_rank_targets:sleep_forever", 2, {}, str(tmp_path / "sleep"), timeout=5.0,
                           path=[HERE])
    with pytest.raises(RuntimeError, match="this rank fails"):
        tdist.launch_local("torch_rank_targets:fails", 2, {}, str(tmp_path / "fails"), timeout=60.0, path=[HERE])
