"""chip_smoke.py's `scaleout` phase on the CPU at a small size: a gloo
group of one rank (nccl on the card) joined by distributed.join_group, the
port's counted collectives over it, the landmark-sharded BA held to
ba_solve, make_sharded_sgm on 8 rendered 160x120 views at D = 96 equal to
batched_sgm, the ring-halo filter equal to consistency_filter_ring and the
comms tables at one shard with no collective byte; the group is gone
after it."""

import os

import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scaleout(tmp_path_factory):
    import chip_smoke
    from alicevision_tpu_torch.pipeline import stages as tst

    work = str(tmp_path_factory.mktemp("scaleout"))
    sfm, _ = chip_smoke.make_posed_scene(work, n_views=8, wh=(160, 120), focal_px=140.0, n_points=600)
    dense = os.path.join(work, "dense")
    tst.prepare_dense_scene(sfm, dense, device="cpu")
    return chip_smoke.check_scaleout("cpu", work, sfm, dense, "cpu")


def test_scaleout_phase_readings(scaleout):
    row, launches = scaleout
    assert not dist.is_initialized()
    assert row["backend"] == "gloo" and row["world_size"] == 1 and row["mesh"] == {"view": 1, "landmark": 1}
    assert row["collectives"]["equal"] == {"all-reduce": True, "all-gather": True, "gather": True}
    assert row["collectives"]["bytes"] == {"all-reduce": 4096, "all-gather": 4096, "gather": 4096}
    assert [r["solver"] for r in row["ba"]] == ["dense", "pcg"]
    for r in row["ba"]:
        assert r["collective_bytes"] == {} and r["cost_final"] < 0.2 * r["cost_initial"]
    assert row["sgm"]["equal_to_batched_sgm"] and row["sgm"]["views"] == 8
    assert row["fusion"]["filtered_equal"] and row["fusion"]["counts_equal"] and row["fusion"]["kept_frac"] > 0.1
    assert [r["shards"] for r in row["comms"]["ba"] + row["comms"]["fusion"]] == [1, 1]
    assert launches == {"sgm_directional_pass": 0, "sgm_axis_sweeps": 0}  # no kernel on the CPU
