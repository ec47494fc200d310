"""The port's comms report (parallel/comms_report.py): collective_bytes on
the JAX package's HLO strings, the BA rows' weak scaling as
tests/test_comms_report.py asserts it, and the fusion rows' halo bytes
(at most 1.25 x 2·k·H·W·4 a shard, none at one shard), counted from the
port's own collectives on 1 shard in process and 2 and 4 gloo ranks."""

import pytest
import torch

from alicevision_tpu.parallel.comms_report import collective_bytes as jax_collective_bytes
from alicevision_tpu_torch.parallel import comms_report as cr

torch.set_num_threads(1)

HLO = [
    """
HloModule m
  %x = f32[6,128]{1,0} all-reduce(%a), replica_groups={}
  %y = (f32[32,21]{1,0}, f32[4]{0}) all-reduce(%b, %c), channel_id=1
  %z = bf16[2,2]{1,0} all-gather(%d), dimensions={0}
  %w = f32[8]{0} add(%e, %f)
""",
    "%q = f32[10]{0} reduce(%a, %b), dimensions={0}",
    """
  %p = s32[4,8]{1,0} collective-permute(%a), source_target_pairs={{0,1},{1,0}}
  %r = (pred[3]{0}, u8[5]{0}) reduce-scatter(%b, %c), dimensions={0}
  %t = f64[2,3]{1,0} all-to-all(%d), dimensions={0}
  %u = f32[]{0} all-reduce.1(%e)
  no equals sign all-reduce(f32[9])
""",
]
V, HW, K_HALO = 32, (96, 128), 4


@pytest.mark.parametrize("hlo", HLO)
def test_collective_bytes_matches(hlo):
    assert cr.collective_bytes(hlo) == jax_collective_bytes(hlo)


def test_collective_bytes_scalar_and_tuple_results():
    out = cr.collective_bytes(HLO[0])
    assert out["all-reduce"] == 6 * 128 * 4 + (32 * 21 * 4 + 4 * 4)
    assert out["all-gather"] == 2 * 2 * 2
    assert "add" not in out


@pytest.fixture(scope="module")
def ba_rows():
    return {r["shards"]: r for r in cr.ba_comms_table(shard_counts=(1, 2, 4), n_points_per_shard=512, n_views=16,
                                                     device="cpu")}


@pytest.fixture(scope="module")
def fusion_rows():
    rows = cr.fusion_comms_table(shard_counts=(1, 2, 3, 4), V=V, hw=HW, k=K_HALO, link_gbps=100.0, tflops=10.0,
                                 device="cpu")
    return {r["shards"]: r for r in rows}


def test_rows_keep_the_keys(ba_rows, fusion_rows):
    keys = {"shards", "collective_bytes", "by_kind", "flops_per_shard", "bytes_per_flop", "projected_ici_efficiency"}
    for r in list(ba_rows.values()) + list(fusion_rows.values()):
        assert set(r) == keys


def test_ba_comms_weak_scaling(ba_rows):
    """tests/test_comms_report.py's assertions: no bytes at one shard, the
    reduced system's sums far below what gathering landmarks would move,
    per-shard FLOPs constant with 512 landmarks a shard."""
    assert ba_rows[1]["collective_bytes"] == 0 and ba_rows[1]["by_kind"] == {}
    C = 16
    for n in (2, 4):
        assert ba_rows[n]["collective_bytes"] < 500_000, ba_rows[n]
        assert set(ba_rows[n]["by_kind"]) == {"all-reduce"}
        # one LM iteration: two costs, the packed U, g_c, b and the dense S
        assert ba_rows[n]["collective_bytes"] == 4 * (2 + C * (21 + 6 + 6) + (6 * C) ** 2)
    assert ba_rows[4]["flops_per_shard"] < ba_rows[1]["flops_per_shard"] * 1.3
    assert ba_rows[1]["flops_per_shard"] > 0
    assert ba_rows[2]["projected_ici_efficiency"] is None


def test_fusion_halo_bytes(fusion_rows):
    H, W = HW
    halo = 2 * K_HALO * H * W * 4
    assert set(fusion_rows) == {1, 2, 4}  # 3 does not divide V
    assert fusion_rows[1]["collective_bytes"] == 0
    for n in (2, 4):
        assert set(fusion_rows[n]["by_kind"]) == {"collective-permute"}
        assert fusion_rows[n]["collective_bytes"] <= 1.25 * halo, fusion_rows[n]
    assert fusion_rows[4]["collective_bytes"] <= fusion_rows[2]["collective_bytes"] * 1.01
    assert fusion_rows[4]["flops_per_shard"] < 0.6 * fusion_rows[2]["flops_per_shard"]


def test_projected_efficiency_needs_both_rates(fusion_rows):
    r = fusion_rows[2]
    t_c = r["flops_per_shard"] / 10.0e12
    t_m = r["collective_bytes"] / 100.0e9
    assert r["projected_ici_efficiency"] == round(t_c / (t_c + t_m), 4)
    assert fusion_rows[1]["projected_ici_efficiency"] == 1.0
    assert cr._row(2, {"all-reduce": 8}, 1e6, 100.0, None)["projected_ici_efficiency"] is None
    assert cr._row(2, {"all-reduce": 8}, 1e6, None, 10.0)["projected_ici_efficiency"] is None
