"""Where the vertical focal of the 8-view arc parts between the engines.

The 8 rendered 1280x960 views of chip_smoke.py's `pipeline` phase give fy
906.5 px in the JAX engine, 982.3 in the port's on the CPU and 1198-1216
on the card (truth 1120) from the port's CPU front end. The fixture
(`tests/golden/focal_parting_tracks.npz`, written by
`scripts/focal_parting.py --write-fixture` from `utils/rendered.py`'s
views through the port's CPU front end) holds the tracks and features of
that front end.

Step by step, every step of the port's engine agrees with the JAX
engine's when both start from the same state (`convert.carry_engine_state`
before each step) and draw the same RANSAC samples (`focal_parting.
DrawRecorder` hands the JAX engine's `sample_minimal` indices to the
port): the initial pair, each resection, triangulation, BA, outlier
removal and the joint intrinsics refine. On its own draws, the port's
engine lands fy more than 8 % from the JAX engine's while fx stays within
2 % (and its seeds 0-3 read fy 982-1256 px at the defaults). So the parting comes from the draws on a weakly observed fy,
a behaviour both packages share (ROADMAP §3). The run uses 64 RANSAC
hypotheses and 3 initial-pair candidates to keep it short;
`scripts/focal_parting.py` reads the defaults (the port fed the JAX
engine's draws: (1158.6, 906.3) px against JAX's (1158.4, 906.5)).
"""

import os
import sys

import numpy as np
import pytest
import torch

from alicevision_tpu_torch import convert

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import focal_parting as fp  # noqa: E402

torch.set_num_threads(1)

CFG = dict(seed=0, n_ransac_hyps=64, init_pair_candidates=3)
STEPS = ("initialize", "triangulate_all", "triangulate_tracks", "bundle_adjust", "remove_outliers",
         "resect_views", "refine_intrinsics_now")


def _returned(x):
    return [int(v) for v in x] if isinstance(x, list) else x


@pytest.fixture(scope="module")
def steps():
    """Each step of the JAX engine's whole run beside the same step of a
    port engine carried from the JAX engine's state just before it."""
    import chip_smoke

    fx = chip_smoke.load_focal_fixture()
    jeng, port = fp.engines(fx, **CFG)
    rec = fp.DrawRecorder().install()
    rows = []

    def wrap(name):
        ref = getattr(jeng, name)

        def step(*args, **kw):
            p = convert.carry_engine_state(jeng, port())
            n_drawn = len(rec.drawn)
            got_j = ref(*args, **kw)
            rec.queue = list(rec.drawn[n_drawn:])
            got_p = getattr(p, name)(*args, **kw)
            rows.append(dict(step=name, posed=int(jeng.res.posed.sum()), jax=jeng, port=p,
                             ret_j=_returned(got_j), ret_p=_returned(got_p), left=len(rec.queue),
                             R=np.array(jeng.res.pose_R), c=np.array(jeng.res.pose_c),
                             X=np.array(jeng.res.points), valid=np.array(jeng.res.point_valid),
                             posed_j=np.array(jeng.res.posed), inl=np.array(jeng.obs_inlier),
                             f=np.array(jeng.intr_np.scale, np.float64)))
            return got_j

        setattr(jeng, name, step)

    try:
        for name in STEPS:
            wrap(name)
        jeng.process()
    finally:
        rec.uninstall()
    return rows, port


def test_every_step_agrees_given_state_and_draws(steps):
    rows, _ = steps
    kinds = {r["step"] for r in rows}
    assert kinds == set(STEPS)
    assert rows[-1]["posed"] == 8 and sum(r["step"] == "refine_intrinsics_now" for r in rows) >= 3
    for i, r in enumerate(rows):
        p = r["port"]
        where = f"step {i} ({r['step']}, {r['posed']} posed)"
        assert r["ret_p"] == r["ret_j"] and r["left"] == 0, where
        np.testing.assert_array_equal(p.res.posed, r["posed_j"], err_msg=where)
        np.testing.assert_array_equal(p.res.point_valid, r["valid"], err_msg=where)
        np.testing.assert_array_equal(p.obs_inlier, r["inl"], err_msg=where)
        posed, ok = r["posed_j"], r["valid"]
        np.testing.assert_allclose(p.res.pose_R[posed], r["R"][posed], atol=1e-4, err_msg=where)
        np.testing.assert_allclose(p.res.pose_c[posed], r["c"][posed], atol=1e-3, err_msg=where)
        np.testing.assert_allclose(p.res.points[ok], r["X"][ok], rtol=1e-3, atol=1e-2, err_msg=where)
        np.testing.assert_allclose(p.intr_np.scale, r["f"], rtol=2e-3, err_msg=where)


def test_the_draws_move_fy(steps):
    """The port's engine on its own draws (seed 0), against the JAX
    engine's run on its draws: fy 8 % or more apart, fx within 2 %, every
    view posed in both."""
    rows, port = steps
    e = port(seed=0)
    e.process()
    assert int(e.res.posed.sum()) == 8
    (fx, fy), (jfx, jfy) = np.asarray(e.intr_np.scale, np.float64).ravel(), rows[-1]["f"].ravel()
    assert abs(fy - jfy) / 1120.0 > 0.08, (fx, fy, jfx, jfy)
    assert abs(fx - jfx) / 1120.0 < 0.02, (fx, fy, jfx, jfy)
