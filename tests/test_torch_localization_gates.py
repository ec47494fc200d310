"""chip_smoke.py's localization gates against what they are set from: the
K-draw count gates against the JAX package's draws on card reconstructions
(scripts/localization_gates_reference.py on
scripts/localization_k_draw_readings.json), and the rig tolerances against
the reconstruction's camera tilt."""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "localization_gates_reference", os.path.join(ROOT, "scripts", "localization_gates_reference.py"))
gates_ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gates_ref)

with open(gates_ref.READINGS) as _fh:
    READINGS = json.load(_fh)

K = chip_smoke.LOC_SWEEP_SEEDS
GATES = chip_smoke.LOC_GATES["localized_k"]
TRIALS = 20000


def test_gate_script_reads_the_sweep_runs():
    assert gates_ref.RUNS == chip_smoke.LOC_SWEEP_RUNS
    assert set(GATES) == set(chip_smoke.LOC_SWEEP_RUNS)


@pytest.mark.parametrize("run", chip_smoke.LOC_SWEEP_RUNS)
def test_k_draw_gate_is_set_from_jax_readings(run):
    assert GATES[run] == gates_ref.k_draw_gates(READINGS, K, chip_smoke.LOC_K_ALPHA)[run]


@pytest.mark.parametrize("run", chip_smoke.LOC_SWEEP_RUNS)
def test_k_draw_gate_passes_jax_runs(run):
    """Runs drawn from JAX's own readings (a reconstruction, then K of its
    draws) fall under the gate about as rarely as the model says."""
    draws = gates_ref.jax_draws(READINGS, run)
    under = gates_ref.under(draws, K, GATES[run], 1.0, TRIALS, np.random.default_rng(1))
    assert under <= 3 * chip_smoke.LOC_K_ALPHA, (run, under)


@pytest.mark.parametrize("run", ("voctree_full", "voctree_crop", "direct_2x"))
def test_k_draw_gate_catches_a_tree_that_loses_half(run):
    """Each right query kept with probability 1/2: most runs fall under."""
    draws = gates_ref.jax_draws(READINGS, run)
    under = gates_ref.under(draws, K, GATES[run], 0.5, TRIALS, np.random.default_rng(2))
    assert under >= 0.8, (run, under)


def test_gate_model_on_known_draws():
    """Two reconstructions whose draws read 3 or 4 alike: no spread between
    them, the quantile from the draws' own; a single draw of 2 sets the
    floor at 2K where the quantile is lower."""
    draws = [np.array([3.0, 4.0] * 8), np.array([4.0, 3.0] * 8)]
    f = gates_ref.fit(draws)
    assert f["mu"] == 3.5 and f["sb"] == 0.0 and f["fewest"] == 3
    np.testing.assert_allclose(f["sw"], np.sqrt(0.25 * 16 / 15))
    assert gates_ref.gate(f, 4, 1e-3) == 12  # 14 - 3.09 sqrt(4 * 0.267) = 10.8, under 4 x 3
    f = gates_ref.fit([np.array([3.0, 4.0] * 8), np.array([2.0] + [5.0] * 15)])
    assert f["fewest"] == 2 and gates_ref.gate(f, 32, 1e-3) == max(64, gates_ref.gate(dict(f, fewest=0), 32, 1e-3))


@pytest.mark.parametrize("tilt, scale", [(0.0, 1.0), (1.5, 1.0), (2.8, 1.0), (4.2, 1.5), (5.6, 2.0)])
def test_rig_tolerances_follow_the_tilt(tilt, scale):
    g = chip_smoke.LOC_GATES
    rot, cen = chip_smoke.rig_tolerances(tilt)
    np.testing.assert_allclose([rot, cen], [g["rig_rot_deg"] * scale, g["rig_centre_frac"] * scale])
