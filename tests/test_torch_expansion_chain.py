"""The port's modular SfM chain, tracksBuilding -> sfmBootstraping ->
sfmExpanding, on tests/test_torch_expansion.py's fixture (the JAX
package's synthetic 6-view ring, noise 0.3 px) under
tests/test_modular_pipeline.py's gates: 6 posed views, more than 60
landmarks, camera-centre ATE < 0.05 after a similarity alignment; the JAX
package reads the port's scene.

A file of its own, apart from the policy checks, so that the chain starts
early on its own test worker.
"""

import os

import numpy as np
import torch

from alicevision_tpu import sfmdata as jsfm
from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.pipeline import stages
from test_torch_expansion import N_VIEWS, _ate, setup  # noqa: F401 (setup: a fixture)

torch.set_num_threads(1)


def test_modular_chain_gates(setup):
    d = setup["d"]
    tracks_f = os.path.join(d, "tracks.npz")
    stages.tracks_building(setup["scene"], setup["feats"], setup["matches"], tracks_f, min_track_length=3,
                           device="cpu")
    with np.load(tracks_f) as z:
        assert int(z["n_tracks"]) > 50
    boot_f = os.path.join(d, "boot.sfm")
    stages.sfm_bootstrapping(setup["scene"], setup["feats"], tracks_f, boot_f, device="cpu")
    boot = sfmdata.load(boot_f)
    assert boot.n_poses >= 2 and boot.n_landmarks > 30
    out_f = os.path.join(d, "expanded.sfm")
    stages.sfm_expanding(boot_f, setup["feats"], tracks_f, out_f, device="cpu")
    out = sfmdata.load(out_f)
    assert out.n_poses == N_VIEWS
    assert out.n_landmarks > 60
    assert _ate(out, setup["syn"]) < 0.05
    # the JAX package reads the port's scene
    assert jsfm.load(out_f).n_poses == N_VIEWS
