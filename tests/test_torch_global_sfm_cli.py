"""relativePoseEstimating and globalSfM of the port's CLI, on the CPU.

The scene is a 3-view ring (`utils/synthetic.ring_scene_sfmdata`, 640x480,
focal 500 px) with its ground-truth projections as features and 60
matches a pair, so that the engines run without the front end.
relativePoseEstimating runs in the port alone and is held to the truth
(relative rotations within 0.05 deg, directions within 1e-3): the JAX CLI
compiles its 5-point RANSAC for ~20 s here, and
tests/test_torch_robust.py holds `robust_relative_pose` to the JAX
package's. globalSfM runs through both CLIs on the port's relative poses
(and in the port once more estimating them itself, to the same file):
rotations within 0.05 deg of the JAX CLI's after aligning the gauge and
0.1 deg of the truth, centres within 1 % of the ring's extent of both
after a similarity.
"""

import numpy as np
import torch

from alicevision_tpu.utils.synthetic import ring_scene_sfmdata
from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.pipeline import cli as tcli
from alicevision_tpu_torch.sfm.alignment import umeyama_similarity
from test_torch_panorama_cli import CPU, _both, _write_matches
from test_torch_rotation_sfm import _angle_deg, _gauge_err_deg

torch.set_num_threads(1)


def test_relative_poses_and_global_sfm(tmp_path):
    n = 3
    sc = ring_scene_sfmdata(n_views=n, n_points=120, image_size=(640, 480), focal_px=500.0)
    R_true, c_true = sc.pose_R[sc.view_pose], sc.pose_c[sc.view_pose]
    init = sfmdata.SfMData.empty()
    ii = init.add_intrinsic(1000, 640, 480, 500.0)
    for v in range(n):
        init.add_view(int(sc.view_ids[v]), ii, 640, 480)
    scene = str(tmp_path / "init.sfm")
    sfmdata.save(init, scene)
    xy, ids = {}, {}
    for v in range(n):
        o = sc.obs_view == v
        xy[v], ids[v] = sc.obs_uv[o], sc.obs_landmark[o]
    _write_matches(str(tmp_path), xy, ids, [int(i) for i in sc.view_ids], cap=60)
    feats, matches, rel = str(tmp_path / "feats"), str(tmp_path / "matches.npz"), str(tmp_path / "rel.npz")
    assert tcli.main(["relativePoseEstimating", "--input", scene, "--features", feats, "--matches", matches,
                      "--output", rel, *CPU]) == 0
    with np.load(rel) as z:
        edges, R_rel, dirs, inl = z["edges"], z["R_rel"], z["dirs"], z["inliers"]
    assert edges.tolist() == [[0, 1], [0, 2], [1, 2]] and (inl == 60).all()
    i, j = edges[:, 0], edges[:, 1]
    assert _angle_deg(R_rel, R_true[j] @ np.swapaxes(R_true[i], 1, 2)).max() < 0.05
    d_true = np.einsum("eij,ej->ei", R_true[i], c_true[j] - c_true[i])
    np.testing.assert_allclose(dirs, d_true / np.linalg.norm(d_true, axis=1, keepdims=True), atol=1e-3)

    _both(lambda tag: ["globalSfM", "--input", scene, "--features", feats, "--matches", matches,
                                      "--relativePoses", rel, "--output", str(tmp_path / f"{tag}_global.sfm")])
    # without --relativePoses the port's globalSfM estimates them itself, the same way
    assert tcli.main(["globalSfM", "--input", scene, "--features", feats, "--matches", matches, "--output",
                      str(tmp_path / "self.sfm"), *CPU]) == 0
    assert (tmp_path / "self.sfm").read_bytes() == (tmp_path / "port_global.sfm").read_bytes()
    gj, gt = sfmdata.load(str(tmp_path / "jax_global.sfm")), sfmdata.load(str(tmp_path / "port_global.sfm"))
    assert len(gt.valid_views()) == len(gj.valid_views()) == n and gt.n_landmarks > 50
    Rj, Rt = gj.pose_R[gj.view_pose], gt.pose_R[gt.view_pose]
    assert _gauge_err_deg(Rt, Rj) < 0.05 and _gauge_err_deg(Rt, R_true) < 0.1
    cj, ct = gj.pose_c[gj.view_pose], gt.pose_c[gt.view_pose]
    for ref in (cj, c_true):
        s, R, t = umeyama_similarity(ct, ref)
        assert np.linalg.norm(ct @ (s * R).T + t - ref, axis=1).max() < 0.01 * np.linalg.norm(ref - ref.mean(0),
                                                                                                  axis=1).max()
