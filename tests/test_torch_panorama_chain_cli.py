"""The HDR panorama chain's rotation engines and its warp, composite,
seams, merge and post-processing subcommands through both CLIs on the CPU,
on tests/test_torch_panorama_cli.py's 6-view scene (its fixture and
tolerances).

A file of its own, apart from the side commands, so that the two long
chains start early on their own test worker.
"""

import os

import imageio.v2 as imageio
import numpy as np
import torch

from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.pipeline import cli as tcli
from test_torch_panorama_cli import CPU, _both, _png_close, pano  # noqa: F401 (pano: a fixture)
from test_torch_rotation_sfm import _gauge_err_deg

torch.set_num_threads(1)


def test_rotation_engines_match(pano):
    d, scene, _, R_true = pano

    def argv(cmd, tag):
        return [cmd, "--input", scene, "--features", os.path.join(d, "feats"), "--matches",
                os.path.join(d, "matches.npz"), "--output", os.path.join(d, f"{tag}_{cmd}.sfm")]

    _both(lambda tag: argv("panoramaEstimation", tag))
    Rj = sfmdata.load(os.path.join(d, "jax_panoramaEstimation.sfm")).pose_R
    Rt = sfmdata.load(os.path.join(d, "port_panoramaEstimation.sfm")).pose_R
    assert len(Rt) == 6 and _gauge_err_deg(Rt, Rj) < 0.05 and _gauge_err_deg(Rt, R_true) < 0.1
    # nodalSfM is the same engine in both packages: the port's, with the
    # same seed, writes the same file
    assert tcli.main([*argv("nodalSfM", "port"), *CPU]) == 0
    with open(os.path.join(d, "port_panoramaEstimation.sfm")) as a, open(os.path.join(d, "port_nodalSfM.sfm")) as b:
        assert a.read() == b.read()


def test_warp_composite_seams_merge_post(pano):
    d, scene, pano_gt, _ = pano
    _both(lambda tag: ["panoramaWarping", "--input", scene, "--output", os.path.join(d, f"{tag}_warp"),
                          "--panoWidth", "512"])
    names = sorted(os.listdir(os.path.join(d, "jax_warp")))
    assert names == sorted(os.listdir(os.path.join(d, "port_warp"))) and len(names) == 12
    for f in (n for n in names if n.endswith("_mask.npy")):
        (mj, wj), (mt, wt) = ([np.load(os.path.join(d, f"{tag}_warp", g)) for g in (f, f.replace("_mask", "_warp"))]
                              for tag in ("jax", "port"))
        assert mj.dtype == mt.dtype == bool and wj.dtype == wt.dtype and wt.shape == mt.shape == (256, 512)
        same = mj == mt
        assert same.mean() > 0.999
        np.testing.assert_allclose(wt[same], wj[same], atol=1e-5)
    warp = os.path.join(d, "port_warp")  # both CLIs compose the same warps
    _both(lambda tag: ["panoramaCompositing", "--input", warp, "--output", os.path.join(d, f"{tag}_comp.png")])
    _png_close(os.path.join(d, "jax_comp.png"), os.path.join(d, "port_comp.png"))
    pano_img = imageio.imread(os.path.join(d, "port_comp.png")) / 255.0
    band = np.zeros_like(pano_img, bool)
    band[91:166] = True
    assert np.median(np.abs(pano_img - pano_gt)[band & (pano_img > 0)]) < 0.06

    _both(lambda tag: ["panoramaSeams", "--input", warp, "--output", os.path.join(d, f"{tag}_seams.npz")])
    with np.load(os.path.join(d, "jax_seams.npz")) as zj, np.load(os.path.join(d, "port_seams.npz")) as zt:
        assert np.array_equal(zj["views"], zt["views"]) and zt["labels"].dtype == np.int32
        assert (zj["labels"] == zt["labels"]).mean() > 0.999
    # without seams panoramaMerging is panoramaCompositing's blend in both packages
    assert tcli.main(["panoramaMerging", "--input", warp, "--output", os.path.join(d, "port_blend.png"), *CPU]) == 0
    _png_close(os.path.join(d, "jax_comp.png"), os.path.join(d, "port_blend.png"))
    seams = os.path.join(d, "port_seams.npz")
    _both(lambda tag: ["panoramaMerging", "--input", warp, "--output", os.path.join(d, f"{tag}_merge.png"),
                          "--seams", seams, "--levels", "4"])
    _png_close(os.path.join(d, "jax_merge.png"), os.path.join(d, "port_merge.png"))
    _both(lambda tag: ["panoramaPostProcessing", "--input", os.path.join(d, "port_merge.png"), "--output",
                          os.path.join(d, f"{tag}_post.png"), "--fillHoles", "--crop"])
    _png_close(os.path.join(d, "jax_post.png"), os.path.join(d, "port_post.png"))
    _both(lambda tag: ["panoramaPostProcessing", "--input", os.path.join(d, "port_merge.png"), "--output",
                          os.path.join(d, f"{tag}_crop.png"), "--crop"])
    _png_close(os.path.join(d, "jax_crop.png"), os.path.join(d, "port_crop.png"))
