"""The port's panorama, image and global-SfM subcommands against the JAX
CLI, on the CPU, each run in this process through both `main`s.

The scene is tests/test_panorama_cli.py's: 6 pinhole views of 256^2 split
from a 256x512 equirect texture (fov 80 deg). Its matches are the
ground-truth projections of 300 directions on the sphere, so that the
rotation engines run without the front end. relativePoseEstimating and
globalSfM are in tests/test_torch_global_sfm_cli.py.

Tolerances, stated per output:
- host-only outputs are byte-equal (panoramaInit's .sfm) or, for 8-bit
  PNGs that the two packages encode with different codecs, equal pixel
  for pixel (panoramaPrepareImages);
- device outputs: warps within 1e-5 (a mask may flip where a sample lies
  within 1e-4 px of the image border, at most 0.1 % of the pixels); PNGs
  of the composites, merges, post-processing and split views within one
  8-bit level; seam labels equal away from ties; imageProcessing's .npy
  within 1e-5;
- RANSAC outputs (the port draws its own samples): rotations within 0.05
  deg of the JAX CLI's after aligning the gauge, and within 0.1 deg of the
  truth.
"""

import os

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from alicevision_tpu.image.processing import split_equirect
from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu_torch import sfmdata
from alicevision_tpu_torch.image.io import write_image
from alicevision_tpu_torch.pipeline import cli as tcli
from test_image_cache_dcp import _DCP_XML
from test_localba_lcp_feeds import _LCP_SAMPLE
from test_torch_rotation_sfm import _gauge_err_deg

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
RUNS = (("jax", jcli.main, []), ("port", tcli.main, CPU))


def _both(make_argv):
    """Run `make_argv(tag)` through both CLIs; assert both exit 0."""
    for tag, main, extra in RUNS:
        assert main([*make_argv(tag), *extra]) == 0, tag


def _write_matches(folder, xy_by_view, ids_by_view, view_ids, cap=None):
    """Features (.feat.npz with xy and zero descriptors) and the matches of
    every pair of views that share >= 8 point ids, the first `cap` of each
    (one shape for every pair: the JAX engine compiles once)."""
    os.makedirs(os.path.join(folder, "feats"), exist_ok=True)
    for v, xy in xy_by_view.items():
        np.savez_compressed(os.path.join(folder, "feats", f"{view_ids[v]}.feat.npz"), xy=xy.astype(np.float32),
                            desc=np.zeros((len(xy), 128), np.float32))
    out = {}
    views = sorted(xy_by_view)
    for a, i in enumerate(views):
        for j in views[a + 1:]:
            common, ia, ja = np.intersect1d(ids_by_view[i], ids_by_view[j], return_indices=True)
            if len(common) >= 8:
                out[f"{i}_{j}"] = np.stack([ia, ja], 1).astype(np.int32)[:cap]
    np.savez_compressed(os.path.join(folder, "matches.npz"), **out)


@pytest.fixture(scope="module")
def pano(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pano_cli"))
    rng = np.random.RandomState(0)
    pano_gt = ndi.gaussian_filter(rng.rand(256, 512).astype(np.float32), 1.5)
    imgs, K, Rs = split_equirect(jnp.asarray(pano_gt), n_splits=6, fov_deg=80.0, out_size=256)
    imgs, K = np.asarray(imgs), np.asarray(K, np.float64)
    img_dir = os.path.join(d, "imgs")
    os.makedirs(img_dir)
    sc = sfmdata.SfMData.empty()
    ii = sc.add_intrinsic(1, 256, 256, float(K[0, 0]))
    dirs = np.random.default_rng(1).normal(size=(300, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    xy_by_view, ids_by_view = {}, {}
    for i in range(6):
        p = os.path.join(img_dir, f"v{i}.png")
        write_image(p, imgs[i])
        vi = sc.add_view(10 + i, ii, 256, 256, path=p)
        sc.set_pose(vi, Rs[i].astype(np.float64), np.zeros(3))
        cam = dirs @ Rs[i].T.astype(np.float64)
        uv = cam[:, :2] / np.maximum(cam[:, 2:], 1e-9) * K[0, 0] + K[0, 2]
        ok = (cam[:, 2] > 0.1) & (uv >= 1).all(1) & (uv <= 254).all(1)
        xy_by_view[i], ids_by_view[i] = uv[ok], np.nonzero(ok)[0]
    scene = os.path.join(d, "rot.sfm")
    sfmdata.save(sc, scene)
    _write_matches(d, xy_by_view, ids_by_view, [10 + i for i in range(6)], cap=24)
    return d, scene, pano_gt, np.asarray(Rs, np.float64)


def _png_close(a, b):
    """Two 8-bit PNGs within one level (read by imageio: the port's reader
    unfilters imageio's adaptive rows in Python, ~0.35 s an image here)."""
    x, y = imageio.imread(a).astype(np.int32), imageio.imread(b).astype(np.int32)
    assert x.shape == y.shape and np.abs(x - y).max() <= 1, (a, np.abs(x - y).max())


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


def test_prepare_init_split(pano, tmp_path):
    d, _, pano_gt, _ = pano
    imgs = os.path.join(d, "imgs")
    _both(lambda tag: ["panoramaPrepareImages", "--inputFolder", imgs, "--output", str(tmp_path / f"{tag}_prep"),
                          "--downscaleTo", "100"])
    for f in sorted(os.listdir(tmp_path / "jax_prep")):
        a, b = imageio.imread(tmp_path / "jax_prep" / f), imageio.imread(tmp_path / "port_prep" / f)
        assert a.shape == (86, 86) and np.array_equal(a, b)
    for extra in ([], ["--fisheye", "--nbViewsPerRow", "3"]):
        _both(lambda tag: ["panoramaInit", "--imageFolder", imgs, "--output", str(tmp_path / f"{tag}_init.sfm"),
                              "--defaultFocalPx", "150", *extra])
        assert (tmp_path / "jax_init.sfm").read_bytes() == (tmp_path / "port_init.sfm").read_bytes()
    equi = str(tmp_path / "equi.png")
    write_image(equi, np.stack([pano_gt] * 3, -1))
    _both(lambda tag: ["split360Images", "--input", equi, "--output", str(tmp_path / f"{tag}_split"),
                          "--nbSplits", "3", "--fov", "70", "--outSize", "64"])
    for i in range(3):
        _png_close(str(tmp_path / "jax_split" / f"split_{i:02d}.png"), str(tmp_path / "port_split" / f"split_{i:02d}.png"))
    with np.load(tmp_path / "jax_split" / "cameras.npz") as zj, np.load(tmp_path / "port_split" / "cameras.npz") as zt:
        np.testing.assert_allclose(zt["K"], zj["K"], rtol=1e-6)
        np.testing.assert_allclose(zt["R"], zj["R"], atol=1e-6)


@pytest.mark.parametrize("opts", [
    ["--scale", "0.5", "--sharpen", "1.0", "--contrast", "1.3", "--inputColorSpace", "srgb",
     "--outputColorSpace", "acescg"],
    ["--denoise", "--outputColorSpace", "lab"],
    ["--lcp", "LCP", "--focalMm", "30", "--dcp", "DCP", "--cct", "4500"],
])
def test_image_processing_matches(tmp_path, opts):
    img = np.random.default_rng(1).uniform(0, 1, (40, 56, 3)).astype(np.float32)
    src = str(tmp_path / "in.npy")
    np.save(src, img)
    (tmp_path / "lens.lcp").write_text(_LCP_SAMPLE)
    (tmp_path / "cam.dcpxml").write_text(_DCP_XML)
    opts = [str(tmp_path / "lens.lcp") if o == "LCP" else str(tmp_path / "cam.dcpxml") if o == "DCP" else o
            for o in opts]
    _both(lambda tag: ["imageProcessing", "--input", src, "--output", str(tmp_path / f"{tag}.npy"),
                                      *opts])
    a, b = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-5 * max(1.0, np.abs(a).max()))
