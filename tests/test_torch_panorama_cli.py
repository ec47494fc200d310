"""The port's panorama, image and global-SfM subcommands against the JAX
CLI, on the CPU, each run in this process through both `main`s.

The scene is tests/test_panorama_cli.py's: 6 pinhole views of 256^2 split
from a 256x512 equirect texture (fov 80 deg). Its matches are the
ground-truth projections of 300 directions on the sphere, so that the
rotation engines run without the front end. The rotation engines and the
warp-to-post-processing chain run in tests/test_torch_panorama_chain_cli.py,
relativePoseEstimating and globalSfM in tests/test_torch_global_sfm_cli.py.

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
