"""The port's AKAZE features against the JAX package's, on the CPU.

Two value-noise textures (tests/test_akaze.py's `_texture_image`, numpy
from a seed, 128x160) go through `alicevision_tpu.features.akaze` (jitted
and vmapped, the executable `pipeline/stages.py` builds for the stage, so
the stage test reuses it) and through
`alicevision_tpu_torch.features.akaze.extract` on a (B, H, W) CPU tensor.

Tolerances:
  * the contrast factor k: rtol 1e-5 (float32 blur sums in another order);
  * the scale-space levels: atol 1e-5;
  * keypoints, matched by position as the SIFT tests match them: at least
    0.98 of JAX's valid keypoints have a port keypoint of the same scale
    (rtol 1e-6) within 0.5 px;
  * descriptors of matched keypoints: MSURF within atol 1e-4 on at least
    0.98 of them, MLDB bits equal on at least 0.99 of all bits. The rest
    are keypoints whose 36-bin orientation histogram has two near-equal
    peaks: a float32 sum in another order picks the other peak, and the
    whole descriptor turns with it (one keypoint in ~150 here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.features import akaze as jak
from alicevision_tpu.image import filtering as jfilt
from alicevision_tpu.pipeline import stages as jst
from alicevision_tpu_torch import sfmdata as tsd
from alicevision_tpu_torch.features import akaze as tak
from alicevision_tpu_torch.pipeline import stages as tst
from test_akaze import _texture_image

torch.set_num_threads(1)

WH = (160, 128)
MAX_KP = 384
K_RTOL = 1e-5
LEVEL_ATOL = 1e-5
KP_PX, KP_SHARE = 0.5, 0.98
MSURF_ATOL, MSURF_SHARE = 1e-4, 0.98
MLDB_SHARE = 0.99
DESCRIPTORS = {"akaze": "msurf", "akaze_mldb": "mldb"}


@pytest.fixture(scope="module")
def images():
    return np.stack([np.asarray(_texture_image(WH[1], WH[0], seed=s)) for s in (0, 1)])


def _cfg(desc):
    # the stage's configuration (pipeline/stages.py: max_keypoints and
    # the descriptor, the other fields at their defaults)
    return jak.AkazeConfig(max_keypoints=MAX_KP, descriptor=desc)


@pytest.fixture(scope="module")
def references(images):
    """JAX's features of the two images for each descriptor, through the
    stage's jitted batch extractor (computed once)."""
    return {d: jax.tree_util.tree_map(np.asarray, jst._akaze_extract_batch(_cfg(d))(jnp.asarray(images)))
            for d in DESCRIPTORS.values()}


def test_contrast_factor_and_scale_space(images):
    cfg = jak.AkazeConfig(n_octaves=3)

    def k_of(img):  # the first lines of jak.build_nonlinear_scale_space
        gx, gy = jak._grad(jfilt.gaussian_blur(img, 1.0))
        mag = jnp.sqrt(gx * gx + gy * gy)
        k = jnp.nanpercentile(jnp.where(mag > 0.02 * jnp.max(mag), mag, jnp.nan), cfg.diffusivity_percentile)
        return jnp.where(jnp.isfinite(k), k, 1e-2).clip(1e-4)

    k_j = np.asarray(jax.jit(jax.vmap(k_of))(jnp.asarray(images)))
    oct_j = jax.jit(jax.vmap(lambda im: jak.build_nonlinear_scale_space(im, cfg)[0]))(jnp.asarray(images))
    oct_t, sig_t, steps_t, k_t = tak.build_nonlinear_scale_space(torch.from_numpy(images), tak.AkazeConfig(n_octaves=3))
    np.testing.assert_allclose(k_t.numpy(), k_j, rtol=K_RTOL)
    assert steps_t == [1.0, 2.0, 4.0]
    _, sig_j, _ = jak.build_nonlinear_scale_space(jnp.asarray(images[0]), cfg)
    for a, b in zip(sig_t, sig_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
    for a, b in zip(oct_t, oct_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LEVEL_ATOL)


def _matched(ref, out, g):
    """JAX's valid keypoints of image g, the nearest valid port keypoint of
    the same scale for each (two levels may hold a keypoint at one pixel)
    and its distance."""
    vj = ref.valid[g]
    vt = out.valid[g]
    d = np.linalg.norm(ref.xy[g][vj][:, None] - out.xy[g][vt][None], axis=-1)
    same = np.isclose(ref.scale[g][vj][:, None], out.scale[g][vt][None], rtol=1e-6)
    d = np.where(same, d, np.inf)
    return vj, d.argmin(1), d.min(1)


def _numpy(f):
    return type(f)(*(np.asarray(a) for a in f))


def _hold(ref, out, desc):
    """The keypoint and descriptor tolerances of the module note, over the
    images of a batch."""
    for g in range(len(ref.valid)):
        vj, near, dist = _matched(ref, out, g)
        assert vj.sum() > 50
        assert abs(int(out.valid[g].sum()) - int(vj.sum())) <= max(1, 0.02 * vj.sum())
        ok = dist < KP_PX
        assert ok.mean() >= KP_SHARE, ok.mean()
        dj = ref.desc[g][vj][ok]
        dt = out.desc[g][out.valid[g]][near[ok]]
        if desc == "msurf":
            assert dt.shape[1] == 64
            assert (np.abs(dt - dj).max(1) <= MSURF_ATOL).mean() >= MSURF_SHARE
        else:
            assert dt.shape[1] == tak.MLDB_BITS
            assert (dt == dj).mean() >= MLDB_SHARE


@pytest.mark.parametrize("desc", ["msurf", "mldb"])
def test_keypoints_and_descriptors(images, references, desc):
    out = _numpy(tak.extract(torch.from_numpy(images), tak.AkazeConfig(**_cfg(desc)._asdict())))
    _hold(references[desc], out, desc)
    # one image in, one image's features out
    one = tak.extract(torch.from_numpy(images[1]), tak.AkazeConfig(**_cfg(desc)._asdict()))
    np.testing.assert_array_equal(one.xy.numpy(), out.xy[1])


@pytest.mark.parametrize("describer", ["akaze", "akaze_mldb"])
def test_feature_extraction_akaze_branch(images, references, tmp_path, describer):
    """The stage's AKAZE branch: the same files as the JAX stage's, the
    descriptors float32 (not packed to uint8), the features within the
    tolerances above."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    sc = tsd.SfMData.empty()
    ii = sc.add_intrinsic(1, WH[0], WH[1], 150.0)
    for v in range(len(images)):
        np.save(img_dir / f"{v}.npy", images[v])
        sc.add_view(v + 1, ii, WH[0], WH[1], path=str(img_dir / f"{v}.npy"), frame_id=v)
    sfm = str(tmp_path / "scene.sfm")
    tsd.save(sc, sfm)
    jst.feature_extraction(sfm, str(tmp_path / "fj"), max_keypoints=MAX_KP, downscale_to=0, describer_types=describer)
    tst.feature_extraction(sfm, str(tmp_path / "ft"), max_keypoints=MAX_KP, downscale_to=0, describer_types=describer,
                           device="cpu")
    assert sorted(os.listdir(tmp_path / "ft")) == sorted(os.listdir(tmp_path / "fj")) == ["1.feat.npz", "2.feat.npz"]
    loaded = {}
    for tag in ("fj", "ft"):
        per_view = []
        for v in range(len(images)):
            with np.load(tmp_path / tag / f"{v + 1}.feat.npz") as z:
                assert sorted(z.files) == ["desc", "orientation", "response", "scale", "valid", "xy"]
                assert z["desc"].dtype == np.float32
                per_view.append({k: z[k] for k in z.files})
        loaded[tag] = type(references["msurf"])(
            *(np.stack([p[k] for p in per_view]) for k in ("xy", "scale", "orientation", "response", "desc", "valid")))
    _hold(loaded["fj"], loaded["ft"], DESCRIPTORS[describer])
    ref = references[DESCRIPTORS[describer]]
    np.testing.assert_array_equal(loaded["fj"].xy, ref.xy)
