"""The port's panorama modules (`panorama/warping.py`, `compositing.py`,
`graphcut_seams.py`) against the JAX package's, on the CPU.

Tolerances: directions, equirect coordinates and warps agree to float32
rounding (1e-5; a warped pixel whose sample position lies within 1e-4 px
of the image border may flip its mask, at most 0.1 % of the pixels);
distance weights, blends and composites to 1e-5 (the port blurs every view
of a stack in one batch, the reference one view at a time); seam labels
exactly, away from ties between two weights within 1e-6; the graph-cut
labels equal on tests/test_graphcut_seams.py's scenes, whose costs come
from the same host numpy and the same max-flow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from alicevision_tpu.image import processing as jproc
from alicevision_tpu.panorama import compositing as jcomp
from alicevision_tpu.panorama import graphcut_seams as jgc
from alicevision_tpu.panorama import warping as jwarp
from alicevision_tpu_torch.panorama import compositing as tcomp
from alicevision_tpu_torch.panorama import graphcut_seams as tgc
from alicevision_tpu_torch.panorama import warping as twarp

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.fixture(scope="module")
def warped_views():
    """tests/test_panorama_cli.py's texture, 4 views of 96^2 warped to a
    256x128 canvas by the JAX package: (warps, masks, pano)."""
    rng = np.random.RandomState(0)
    pano = ndi.gaussian_filter(rng.rand(128, 256).astype(np.float32), 1.5)
    imgs, K, Rs = jproc.split_equirect(jnp.asarray(pano), n_splits=4, fov_deg=100.0, out_size=96)
    ws, ms = [], []
    for i in range(4):
        w, m = jwarp.warp_to_equirect(imgs[i], K, jnp.asarray(Rs[i], jnp.float32), (256, 128))
        ws.append(np.asarray(w))
        ms.append(np.asarray(m))
    return np.stack(ws), np.stack(ms), pano, np.array(imgs), np.array(K), Rs


def test_direction_maps_match():
    rng = np.random.default_rng(0)
    uv = (rng.random((50, 2)) * [512, 256]).astype(np.float32)
    dj = np.asarray(jwarp.equirect_to_direction(jnp.asarray(uv), (512, 256)))
    dt = twarp.equirect_to_direction(torch.from_numpy(uv), (512, 256)).numpy()
    np.testing.assert_allclose(dt, dj, atol=ATOL)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(twarp.direction_to_equirect(torch.from_numpy(d), (512, 256)).numpy(),
                               np.asarray(jwarp.direction_to_equirect(jnp.asarray(d), (512, 256))), atol=1e-3)
    back = twarp.direction_to_equirect(twarp.equirect_to_direction(torch.from_numpy(uv), (512, 256)), (512, 256))
    np.testing.assert_allclose(back.numpy(), uv, atol=2e-3)


@pytest.mark.parametrize("channels", [0, 3])
def test_warp_to_equirect_matches(warped_views, channels):
    _, _, _, imgs, K, Rs = warped_views
    img = imgs[1] if not channels else np.stack([imgs[1], 1 - imgs[1], imgs[1] ** 2], -1)
    wj, mj = jwarp.warp_to_equirect(jnp.asarray(img), jnp.asarray(K), jnp.asarray(Rs[1], jnp.float32), (256, 128))
    wt, mt = twarp.warp_to_equirect(torch.from_numpy(img), torch.from_numpy(K), torch.from_numpy(Rs[1]), (256, 128))
    mj, wj = np.asarray(mj), np.asarray(wj)
    same = mt.numpy() == mj
    assert same.mean() > 0.999 and mt.numpy().sum() > 1000
    both = same & mj
    np.testing.assert_allclose(wt.numpy()[both], wj[both], atol=ATOL)


def test_distance_weights_and_seam_labels_match(warped_views):
    _, masks, *_ = warped_views
    wj = np.asarray(jcomp.distance_weights(jnp.asarray(masks)))
    wt = tcomp.distance_weights(torch.from_numpy(masks)).numpy()
    np.testing.assert_allclose(wt, wj, atol=ATOL)
    lj = np.asarray(jcomp.seam_labels(jnp.asarray(masks)))
    lt = tcomp.seam_labels(torch.from_numpy(masks)).numpy()
    top2 = np.sort(wj, axis=0)[-2:]
    clear = (top2[1] - top2[0]) > 1e-6
    assert lt.dtype == np.int32 and np.array_equal(lt[clear], lj[clear]) and ((lt < 0) == (lj < 0)).all()


def test_composites_match(warped_views):
    warps, masks, pano, *_ = warped_views
    w, m = torch.from_numpy(warps), torch.from_numpy(masks)
    pj = np.asarray(jcomp.composite_panorama(jnp.asarray(warps), jnp.asarray(masks)))
    pt = tcomp.composite_panorama(w, m).numpy()
    np.testing.assert_allclose(pt, pj, atol=ATOL)
    covered = masks.any(0)
    assert np.median(np.abs(pt - pano)[covered]) < 0.06
    labels = np.asarray(jcomp.seam_labels(jnp.asarray(masks)))
    for levels in (3, 5):
        cj = np.asarray(jcomp.composite_with_labels(jnp.asarray(warps), jnp.asarray(labels), jnp.asarray(masks),
                                                    levels=levels))
        ct = tcomp.composite_with_labels(w, torch.from_numpy(labels), m, levels=levels).numpy()
        np.testing.assert_allclose(ct, cj, atol=ATOL)


def test_fill_holes_and_crop_match(warped_views):
    warps, masks, *_ = warped_views
    img = warps[0]
    mask = masks[0]
    fj = np.asarray(jcomp.fill_holes(jnp.asarray(img), jnp.asarray(mask), iters=12))
    ft = tcomp.fill_holes(torch.from_numpy(img), torch.from_numpy(mask), iters=12).numpy()
    # far from the known pixels the diffusion divides by weights near its
    # 1e-6 floor, and the values grow large in both packages: relative there
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=ATOL)
    cj = jcomp.crop_to_content(img, mask)
    ct = tcomp.crop_to_content(img, mask)
    assert cj[2] == ct[2] and np.array_equal(cj[0], ct[0]) and np.array_equal(cj[1], ct[1])
    empty = np.zeros_like(mask)
    assert tcomp.crop_to_content(img, empty)[2] == jcomp.crop_to_content(img, empty)[2] == (0, 128, 0, 256)


def _parallax_pair(H=96, W=160, shift=6, seed=0):
    """tests/test_graphcut_seams.py's two views of a displaced object."""
    rng = np.random.default_rng(seed)
    base = rng.random((H, W + shift)) * 0.2
    img0 = base[:, :W].copy()
    img1 = base[:, shift:].copy()
    y0, x0, s = H // 2 - 12, W // 2 - 20, 24
    img0[y0 : y0 + s, x0 : x0 + s] += 0.8
    img1[y0 : y0 + s, x0 + 10 : x0 + 10 + s] += 0.8
    masks = np.zeros((2, H, W), bool)
    masks[0, :, : W * 2 // 3] = True
    masks[1, :, W // 3 :] = True
    return np.stack([img0, img1]), masks


def _three_views():
    rng = np.random.default_rng(1)
    warped = rng.random((3, 64, 120)) * 0.1
    masks = np.zeros((3, 64, 120), bool)
    masks[0, :, :60] = True
    masks[1, :, 30:90] = True
    masks[2, :, 60:] = True
    return warped, masks


@pytest.mark.parametrize("scene", ["parallax", "three_views"])
def test_graphcut_seam_labels_match(scene):
    warped, masks = _parallax_pair() if scene == "parallax" else _three_views()
    lj = jgc.graphcut_seam_labels(warped, masks, sweeps=2)
    lt = tgc.graphcut_seam_labels(warped, masks, sweeps=2, device="cpu")
    assert lt.dtype == np.int32 and np.array_equal(lt, lj)
    assert np.all((lt >= 0) == masks.any(axis=0))
    assert tgc.seam_cost(warped, lt) == jgc.seam_cost(warped, lj)
    if scene == "parallax":
        wta = tcomp.seam_labels(torch.from_numpy(masks)).numpy()
        assert tgc.seam_cost(warped, lt) < 0.7 * tgc.seam_cost(warped, wta)
