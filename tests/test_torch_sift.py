"""The port's SIFT extraction (and the filtering it uses) against the JAX
reference, on the CPU.

The same rendered images (`alicevision_tpu.utils.rendered.render_views`,
numpy) go through `alicevision_tpu.features.sift` (jitted and vmapped over
the batch, as `pipeline/stages.py` runs it) and through
`alicevision_tpu_torch.features.sift.extract` with a (B, H, W) CPU tensor.
The JAX reference is computed once per configuration.

Keypoints are matched by position: float32 sums in another order move the
sub-pixel refinement by ~1e-4 px, so a few candidates near a threshold may
differ, and the test holds 98 % of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.features import sift as jsift
from alicevision_tpu.image import filtering as jfilt
from alicevision_tpu.utils.rendered import render_views
from alicevision_tpu_torch import convert
from alicevision_tpu_torch.features import sift as tsift
from alicevision_tpu_torch.image import filtering as tfilt

torch.set_num_threads(1)

CFG = dict(max_keypoints=384, n_octaves=3)


@pytest.fixture(scope="module")
def images():
    imgs, *_ = render_views(2, (160, 128), focal_px=150.0)
    return imgs  # (2, 128, 160)


@pytest.fixture(scope="module")
def references(images):
    """JAX's features of the batch, plain and DSP, computed once."""
    out = {}
    for dsp in (False, True):
        cfg = jsift.SiftConfig(dsp=dsp, **CFG)
        f = jax.jit(jax.vmap(lambda im: jsift.extract(im, cfg)))(jnp.asarray(images))
        out[dsp] = jax.tree_util.tree_map(np.asarray, f)
    return out


def test_filtering_helpers(images):
    img = images[0]
    np.testing.assert_array_equal(tfilt.downsample2(torch.from_numpy(img)).numpy(), np.asarray(jfilt.downsample2(img)))
    np.testing.assert_allclose(
        tfilt.upsample2(torch.from_numpy(images)).numpy(), np.asarray(jfilt.upsample2(jnp.asarray(images))),
        rtol=1e-6, atol=1e-6,
    )
    for a, b in zip(tfilt.gradients(torch.from_numpy(img)), jfilt.gradients(jnp.asarray(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


@pytest.mark.parametrize("first_octave", [0, -1])
def test_scale_space(images, first_octave):
    cfg = jsift.SiftConfig(first_octave=first_octave, **CFG)
    oct_j = jax.jit(lambda im: jsift.build_scale_space(im, cfg)[0])(jnp.asarray(images[0]))
    oct_t, steps_t = tsift.build_scale_space(torch.from_numpy(images), tsift.SiftConfig(**cfg._asdict()))
    assert steps_t == [2.0 ** (o + first_octave) for o in range(cfg.n_octaves)]
    for a, b in zip(oct_t, oct_j):
        assert a.shape[1:] == b.shape
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-5)


def _match_keypoints(ref, out, g):
    """For image g: JAX's valid keypoints, and the index of the nearest
    valid port keypoint for each with the distance."""
    vj = ref.valid[g]
    vt = out.valid[g].numpy()
    xy_t = out.xy[g].numpy()[vt]
    d = np.linalg.norm(ref.xy[g][vj][:, None] - xy_t[None], axis=-1)
    return vj, vt, d.argmin(1), d.min(1)


@pytest.mark.parametrize("dsp", [False, True])
def test_extract_matches_reference(images, references, dsp):
    ref = references[dsp]
    cfg = convert.sift_config_from_reference(jsift.SiftConfig(dsp=dsp, **CFG)._asdict())
    out = tsift.extract(torch.from_numpy(images), cfg)
    assert out.xy.shape == (2, 384, 2) and out.desc.shape == (2, 384, 128)
    for g in range(2):
        vj, vt, near, dist = _match_keypoints(ref, out, g)
        n_j, n_t = int(vj.sum()), int(vt.sum())
        assert n_j >= 30
        assert abs(n_t - n_j) <= max(1, 0.02 * n_j)
        sc_j, sc_t = ref.scale[g][vj], out.scale[g].numpy()[vt][near]
        ori_j, ori_t = ref.orientation[g][vj], out.orientation[g].numpy()[vt][near]
        dori = np.abs(np.angle(np.exp(1j * (ori_t - ori_j))))
        same = (dist < 0.01) & (np.abs(sc_t - sc_j) <= 1e-4 * sc_j) & (dori < 1e-3)
        assert same.mean() >= 0.98, (same.mean(), dist.max())
        dd = np.abs(out.desc[g].numpy()[vt][near] - ref.desc[g][vj])[same].max(axis=1)
        if dsp:
            # DSP samples its pooled patches at the nearest pixel (as the
            # reference does): positions ~1e-4 px and orientations ~1e-5
            # rad apart move a tap across a pixel edge now and then, and
            # that keypoint's descriptor moves by up to ~6e-3.
            assert (dd < 1e-4).mean() >= 0.75 and dd.max() < 2e-2, np.sort(dd)[-5:]
        else:
            assert dd.max() < 1e-4
        np.testing.assert_allclose(np.linalg.norm(out.desc[g].numpy()[vt], axis=-1), 1.0, atol=1e-3)


def test_extract_single_image_equals_batch(images):
    cfg = tsift.SiftConfig(**CFG)
    one = tsift.extract(torch.from_numpy(images[1]), cfg)
    both = tsift.extract(torch.from_numpy(images), cfg)
    v = one.valid.numpy()
    np.testing.assert_array_equal(v, both.valid[1].numpy())
    np.testing.assert_allclose(one.xy.numpy()[v], both.xy[1].numpy()[v], atol=1e-5)
    np.testing.assert_allclose(one.desc.numpy()[v], both.desc[1].numpy()[v], atol=1e-5)


def test_quantize_desc_exact():
    rng = np.random.RandomState(0)
    d = np.concatenate([rng.rand(1000).astype(np.float32) * 0.6, [0.0, 0.498, 0.5, 0.7, -0.1]]).astype(np.float32)
    np.testing.assert_array_equal(tsift.quantize_desc(torch.from_numpy(d)).numpy(), np.asarray(jsift.quantize_desc(d)))
