"""The port's photometric stereo, lighting, light calibration, sphere
detection and colour-chart modules (`photometric/*`,
`misc/{sphere_detection,color_checker}`) against the JAX reference on the
CPU.

Inputs follow tests/test_{aux_modules,cli_ext3,color_checker,
merge_distortion_sphere}.py, seeded: a sphere cap and a relief under known
lights (`utils/calibration_scenes.py`), a glossy sphere with a highlight,
the 24-patch chart under a gain and an offset. Tolerances: normals and
albedo 1e-5; the CG depth 1e-4 of its range (both run 400 float32 steps
under the same stopping rule); SH lighting by the shading it renders (the
port forms its 9x9 normal equations in float64, the reference in float32,
so the port's fit may only be better); light directions 1e-6; the host
copies (sphere Hough voting, the chart) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu.misc import color_checker as jcc
from alicevision_tpu.misc import sphere_detection as jsd
from alicevision_tpu.photometric import light_calibration as jlc
from alicevision_tpu.photometric import lighting as jlt
from alicevision_tpu.photometric import stereo as jst
from alicevision_tpu_torch.misc import color_checker as cc
from alicevision_tpu_torch.misc import sphere_detection as sd
from alicevision_tpu_torch.photometric import light_calibration as lc
from alicevision_tpu_torch.photometric import lighting as lt
from alicevision_tpu_torch.photometric import stereo as st
from alicevision_tpu_torch.utils import calibration_scenes as cs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shoot():
    return cs.render_photometric(wh=(96, 72), n_lights=8, sphere_r=24.0, seed=3)


def test_photometric_stereo_matches(shoot):
    imgs, L = shoot["object"], shoot["lights"].astype(np.float32)
    mask = np.ones(imgs.shape[1:], bool)
    mask[:4] = False
    for kw in ({}, {"light_intensities": np.linspace(0.8, 1.2, len(L)).astype(np.float32), "mask": mask}):
        got = st.photometric_stereo(torch.as_tensor(imgs), torch.as_tensor(L),
                                    **{k: torch.as_tensor(v) for k, v in kw.items()})
        want = jst.photometric_stereo(jnp.asarray(imgs), jnp.asarray(L), **{k: jnp.asarray(v) for k, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        if not kw:  # rendered at unit intensities
            err = np.degrees(np.arccos(np.clip((got[0].numpy() * shoot["normals"]).sum(-1), -1, 1)))
            assert np.median(err) < 1.0


@pytest.mark.parametrize("case", ["relief", "ramp"])
def test_normal_integration_matches(shoot, case):
    if case == "relief":
        n = shoot["normals"].astype(np.float32)
    else:  # tests/test_aux_modules.py's flat slope: a boundary flux the cosine shortcut loses
        n = np.broadcast_to(np.array([0.2, -0.1, -1.0]) / np.linalg.norm([0.2, -0.1, -1.0]), (40, 56, 3))
        n = np.ascontiguousarray(n, np.float32)
    got = st.normal_integration_dct(torch.as_tensor(n)).numpy()
    want = np.asarray(jst.normal_integration_dct(jnp.asarray(n)))
    assert np.abs(got - want).max() < 1e-4 * np.ptp(want)
    assert abs(got.mean()) < 1e-4


def test_sh_lighting_matches(shoot):
    """tests/test_aux_modules.py's round trip: render with known SH, fit."""
    n = torch.as_tensor(shoot["normals"], dtype=torch.float32)
    Lsh = np.zeros(9, np.float32)
    Lsh[[0, 1, 3]] = [0.5, 0.2, -0.4]
    np.testing.assert_allclose(lt.augmented_normals(n).numpy(), np.asarray(jlt.augmented_normals(jnp.asarray(
        n.numpy()))), atol=1e-7)
    shade = lt.render_sh(n, torch.as_tensor(Lsh))
    np.testing.assert_allclose(shade.numpy(), np.asarray(jlt.render_sh(jnp.asarray(n.numpy()), jnp.asarray(Lsh))),
                               atol=1e-6)
    albedo = torch.as_tensor(shoot["albedo"], dtype=torch.float32)
    img = shoot["object"][0]
    for kw in ({}, {"albedo": albedo}, {"albedo": albedo, "mask": torch.as_tensor(shoot["depth"] > 0)}):
        got = lt.estimate_sh_lighting(torch.as_tensor(img), n, **kw)
        want = jlt.estimate_sh_lighting(jnp.asarray(img), jnp.asarray(n.numpy()),
                                        **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
        a = kw["albedo"].numpy() if "albedo" in kw else 1.0
        res = [np.abs(lt.render_sh(n.double(), torch.as_tensor(np.asarray(s), dtype=torch.float64)).numpy() * a
                      - img).mean() for s in (got, want)]
        assert res[0] <= res[1] * 1.01 + 1e-7, res
    # tests/test_cli_ext3.py's sphere cap: normals spread enough that the
    # coefficients themselves are held (a relief's narrow cone is not)
    ys, xs = np.mgrid[0:24, 0:24]
    cap = np.stack([(xs - 12) / 12 * 0.6, (ys - 12) / 12 * 0.6, np.zeros((24, 24))], -1)
    cap[..., 2] = -np.sqrt(np.clip(1 - cap[..., 0] ** 2 - cap[..., 1] ** 2, 0.05, 1))
    cap = torch.as_tensor(cap / np.linalg.norm(cap, axis=-1, keepdims=True), dtype=torch.float32)
    shade = lt.render_sh(cap, torch.as_tensor(Lsh))
    got = lt.estimate_sh_lighting(shade, cap)
    want = jlt.estimate_sh_lighting(jnp.asarray(shade.numpy()), jnp.asarray(cap.numpy()))
    np.testing.assert_allclose(got.numpy()[[0, 1, 3]], np.asarray(want)[[0, 1, 3]], atol=2e-3)


def test_light_calibration_and_sphere_detection_match(shoot, tmp_path):
    cx, cy, r = shoot["sphere_cxr"]
    sphere = shoot["sphere"]
    det = sd.detect_sphere(sphere[0], r_min=12, r_max=36)
    assert det == jsd.detect_sphere(sphere[0], r_min=12, r_max=36)
    assert np.array_equal(sd.sphere_mask(sphere.shape[1:], cx, cy, r), jsd.sphere_mask(sphere.shape[1:], cx, cy, r))
    got = lc.calibrate_lights(sphere, (cx, cy, r), device="cpu")
    want = jlc.calibrate_lights(sphere, (cx, cy, r))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(lc.sphere_normal_at(cx, cy, r, 30.0, 40.0), jlc.sphere_normal_at(cx, cy, r, 30.0, 40.0))
    # the ONNX route: a 1x1 conv + sigmoid scorer of the bright sphere over the grey image
    from alicevision_tpu_torch.utils.onnx_rt import make_model, make_node

    data = make_model([make_node("Conv", ["x", "w", "b"], ["d"], kernel_shape=[1, 1]),
                       make_node("Sigmoid", ["d"], ["y"])], [("x", (1, 1) + sphere.shape[1:])],
                      [("y", (1, 1) + sphere.shape[1:])],
                      {"w": np.full((1, 1, 1, 1), 40.0, np.float32), "b": np.asarray([-40.0 * float(
                          np.median(sphere[0]))], np.float32)})
    model = str(tmp_path / "sphere.onnx")
    with open(model, "wb") as f:
        f.write(data)
    got = sd.detect_sphere_onnx(sphere[0], model, threshold=0.5, device="cpu")
    want = jsd.detect_sphere_onnx(sphere[0], model, threshold=0.5)
    assert got is not None and want is not None
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.hypot(got[0] - cx, got[1] - cy) < 0.25 * r


def test_color_checker_matches():
    img, centres = cs.render_chart(wh=(400, 260), patch=40, gap=10)
    got, want = cc.detect_color_checker(img), jcc.detect_color_checker(img)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.median(np.linalg.norm(got[0] - centres, axis=-1)) < 2.0
    M = cc.color_correction_matrix(got[1])
    assert np.array_equal(M, jcc.color_correction_matrix(want[1]))
    assert np.array_equal(cc.apply_color_correction(img, M), jcc.apply_color_correction(img, M))
