"""The port's HDR calibration and merge (`hdr/`) against the JAX package's,
on the CPU.

Tolerances: the curves, Laguerre phi and merged radiance agree to float32
rounding (1e-5); the Grossberg coefficients to 5e-4 of their scale (a
near-collinear basis) and the response they give to 2e-5.
Debevec's g comes from float32 normal equations with a 1e-8 ridge, which
leave the levels no sample reaches set by the smoothness term alone: there
the two float32 solves part by up to ~0.2 (the float64 solve sits within
0.01 of the port's), so g is held within 5e-3 at the levels the samples
use, and the radiance each g merges within 1 % at the median. The CLI
trio (tests/test_hdr.py's scene) writes the JAX CLI's samples exactly,
the same phi, a Grossberg response within 1e-4 (its 3-bracket fit is the
worse conditioned) and merged images within 1 % at the median.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alicevision_tpu import hdr as jhdr
from alicevision_tpu.hdr import calibration as jcal
from alicevision_tpu.hdr import merge as jmerge
from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu_torch import hdr as thdr
from alicevision_tpu_torch.hdr import calibration as tcal
from alicevision_tpu_torch.hdr import merge as tmerge
from alicevision_tpu_torch.pipeline import cli as tcli

torch.set_num_threads(1)

PHI_GT = 0.3
DEBEVEC_G_ATOL = 5e-3


def _brackets(phi=PHI_GT, B=5, H=32, W=48, seed=0):
    """tests/test_hdr.py's scene: radiance through a Laguerre response."""
    rng = np.random.RandomState(seed)
    E = rng.rand(H, W).astype(np.float32) * 2.0 + 0.01
    exposures = np.array([1 / 16, 1 / 4, 1.0, 4.0, 16.0][:B], np.float32) * 0.25
    imgs = [np.asarray(jhdr.laguerre_apply(jnp.asarray(phi), jnp.asarray(np.clip(E * dt, 0, 1)))) for dt in exposures]
    return np.stack(imgs), exposures, E


@pytest.fixture(scope="module")
def ref():
    """The scene, its samples, and the JAX calibrations, jitted, once."""
    imgs, ex, E = _brackets()
    idx = jhdr.sample_bracket_pixels(imgs, 500)
    s = imgs.reshape(len(imgs), -1)[:, idx]
    sj, ej = jnp.asarray(s), jnp.asarray(ex)
    return {
        "imgs": imgs, "ex": ex, "E": E, "idx": idx, "s": s,
        "phi": np.array(jax.jit(jhdr.laguerre_calibrate)(sj, ej)),
        "coeffs": np.array(jax.jit(jhdr.grossberg_calibrate)(sj, ej)),
        "g": np.array(jax.jit(jhdr.debevec_calibrate)(sj[:3, :300], ej[:3]).g),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def test_emor_tables_equal():
    jf0, jh = jcal.emor_tables()
    tf0, th = tcal.emor_tables()
    assert np.array_equal(jf0, tf0) and np.array_equal(jh, th) and th.shape == (25, 1024)


def test_curves_and_weights_match():
    v = np.linspace(-0.05, 1.05, 203).astype(np.float32)
    c = np.random.default_rng(0).normal(size=6).astype(np.float32) * 0.1
    for jf, tf in ((jcal.weight_triangle, tcal.weight_triangle), (jcal.weight_gaussian, tcal.weight_gaussian)):
        np.testing.assert_allclose(tf(_t(v)).numpy(), np.asarray(jf(jnp.asarray(v))), atol=1e-6)
    for phi in (-0.5, 0.0, 0.4):
        np.testing.assert_allclose(tcal.laguerre_apply(phi, _t(v)).numpy(),
                                   np.asarray(jcal.laguerre_apply(jnp.asarray(phi), jnp.asarray(v))), atol=1e-6)
        np.testing.assert_allclose(tcal.laguerre_inverse(phi, _t(v)).numpy(),
                                   np.asarray(jcal.laguerre_inverse(jnp.asarray(phi), jnp.asarray(v))), atol=1e-6)
    for kind in ("emor", "analytic"):
        np.testing.assert_allclose(tcal.grossberg_apply(_t(c), _t(v), kind=kind).numpy(),
                                   np.asarray(jcal.grossberg_apply(jnp.asarray(c), jnp.asarray(v), kind=kind)),
                                   atol=1e-6)


def test_sampling_and_brackets_equal(ref):
    assert np.array_equal(thdr.sample_bracket_pixels(ref["imgs"], 500), ref["idx"])
    ex = np.array([1, 2, 4, 1, 2, 4, 8])
    assert thdr.estimate_brackets(ex, 3) == jhdr.estimate_brackets(ex, 3) == [[0, 1, 2], [3, 4, 5]]


def test_laguerre_calibration_matches(ref):
    phi = float(thdr.laguerre_calibrate(_t(ref["s"]), _t(ref["ex"])))
    assert abs(phi - float(ref["phi"])) < 1e-5 and abs(phi - PHI_GT) < 0.05, (phi, ref["phi"])


def test_grossberg_calibration_matches(ref):
    """The EMoR basis is near-collinear: the two float32 normal-equation
    solves give coefficients ~3e-4 apart (each within 6e-5 of the float64
    solve) but the same inverse response to 2e-5."""
    c = thdr.grossberg_calibrate(_t(ref["s"]), _t(ref["ex"])).numpy()
    np.testing.assert_allclose(c, ref["coeffs"], atol=5e-4 * np.abs(ref["coeffs"]).max())
    v = np.linspace(0, 1, 101).astype(np.float32)
    np.testing.assert_allclose(thdr.grossberg_apply(_t(c), _t(v)).numpy(),
                               np.asarray(jhdr.grossberg_apply(jnp.asarray(ref["coeffs"]), jnp.asarray(v))), atol=2e-5)


def test_debevec_calibration_matches(ref):
    s, ex = ref["s"][:3, :300], ref["ex"][:3]
    g = thdr.debevec_calibrate(_t(s), _t(ex)).g.numpy()
    used = np.unique(np.clip((s * 255).astype(np.int32), 0, 255))
    np.testing.assert_allclose(g[used], ref["g"][used], atol=DEBEVEC_G_ATOL)
    # the radiance each g merges, on the same brackets
    imgs = ref["imgs"][:3]
    mj = np.asarray(jhdr.merge_hdr(jnp.asarray(imgs), jnp.asarray(ex), response=("debevec", ref["g"])))
    mt = thdr.merge_hdr(_t(imgs), _t(ex), response=("debevec", g)).numpy()
    assert np.median(np.abs(mt - mj) / np.abs(mj)) < 0.01


@pytest.mark.parametrize("kind", ["laguerre", "grossberg", "debevec", "phi"])
def test_merge_hdr_matches(ref, kind):
    imgs, ex = ref["imgs"], ref["ex"]
    if kind == "phi":
        mj = np.asarray(jhdr.merge_hdr(jnp.asarray(imgs), jnp.asarray(ex), phi=PHI_GT))
        mt = thdr.merge_hdr(_t(imgs), _t(ex), phi=PHI_GT).numpy()
    else:
        par = {"laguerre": ref["phi"], "grossberg": ref["coeffs"], "debevec": ref["g"]}[kind]
        mj = np.asarray(jhdr.merge_hdr(jnp.asarray(imgs), jnp.asarray(ex), response=(kind, par)))
        mt = thdr.merge_hdr(_t(imgs), _t(ex), response=(kind, par)).numpy()
    np.testing.assert_allclose(mt, mj, rtol=1e-5, atol=1e-6)


def test_merge_highlight_fallback_and_recovery():
    E = np.full((8, 8, 3), 100.0, np.float32)
    ex = np.array([0.25, 1.0, 4.0], np.float32)
    imgs = np.stack([np.clip(E * dt, 0, 1) for dt in ex])
    mj = np.asarray(jhdr.merge_hdr(jnp.asarray(imgs), jnp.asarray(ex)))
    mt = thdr.merge_hdr(_t(imgs), _t(ex)).numpy()
    np.testing.assert_allclose(mt, mj, rtol=1e-6)
    assert (mt >= 3.9).all()
    rad = np.full((32, 32), 100.0, np.float32)
    ldr = np.zeros((32, 32), np.float32)
    ldr[8:16, 8:16] = 1.0
    for ldr_c, rad_c in ((ldr, rad), (np.repeat(ldr[..., None], 3, -1), np.repeat(rad[..., None], 3, -1))):
        hj = np.asarray(jmerge.highlight_recovery(jnp.asarray(rad_c), jnp.asarray(ldr_c), 1.0, 1.0, 1000.0))
        ht = tmerge.highlight_recovery(_t(rad_c), _t(ldr_c), 1.0, 1.0, 1000.0).numpy()
        np.testing.assert_allclose(ht, hj, rtol=1e-6)
        assert ht[12, 12].min() > 2000.0
    r = _t(rad)
    assert tmerge.highlight_recovery(r, _t(ldr), 1.0, correction_factor=0.0) is r


def test_cli_trio_matches_reference(tmp_path):
    """tests/test_hdr.py's ldrToHdr trio through both CLIs."""
    rng = np.random.default_rng(3)
    H = W = 32
    radiance = rng.uniform(0.05, 0.8, size=(H, W)).astype(np.float32)
    folder = tmp_path / "brackets"
    folder.mkdir()
    for i, t in enumerate([1.0, 4.0, 16.0]):
        v = np.clip(radiance * t / 16.0, 0, 1) ** 0.5
        np.save(folder / f"img_{i}.npy", np.repeat(v[..., None], 3, -1))
    runs = (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"]))
    for tag, main, extra in runs:
        assert main(["ldrToHdrSampling", "--inputFolder", str(folder), "--output", str(tmp_path / f"{tag}_s.npz"),
                     *extra]) == 0
    with np.load(tmp_path / "jax_s.npz") as zj, np.load(tmp_path / "port_s.npz") as zt:
        assert zj.files == zt.files and all(np.array_equal(zj[k], zt[k]) for k in zj.files)
    keys = {"laguerre": "phi", "grossberg": "coeffs", "debevec": "g"}
    for method, key in keys.items():
        for tag, main, extra in runs:
            resp = str(tmp_path / f"{tag}_{method}.npz")
            assert main(["ldrToHdrCalibration", "--input", str(tmp_path / "jax_s.npz"), "--output", resp,
                         "--calibrationMethod", method, *extra]) == 0
            assert main(["ldrToHdrMerge", "--inputFolder", str(folder), "--output",
                         str(tmp_path / f"{tag}_{method}.npy"), "--response", resp, *extra]) == 0
        with np.load(tmp_path / f"jax_{method}.npz") as zj, np.load(tmp_path / f"port_{method}.npz") as zt:
            assert str(zj["method"]) == str(zt["method"]) == method
            if method == "laguerre":
                assert abs(float(zt[key]) - float(zj[key])) < 1e-5
            elif method == "grossberg":  # the responses (this basis fit is worse conditioned: 1e-4)
                v = torch.linspace(0, 1, 101)
                np.testing.assert_allclose(thdr.grossberg_apply(_t(zt[key]), v).numpy(),
                                           np.asarray(jhdr.grossberg_apply(jnp.asarray(zj[key]), v.numpy())),
                                           atol=1e-4)
        mj, mt = np.load(tmp_path / f"jax_{method}.npy"), np.load(tmp_path / f"port_{method}.npy")
        assert mt.shape == mj.shape == (H, W, 3) and np.isfinite(mt).all()
        assert np.median(np.abs(mt - mj) / np.abs(mj)) < 0.01, method
        assert np.corrcoef(mt.mean(-1).ravel(), radiance.ravel())[0, 1] > 0.95, method
    # without --response, ldrToHdrMerge calibrates Laguerre itself
    for tag, main, extra in runs:
        assert main(["ldrToHdrMerge", "--inputFolder", str(folder), "--output", str(tmp_path / f"{tag}_auto.npy"),
                     *extra]) == 0
    np.testing.assert_allclose(np.load(tmp_path / "port_auto.npy"), np.load(tmp_path / "jax_auto.npy"), rtol=1e-4)
    assert os.path.exists(tmp_path / "port_auto.npy")
