"""The port's keyframe selector, image cache and frame feeds against the JAX
package's, on the CPU.

Inputs are tests/test_keyframe_smart.py's sequences (a noise image panned
by a few pixels a frame, most frames blurred; numpy from a seed).
Tolerances: `sharpness_score` rtol 1e-5 (float32 integral tables summed in
another order); `block_flow_field` equal (integer searches over the same
SAD maps); `block_flow_displacement` rtol 1e-6, with an even count of
cells whose two middle values differ (the median averages them, as
`jnp.median` does); both selections equal (on shorter runs of the same
sequences: JAX scores them eagerly).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from alicevision_tpu.image import feeds as jfeeds
from alicevision_tpu.image import ImageCache as JImageCache
from alicevision_tpu.keyframe import selector as jsel
from alicevision_tpu_torch import sfmdata as tsd
from alicevision_tpu_torch.image import feeds as tfeeds
from alicevision_tpu_torch.image import ImageCache as TImageCache
from alicevision_tpu_torch.image.io import write_image
from alicevision_tpu_torch.keyframe import selector as tsel
from test_keyframe_smart import _make_sequence

torch.set_num_threads(1)

SHARP_RTOL = 1e-5
FLOW_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _jax_scores_once():
    """The JAX selector scores a frame (and a frame pair) eagerly: keep each
    score it computes for the module, so that the selection cases that
    share frames compute them once."""
    mp = pytest.MonkeyPatch()
    for name in ("sharpness_score", "block_flow_displacement"):
        fn, seen = getattr(jsel, name), {}

        def cached(*args, _fn=fn, _seen=seen, **kw):
            key = tuple((a.shape, np.asarray(a).tobytes()) if hasattr(a, "shape") else a for a in args)
            key += tuple(sorted(kw.items()))
            if key not in _seen:
                _seen[key] = _fn(*args, **kw)
            return _seen[key]

        mp.setattr(jsel, name, cached)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pan():
    return _make_sequence(n_move=6, n_static=0)[0]


def test_sharpness_scores_match(pan):
    for f in pan[:6]:
        for window in (200, 32):
            want = float(jsel.sharpness_score(jnp.asarray(f), window))
            got = float(tsel.sharpness_score(torch.from_numpy(f), window))
            np.testing.assert_allclose(got, want, rtol=SHARP_RTOL)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_block_flow_field_equal(pan, levels):
    for i in (1, 5):
        a, b = pan[i], pan[i - 1]
        want = jsel.block_flow_field(jnp.asarray(a), jnp.asarray(b), levels=levels)
        got = tsel.block_flow_field(torch.from_numpy(a), torch.from_numpy(b), levels=levels)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_block_flow_displacement_even_cells():
    """24 cells (64x96 frames, 16-px blocks): the median is the mean of the
    12th and 13th magnitudes, which differ on this pair (a pan of 3 px
    beside a still half), where `torch.median` would give the lower."""
    rng = np.random.RandomState(4)
    a = rng.rand(64, 96).astype(np.float32)
    b = a.copy()
    b[:, :48] = np.roll(a, 3, axis=1)[:, :48]
    b[:32, :48] = np.roll(a, 2, axis=0)[:32, :48]
    dy, dx = tsel.block_flow_field(torch.from_numpy(b), torch.from_numpy(a), levels=2)
    mag = np.sort(np.sqrt(dy.numpy() ** 2 + dx.numpy() ** 2).ravel())
    assert mag.size == 24 and mag[11] != mag[12]
    want = float(jsel.block_flow_displacement(jnp.asarray(b), jnp.asarray(a)))
    got = float(tsel.block_flow_displacement(torch.from_numpy(b), torch.from_numpy(a)))
    np.testing.assert_allclose(got, want, rtol=FLOW_RTOL)
    np.testing.assert_allclose(got, 0.5 * (mag[11] + mag[12]), rtol=FLOW_RTOL)


@pytest.mark.parametrize("case", ["sharp", "motion", "min_frames", "max_frames"])
def test_smart_selection_equal(case):
    """The JAX test's four cases, on shorter runs of its sequences: the JAX
    selector scores every frame pair eagerly (~0.5 s a pair on the CPU)."""
    if case == "sharp":
        frames, kw = _make_sequence(n_move=8, n_static=4)[0], dict(px_displacement=20.0)
    elif case == "motion":
        frames, kw = _make_sequence(n_move=8, n_static=4)[0], dict(px_displacement=8.0)
    elif case == "min_frames":
        rng = np.random.RandomState(3)
        base = rng.rand(48, 48).astype(np.float32)
        frames = [base + 0.001 * rng.rand(48, 48).astype(np.float32) for _ in range(8)]
        kw = dict(px_displacement=20.0, min_out_frames=4)
    else:
        frames, kw = _make_sequence(n_move=8, n_static=0, shift_px=4)[0], dict(px_displacement=2.0,
                                                                             max_out_frames=3)
    want = jsel.select_keyframes_smart(frames, **kw)
    got = tsel.select_keyframes_smart(frames, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and len(got) >= 1


def test_regular_selection_and_center_weights():
    np.testing.assert_array_equal(tsel.select_keyframes_regular(23, 4), jsel.select_keyframes_regular(23, 4))
    for n in range(1, 9):
        np.testing.assert_array_equal(tsel._center_weights(n), jsel._center_weights(n))
    for frames in ([], [np.zeros((8, 8), np.float32)]):
        np.testing.assert_array_equal(tsel.select_keyframes_smart(frames, device="cpu"),
                                      jsel.select_keyframes_smart(frames))


def test_image_cache_matches():
    def run(cls):
        reads = []

        def fake_read(path):
            reads.append(path)
            return np.zeros((100, 100), np.float32)  # 40 KB

        cache = cls(capacity_bytes=100_000, read_fn=fake_read)
        a = cache.get("a")
        assert cache.get("a") is a
        for key in ("b", "c", "a"):
            cache.get(key)
        shape = cache.get("c", downscale=2).shape
        state = (reads, cache.hits, cache.misses, cache.size_bytes, shape, "a" in cache, ("c", 2) in cache)
        cache.clear()
        return state + (cache.size_bytes,)

    assert run(TImageCache) == run(JImageCache)


def test_feeds_match(tmp_path):
    for i in range(3):
        write_image(str(tmp_path / f"im{i}.png"), np.full((8, 8), i / 4, np.float32))
    np.save(tmp_path / "im3.npy", np.full((8, 8), 0.5, np.float32))
    for got, want in ((tfeeds.image_feed(str(tmp_path)), jfeeds.image_feed(str(tmp_path))),
                      (tfeeds.feed_provider(str(tmp_path / "im1.png")), jfeeds.feed_provider(str(tmp_path / "im1.png")))):
        got, want = list(got), list(want)
        assert [n for _, n in got] == [n for _, n in want] and len(got) >= 1
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    # an SfMData feed yields the view's image, id and intrinsics row
    sc = tsd.SfMData.empty()
    i0 = sc.add_intrinsic(7, 8, 8, 10.0)
    i1 = sc.add_intrinsic(9, 8, 8, 12.0, offset=(0.5, -0.25))
    sc.add_view(11, i0, 8, 8, path=str(tmp_path / "im0.png"))
    sc.add_view(12, i1, 8, 8, path=str(tmp_path / "im2.png"))
    sc.add_view(13, i1, 8, 8, path=str(tmp_path / "missing.png"))
    tsd.save(sc, str(tmp_path / "s.sfm"))
    got = list(tfeeds.feed_provider(str(tmp_path / "s.sfm")))
    want = list(jfeeds.feed_provider(str(tmp_path / "s.sfm")))
    assert [g[1] for g in got] == [w[1] for w in want] == [11, 12]
    for (ga, _, gr), (wa, _, wr) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        for x, y in zip(gr, wr):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(ValueError, match="unsupported"):
        tfeeds.feed_provider(str(tmp_path / "x.txt"))
