"""The port's MJPEG AVI reader (`image/avi.py`) and video feed
(`image/feeds.video_feed`) against the JAX package's feed
(`cv2.VideoCapture`, FFmpeg) and PIL's decode of each frame chunk, and
the port's readers with imageio, PIL and cv2 blocked.

The port decodes a frame as libjpeg-turbo does, byte-equal to PIL; FFmpeg's
MJPEG decoder (behind cv2) differs from it. Measured here on cv2-written
clips (the JAX photo test's rolled noise, and colour waves with hard
chroma edges): grey up to 3.7/255 apart, 0.9/255 on average; RGB up to
52/255, 4.6/255 on average. The tolerances below hold those with a
margin (ROADMAP §3).
"""

import builtins
import io
import json
import os

import numpy as np
import pytest

from alicevision_tpu.image import feeds as jfeeds
from alicevision_tpu_torch.image import avi, feeds, jpeg
from alicevision_tpu_torch.image import io as tio

import chip_smoke

FIXTURES = os.path.join(os.path.dirname(avi.__file__), "..", "data", "codec_fixtures")
TABLE = json.load(open(os.path.join(FIXTURES, "fixtures.json")))
GREY_MAX, GREY_MEAN, RGB_MAX, RGB_MEAN = 10 / 255, 1.5 / 255, 96 / 255, 8 / 255


def _cv2_clip(path: str, frames: list, fps: int = 10) -> None:
    """tests/test_pipeline_photos.py's writer: cv2's MJPG VideoWriter."""
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h), isColor=True)
    for f in frames:
        u8 = np.clip(f * 255.0, 0, 255).astype(np.uint8)
        vw.write(u8 if u8.ndim == 3 else np.stack([u8] * 3, -1))
    vw.release()


def _noise_frames(n=10, h=64, w=96):
    base = np.random.RandomState(0).rand(h, w).astype(np.float32)
    return [np.roll(base, 2 * i, axis=1) for i in range(n)]


def _colour_frames(n=5, h=96, w=128):
    y, x = np.mgrid[0:h, 0:w]
    col = np.stack([0.5 + 0.4 * np.sin(x / 7 + c) * np.cos(y / 5 - c) for c in range(3)], -1)
    col[(x // 16 + y // 16) % 2 == 0] *= [1.0, 0.2, 0.2]
    return [np.roll(col, 3 * i, axis=1) for i in range(n)]


@pytest.mark.parametrize("name", ["avi_cv2_mjpeg.avi", "avi_dropped_frame.avi"])
def test_frames_are_pils_decode(name):
    """Every frame equals PIL's decode of its chunk; the frame count equals
    cv2's (a zero-length chunk yields no frame)."""
    import cv2
    from PIL import Image

    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    info = avi.parse(data)
    got = list(avi.read_frames(path))
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert len(got) == n == TABLE[name]["cv2_frames"] == len(info["frames"])
    assert [i for _, i in got] == list(range(n))
    for (img, _), (off, size) in zip(got, info["frames"]):
        np.testing.assert_array_equal(img, np.asarray(Image.open(io.BytesIO(data[off:off + size])).convert("RGB")))


@pytest.mark.parametrize("clip", ["noise", "colour"])
def test_feed_within_tolerance_of_jax(tmp_path, clip):
    """The port's feed against the JAX package's (cv2) on cv2-written
    clips, grey and RGB, with stride; the JAX test's correlation."""
    frames = _noise_frames() if clip == "noise" else _colour_frames()
    path = str(tmp_path / "clip.avi")
    _cv2_clip(path, frames)
    for grey, (mx, mean) in ((True, (GREY_MAX, GREY_MEAN)), (False, (RGB_MAX, RGB_MEAN))):
        ours, ref = list(feeds.video_feed(path, grey)), list(jfeeds.video_feed(path, grey))
        assert [i for _, i in ours] == [i for _, i in ref] == list(range(len(frames)))
        d = [np.abs(a - b) for (a, _), (b, _) in zip(ours, ref)]
        assert ours[0][0].dtype == np.float32 and ours[0][0].shape == ref[0][0].shape
        assert max(x.max() for x in d) <= mx and np.mean([x.mean() for x in d]) <= mean
    for img, i in feeds.video_feed(path, True):
        if clip == "noise":
            a, b = img - img.mean(), frames[i] - frames[i].mean()
            assert float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())) > 0.95
    assert [i for _, i in feeds.video_feed(path, stride=3)] == [i for _, i in jfeeds.video_feed(path, stride=3)]
    assert len(list(feeds.feed_provider(path))) == len(frames)


@pytest.mark.parametrize("method", ["regular", "smart"])
def test_keyframe_selection_from_video_matches_jax(tmp_path, method):
    """keyframeSelection on a cv2 MJPEG clip through both CLIs: regular is
    equal; smart, on frames a few levels apart, is equal here too."""
    from alicevision_tpu.pipeline import cli as jcli
    from alicevision_tpu_torch.pipeline import cli as tcli

    base = np.random.RandomState(1).rand(48, 64).astype(np.float32)
    frames = [np.roll(base, 3 * i, axis=1) for i in range(12 if method == "regular" else 6)]
    path = str(tmp_path / "pan.avi")
    _cv2_clip(path, frames)
    extra = ["--step", "5"] if method == "regular" else []
    for tag, main, more in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        assert main(["keyframeSelection", "--inputFolder", path, "--output", str(tmp_path / f"{tag}.txt"),
                     "--method", method, *extra, *more]) == 0
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    if method == "regular":
        assert (tmp_path / "port.txt").read_text().split() == ["frame_000000", "frame_000005", "frame_000010"]


def test_refused_codecs_and_containers(tmp_path):
    with pytest.raises(ValueError, match="AVI codec H264"):
        list(avi.read_frames(os.path.join(FIXTURES, "avi_h264.avi")))
    for ext, name in ((".mp4", "MP4"), (".mov", "MOV"), (".mkv", "Matroska")):
        (tmp_path / f"c{ext}").write_bytes(b"\0\0\0\x18ftypisom" + bytes(32))
        with pytest.raises(ValueError, match=f"container .*{name}"):
            next(feeds.video_feed(str(tmp_path / f"c{ext}")))


def test_grey_and_dht_less_frames(tmp_path):
    """A grey JPEG frame comes out as three equal channels; a frame with no
    DHT (AVI1) decodes with the Annex K tables."""
    from PIL import Image

    rng = np.random.default_rng(4)
    grey = (rng.random((24, 32)) * 255).astype(np.uint8)
    colour = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    g, c = jpeg.encode(grey, 80), jpeg.encode(colour, 80)
    no_dht = bytearray(c[:2])
    for m, a, b, q in jpeg._segments(c):
        if m == 0xDA:
            no_dht += c[a - 4:]
            break
        if m != 0xC4:
            no_dht += c[a - 4:b]
    (tmp_path / "v.avi").write_bytes(chip_smoke.mjpeg_avi([g, bytes(no_dht)], 32, 24))
    frames = [f for f, _ in avi.read_frames(str(tmp_path / "v.avi"))]
    np.testing.assert_array_equal(frames[0], np.repeat(jpeg.decode(g)[..., None], 3, 2))
    np.testing.assert_array_equal(frames[1], np.asarray(Image.open(io.BytesIO(bytes(no_dht)))))
    np.testing.assert_array_equal(frames[1], jpeg.decode(c))


def test_reads_every_fixture_with_codec_libraries_blocked(monkeypatch):
    """With imageio, PIL and cv2 unimportable, the port reads every TIFF,
    BMP and PNG fixture (to its recorded hash), the AVIs and the EXIF."""
    import hashlib

    real = builtins.__import__

    def blocked(name, *a, **kw):
        if name.split(".")[0] in ("imageio", "PIL", "cv2"):
            raise ImportError(f"{name} is blocked")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", blocked)
    for name, row in sorted(TABLE.items()):
        path = os.path.join(FIXTURES, name)
        want = {**row.get("jax", {}), **row.get("port", {})}
        if "raises" in want:
            with pytest.raises(ValueError):
                list(avi.read_frames(path)) if name.endswith(".avi") else tio.read_image(path)
            continue
        if name.endswith(".avi"):
            got = [f for f, _ in avi.read_frames(path)]
            assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == [r["sha256"] for r in row["frames"]]
            assert len(list(feeds.video_feed(path))) == len(got)
            continue
        img = tio._read_own(path, tio._codec(path))
        img = img != 0 if img.dtype == bool else img
        assert [img.dtype.name, list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] == [
            want["dtype"], want["shape"], want["sha256"]], name
        assert tio.read_exif(path) == want.get("exif", row["jax"]["exif"]), name
