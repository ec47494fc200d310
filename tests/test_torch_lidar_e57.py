"""The port's E57 and lidar modules against the JAX package's, on the CPU.

Both are host copies: `write_e57` writes the JAX writer's bytes (with and
without pose and intensity, over several data packets), each reader reads
the other's files to the same arrays, and the PLY writer writes the JAX
writer's text byte for byte (float64's shortest repr, including its
exponent forms, -0.0, nan and inf), blockwise. Merging and decimating give
JAX's arrays; the mesh of `mesh_lidar` is held as the port's graph-cut
tests hold it (the same vertices, the same faces as sets).
"""

import json

import numpy as np
import pytest
import torch

from alicevision_tpu.image import e57 as je57
from alicevision_tpu.mvs import lidar as jld
from alicevision_tpu_torch.image import e57 as te57
from alicevision_tpu_torch.mvs import lidar as tld

torch.set_num_threads(1)


def _sorted_faces(f):
    f = np.sort(np.asarray(f), axis=1)
    return f[np.lexsort(f.T[::-1])]


def test_crc32c_matches():
    data = np.random.RandomState(0).randint(0, 256, 3000).astype(np.uint8).tobytes()
    assert te57.crc32c(b"\x00" * 32) == je57.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert te57.crc32c(data) == je57.crc32c(data)
    pages = np.frombuffer(data[:2 * te57.PAYLOAD], np.uint8).reshape(2, -1)
    assert np.array_equal(te57._crc32c_pages(pages), je57._crc32c_pages(pages))


@pytest.mark.parametrize("case", ["plain", "intensity_pose", "packets", "empty"])
def test_write_e57_bytes_and_read(tmp_path, case):
    rng = np.random.default_rng(3)
    n = {"plain": 500, "intensity_pose": 1234, "packets": 6000, "empty": 0}[case]
    pts = rng.normal(0, 5, (n, 3))
    kw = {}
    if case == "intensity_pose":
        kw = dict(intensity=rng.uniform(0, 1, n), pose=((np.sqrt(0.5), 0.0, 0.0, np.sqrt(0.5)), [1.0, -2.0, 0.5]))
    if case == "packets":
        kw = dict(chunk=700)
    a, b = str(tmp_path / "port.e57"), str(tmp_path / "jax.e57")
    te57.write_e57(a, pts, **kw)
    je57.write_e57(b, pts, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    for read in (te57.read_e57, je57.read_e57):
        got, want = read(b), je57.read_e57(a)
        assert got["xml"] == want["xml"]
        np.testing.assert_array_equal(got["points"], want["points"])
        sa, sb = got["scans"][0], want["scans"][0]
        for k in ("intensity", "color"):
            assert (sa[k] is None) == (sb[k] is None) and (sa[k] is None or np.array_equal(sa[k], sb[k]))
        assert (sa["pose"] is None) == (sb["pose"] is None)
        if sa["pose"] is not None:
            assert all(np.array_equal(x, y) for x, y in zip(sa["pose"], sb["pose"]))


def test_ply_text_bytes_and_read(tmp_path):
    rng = np.random.RandomState(0)
    pts = rng.randn(3000, 3) * 10.0
    pts[:6] = [[1e-5, 1e16, -0.0], [np.nan, np.inf, -np.inf], [1e-4, 9.999999e15, 123456789012345.6],
               [0.1, 0.2, 0.3], [5e-324, 1.7976931348623157e308, 2.0], [-1.5e-300, 3.0, 1e22]]
    for arr in (pts, pts.astype(np.float32), np.zeros((0, 3))):
        a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
        tld.save_cloud_ply(a, arr)
        jld.save_cloud_ply(b, arr)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(tld.load_cloud_ply(b), jld.load_cloud_ply(b))


@pytest.fixture(scope="module")
def stations(tmp_path_factory):
    """chip_smoke.py's lidar inputs at 48x24 samples a station: station 0 as
    an E57 with a pose, stations 1 and 2 as PLYs, and an input set."""
    import chip_smoke

    work = tmp_path_factory.mktemp("lidar")
    return str(work), chip_smoke.make_lidar_inputs(str(work), samples=(48, 24))


def test_input_set_merge_and_decimate_match(stations):
    work, inputs = stations
    got, want = tld.load_input_set(inputs["input_set"]), jld.load_input_set(inputs["input_set"])
    assert len(got) == len(want) == 3
    for (p, o), (q, r) in zip(got, want):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(o, r)
    assert [s[0].shape[0] for s in got] == [48 * 24] * 3
    for a, b in zip(tld.read_e57(inputs["e57"]), jld.read_e57(inputs["e57"])):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    pts, org = tld.merge_scans(got)
    jpts, jorg = jld.merge_scans(want)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(org, jorg)
    for cell in (0.05, 0.3):
        for x, y in zip(tld.decimate_cloud(pts, org, cell), jld.decimate_cloud(jpts, jorg, cell)):
            np.testing.assert_array_equal(x, y)


def test_mesh_lidar_matches(stations):
    work, inputs = stations
    pts, org = tld.merge_scans(tld.load_input_set(inputs["input_set"]))
    v, f = tld.mesh_lidar(pts, org, max_points=2000)
    jv, jf = jld.mesh_lidar(pts, org, max_points=2000)
    np.testing.assert_array_equal(v, jv)
    assert len(f) > 200 and np.array_equal(_sorted_faces(f), _sorted_faces(jf))


def test_input_set_file_format(stations):
    work, inputs = stations
    with open(inputs["input_set"]) as f:
        entries = json.load(f)
    assert entries[0]["ply"].endswith(".e57") and all(e["ply"].endswith(".ply") for e in entries[1:])
