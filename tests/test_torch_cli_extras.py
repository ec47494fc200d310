"""The twelve subcommands of the front-end extras and the exports through the
port's `cli.main` (`--device cpu`) against the JAX CLI, on the CPU.

Inputs are the JAX CLI tests' own: tests/test_cli_ext2.py's ring scene with
synthetic features and matches (exportKeypoints, exportMatches,
exportTracks, the voctree tools), tests/test_cli_ext.py's Middlebury file,
tests/test_cli_ext3.py's sample scene (exportMVSTexturing, exportMatlab,
exportMeshroomMaya), tests/test_stats_alignment_io.py's consistent scene
(computeUncertainty) and tests/test_cli_utils.py's frames
(keyframeSelection). Text, SVG, `.sfm`, `.abc`, `.ply` and JSON outputs
must be byte-equal, and the printed JSON equal. computeUncertainty's
covariances are float32 inverses of the reduced camera system: within
1e-3 of the largest entry, the mean trace within rtol 1e-3. voctreeCreation is held
through JAX's k-means draws (the port's k-means gets the row indices that
`jax.random.choice` drew for each node): centers within atol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from alicevision_tpu import sfmdata as jsd
from alicevision_tpu.image.io import write_image
from alicevision_tpu.matching import voctree as jvt
from alicevision_tpu.pipeline import cli as jcli
from alicevision_tpu_torch.matching import voctree as tvt
from alicevision_tpu_torch.pipeline import cli as tcli
from test_cli_ext2 import setup  # noqa: F401 (a module fixture)

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
COV_RTOL = 1e-3
TREE_ATOL = 1e-5


def _run_both(argv, out, tmp_path, capsys):
    """argv + --output <tag>/<out> through both CLIs: (printed JSON, output
    files) of each."""
    printed, files = {}, {}
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        os.makedirs(tmp_path / tag, exist_ok=True)
        dst = str(tmp_path / tag / out)
        capsys.readouterr()
        assert main([*argv, "--output", dst, *extra]) == 0
        printed[tag] = capsys.readouterr().out
        files[tag] = chip_smoke.tree_bytes(dst)
    return printed, files


@pytest.mark.parametrize("cmd", ["exportKeypoints", "exportMatches", "exportTracks"])
def test_svg_exports_byte_equal(setup, tmp_path, capsys, cmd):  # noqa: F811
    d, scene_f, feats, matches_f, _ = setup
    if cmd == "exportTracks":
        tracks = str(tmp_path / "tracks.npz")
        assert jcli.main(["tracksBuilding", "--input", scene_f, "--features", feats, "--matches", matches_f,
                          "--output", tracks]) == 0
        argv, out = ["--tracks", tracks, "--maxTracks", "50"], "tracks.svg"
    else:
        argv, out = (["--matches", matches_f] if cmd == "exportMatches" else []), "svg"
    printed, files = _run_both([cmd, "--input", scene_f, "--features", feats, *argv], out, tmp_path, capsys)
    assert printed["port"] == printed["jax"]
    assert files["port"] == files["jax"]
    n = {"exportKeypoints": 6, "exportMatches": 15, "exportTracks": 1}[cmd]
    assert len(files["jax"]) == n


def test_import_middlebury_byte_equal(tmp_path, capsys):
    par = str(tmp_path / "temple_par.txt")
    K = "1520.4 0 302.3 0 1525.9 246.9 0 0 1"
    R = "1 0 0 0 1 0 0 0 1"
    with open(par, "w") as f:
        f.write("2\n")
        f.write(f"img0.png {K} {R} 0 0 1\n")
        f.write(f"img1.png {K} {R} 0.1 0 1\n")
    write_image(str(tmp_path / "img1.png"), np.full((24, 40), 0.5, np.float32))  # its size is read
    printed, files = _run_both(["importMiddlebury", "--input", par], "mb.sfm", tmp_path, capsys)
    assert printed["port"] == printed["jax"]
    assert files["port"] == files["jax"]
    sc = json.loads(files["jax"][""])
    assert sorted(int(v["width"]) for v in sc["views"]) == [40, 640]


def _draws(monkeypatch):
    """Record the seed rows JAX's masked k-means draws for each node (the
    first lines of `voctree._kmeans_masked`), and hand them to the port's
    k-means in the same order."""
    drawn = []
    jax_kmeans = jvt._kmeans_masked

    def recording(key, X, valid, k, iters=10):
        w = valid.astype(X.dtype)
        p = w / jnp.maximum(w.sum(), 1.0)
        drawn.append(np.asarray(jax.random.choice(key, X.shape[0], (k,), replace=True, p=p)))
        return jax_kmeans(key, X, valid, k, iters)

    def replaying(generator, X, k, iters=10):
        idx = torch.tensor(drawn.pop(0), dtype=torch.int64, device=X.device)
        return tvt._kmeans_masked(generator, X, torch.ones(X.shape[0], dtype=torch.bool, device=X.device), k,
                                  iters, idx=idx)

    monkeypatch.setattr(jvt, "_kmeans_masked", recording)
    monkeypatch.setattr(tvt, "_kmeans", replaying)
    return drawn


def _random_descriptor_views(root, n_views=6, n_feats=64):
    """tests/test_cli_more.py's voctreeCreation input at 6 views: random
    16-d descriptors a view (numpy seed 0)."""
    rng = np.random.RandomState(0)
    sc = jsd.SfMData.empty()
    ii = sc.add_intrinsic(1, 100, 100, 50.0)
    feats = str(root / "rand_feats")
    os.makedirs(feats)
    for v in range(n_views):
        sc.add_view(10 + v, ii, 100, 100)
        np.savez_compressed(os.path.join(feats, f"{10 + v}.feat.npz"), xy=rng.rand(n_feats, 2),
                            scale=np.ones(n_feats), orientation=np.zeros(n_feats), response=np.ones(n_feats),
                            desc=rng.rand(n_feats, 16).astype(np.float32), valid=np.ones(n_feats, bool))
    scene_f = str(root / "rand.sfm")
    jsd.save(sc, scene_f)
    return scene_f, feats


@pytest.mark.parametrize("views", ["ring", "random_descriptors"])
def test_voctree_tools_match(setup, tmp_path, capsys, monkeypatch, views):  # noqa: F811
    """voctreeCreation (through JAX's draws), then voctreeStatistics and
    voctreeQueryUtility on JAX's tree: equal JSON, and equal pair files
    where the similarities do not tie. The ring's views all carry one
    descriptor table (tests/test_cli_ext2.py), so their similarities tie
    up to float32 rounding and `top_k` and `torch.topk` may pick different
    neighbours among equals: there the pair counts are held."""
    if views == "ring":
        _, scene_f, feats, _, _ = setup
    else:
        scene_f, feats = _random_descriptor_views(tmp_path)
    drawn = _draws(monkeypatch)
    trees = {}
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        trees[tag] = str(tmp_path / f"{tag}_tree.npz")
        assert main(["voctreeCreation", "--features", feats, "--input", scene_f, "--output", trees[tag],
                     "--branching", "4", "--levels", "2", *extra]) == 0
    assert not drawn  # every JAX draw was replayed
    with np.load(trees["jax"]) as a, np.load(trees["port"]) as b:
        assert a.files == b.files
        assert int(a["n_children"]) == int(b["n_children"]) == 4 and int(a["n_levels"]) == int(b["n_levels"]) == 2
        np.testing.assert_allclose(b["centers"], a["centers"], atol=TREE_ATOL)
    for argv in (["voctreeStatistics", "--tree", trees["jax"]],
                 ["voctreeQueryUtility", "--tree", trees["jax"], "--input", scene_f, "--features", feats,
                  "--nbNeighbors", "3"]):
        outs = {}
        for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
            pairs = str(tmp_path / f"{tag}_pairs.txt")
            more = ["--output", pairs] if argv[0] == "voctreeQueryUtility" else []
            capsys.readouterr()
            assert main([*argv, *more, *extra]) == 0
            outs[tag] = capsys.readouterr().out
        assert outs["port"] == outs["jax"]
    if views == "random_descriptors":
        assert (tmp_path / "port_pairs.txt").read_bytes() == (tmp_path / "jax_pairs.txt").read_bytes()
    assert len(np.loadtxt(tmp_path / "jax_pairs.txt", dtype=int).reshape(-1, 2)) >= 6


def test_voctree_creation_draws_from_a_seeded_generator(setup, tmp_path):  # noqa: F811
    """Without JAX's draws the port's tree comes from its own generator
    seeded 0: the same file twice."""
    _, scene_f, feats, _, _ = setup
    out = [str(tmp_path / f"t{k}.npz") for k in range(2)]
    for o in out:
        assert tcli.main(["voctreeCreation", "--features", feats, "--input", scene_f, "--output", o,
                          "--branching", "4", "--levels", "2", *CPU]) == 0
    with np.load(out[0]) as a, np.load(out[1]) as b:
        np.testing.assert_array_equal(a["centers"], b["centers"])
        assert a["centers"].shape == (2, 16, 16)


def test_compute_uncertainty_matches(tmp_path, capsys):
    from test_stats_alignment_io import _consistent_scene

    scene_f = str(tmp_path / "scene.sfm")
    jsd.save(_consistent_scene(), scene_f)
    covs, printed = {}, {}
    for tag, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        out = str(tmp_path / f"{tag}_cov.npz")
        capsys.readouterr()
        assert main(["computeUncertainty", "--input", scene_f, "--output", out, *extra]) == 0
        printed[tag] = json.loads(capsys.readouterr().out.strip())
        with np.load(out) as z:
            assert z.files == ["view_ids", "covariances"]
            covs[tag] = (z["view_ids"], z["covariances"])
    np.testing.assert_array_equal(covs["port"][0], covs["jax"][0])
    a, b = covs["jax"][1], covs["port"][1]
    assert a.shape == b.shape == (6, 6, 6)
    # the gauge camera's block dominates; the free cameras' blocks sit at
    # float32 rounding (~1e-6 of it, negative traces) in both packages
    np.testing.assert_allclose(b, a, atol=COV_RTOL * np.abs(a).max())
    np.testing.assert_allclose(printed["port"]["mean_trace"], printed["jax"]["mean_trace"], rtol=COV_RTOL)


@pytest.mark.parametrize("cmd", ["exportMVSTexturing", "exportMatlab", "exportMeshroomMaya"])
def test_scene_exports_byte_equal(tmp_path, capsys, cmd):
    scene_f = str(tmp_path / "s.sfm")
    assert jcli.main(["generateSampleScene", "--output", scene_f, "--nbViews", "3", "--nbPoints", "10"]) == 0
    argv = [cmd, "--input", scene_f]
    if cmd == "exportMeshroomMaya":
        os.makedirs(tmp_path / "undist")
        np.save(tmp_path / "undist" / "v0.npy", np.zeros((2, 2), np.float32))
        argv += ["--images", str(tmp_path / "undist")]
    printed, files = _run_both(argv, "out", tmp_path, capsys)
    assert printed["port"] == printed["jax"]
    assert files["port"] == files["jax"]
    want = {"exportMVSTexturing": 3, "exportMatlab": 10,
            "exportMeshroomMaya": 4}[cmd]  # scene.abc, pointCloud.ply, cameras.json, undistorted/v0.npy
    assert len(files["jax"]) == want


@pytest.mark.parametrize("method", ["regular", "smart"])
def test_keyframe_selection_matches(tmp_path, method):
    folder = tmp_path / "frames"
    os.makedirs(folder)
    if method == "regular":  # tests/test_cli_utils.py's frames
        for i in range(9):
            write_image(str(folder / f"f{i:03d}.png"), np.full((16, 16), i / 10, np.float32))
        extra = ["--method", "regular", "--step", "4"]
    else:  # a short pan, every other frame blurred
        from test_keyframe_smart import _make_sequence

        for i, f in enumerate(_make_sequence(n_move=4, n_static=2)[0]):
            np.save(folder / f"f{i:03d}.npy", f)
        extra = []
    for tag, main, more in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        assert main(["keyframeSelection", "--inputFolder", str(folder), "--output", str(tmp_path / f"{tag}.txt"),
                     *extra, *more]) == 0
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    if method == "regular":
        assert (tmp_path / "port.txt").read_text().split() == ["f000.png", "f004.png", "f008.png"]


def _no_cv2(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)


def test_keyframe_video_needs_opencv(tmp_path, monkeypatch):
    """A video the port's feed does not take (an MP4 container, which the
    JAX package reads through OpenCV) raises a ValueError naming it, and
    keyframeSelection fails on it; the port never reaches for cv2."""
    _no_cv2(monkeypatch)
    from alicevision_tpu_torch.image.feeds import video_feed

    (tmp_path / "clip.mp4").write_bytes(b"\0\0\0\x18ftypisom" + bytes(32))
    with pytest.raises(ValueError, match="container MP4"):
        next(video_feed(str(tmp_path / "clip.mp4")))
    assert tcli.main(["keyframeSelection", "--inputFolder", str(tmp_path / "clip.mp4"), "--output",
                      str(tmp_path / "s.txt"), *CPU]) == 1


def test_keyframe_video_reads_mjpeg_without_opencv(tmp_path, monkeypatch):
    """An MJPEG AVI goes through the port's own reader with cv2 blocked."""
    from alicevision_tpu_torch.image import jpeg

    _no_cv2(monkeypatch)
    base = (np.random.default_rng(0).random((24, 32)) * 255).astype(np.uint8)
    frames = [jpeg.encode(np.roll(base, 2 * i, axis=1), 90) for i in range(7)]
    (tmp_path / "clip.avi").write_bytes(chip_smoke.mjpeg_avi(frames, 32, 24))
    assert tcli.main(["keyframeSelection", "--inputFolder", str(tmp_path / "clip.avi"), "--output",
                      str(tmp_path / "s.txt"), "--method", "regular", "--step", "3", *CPU]) == 0
    assert (tmp_path / "s.txt").read_text().split() == ["frame_000000", "frame_000003", "frame_000006"]
