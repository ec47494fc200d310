#!/usr/bin/env python3
"""The JAX package's readings for chip_smoke.py's `extras` phase, on the
CPU: the numbers its gates (`chip_smoke.EXTRAS_REFERENCE`, with the margins
of `chip_smoke.EXTRAS_GATES`) are set from.

    python3 scripts/front_extras_reference.py [--work DIR] [--draws N]

from the repository root. It renders the phase's inputs as the card does
(`chip_smoke.make_posed_scene`: the 8 box-world views at 1280x960, and
`chip_smoke.make_keyframe_sequence`), runs the cli phase's front commands
through the JAX CLI (cameraInit, featureExtraction with its default
DSP-SIFT, imageMatching, featureMatching), then the phase's front commands
(`chip_smoke.extras_front_chain`: AKAZE and AKAZE-MLDB with F-filtered
matching, the homography-growing filter, one pair's putative matches), the
JAX K-VLD and photometric filters on that pair, keyframeSelection smart and
regular, and the vocabulary tree's retrieval of adjacent views for N keys
(PRNGKey(k), k < N, default 64). It prints the readings as one JSON line,
with `voctree_total_gate`: the 0.1 % quantile of an 8-draw total when 8 of
JAX's draws are taken at random (100,000 resamples, numpy seed 0). Paste
the `extras_reference` object into chip_smoke.EXTRAS_REFERENCE. About 10
minutes on 4 CPU threads, most of it JAX compiling and running DSP-SIFT and
AKAZE at 1024x768.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu import sfmdata as jsd  # noqa: E402
from alicevision_tpu.matching import voctree as jvt  # noqa: E402
from alicevision_tpu.matching.kvld import kvld_filter  # noqa: E402
from alicevision_tpu.matching.photometric_filter import photometric_filter  # noqa: E402
from alicevision_tpu.pipeline import cli as jcli  # noqa: E402
from alicevision_tpu.pipeline import stages as jst  # noqa: E402


def voctree_draws(init: str, feats: str, draws: int) -> list:
    """voctreeCreation's tree (8 children, 3 levels) for PRNGKey(k), k <
    draws, and voctreeQueryUtility's pairs at the phase's --nbNeighbors:
    the adjacent pairs each retrieves."""
    sc = jsd.load(init)
    fs = [jst.load_features(feats, int(sc.view_ids[v])) for v in range(sc.n_views)]
    train = jnp.asarray(np.concatenate([f["desc"][f["valid"]] for f in fs]))
    out = []
    for k in range(draws):
        tree = jvt.build_voctree(jax.random.PRNGKey(k), train, n_children=8, n_levels=3)
        bows = jnp.stack([jvt.bow_vector(tree, jnp.asarray(f["desc"]), jnp.asarray(f["valid"])) for f in fs])
        pairs = jvt.query_pairs(jvt.build_database(tree, bows), n_neighbors=chip_smoke.EXTRAS_VOCTREE["neighbors"])
        out.append(chip_smoke.adjacent_recall(pairs, sc.n_views))
    return out


def total_gate(per_draw: list, block: int, q: float = 0.001, resamples: int = 100_000) -> int:
    """The q-quantile of a `block`-draw total, the draws taken at random
    from `per_draw` (numpy seed 0)."""
    rng = np.random.RandomState(0)
    totals = np.asarray(per_draw)[rng.randint(0, len(per_draw), (resamples, block))].sum(1)
    return int(np.quantile(totals, q, method="lower"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None, help="keep the inputs and outputs here")
    ap.add_argument("--draws", type=int, default=64, help="vocabulary-tree keys")
    args = ap.parse_args()
    work = args.work or tempfile.mkdtemp(prefix="extras_ref_")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    posed, _ = chip_smoke.make_posed_scene(work, n_views=8)
    images = os.path.join(work, "images")
    cli_dir = os.path.join(work, "cli")
    os.makedirs(cli_dir, exist_ok=True)
    init, feats, pairs = (os.path.join(cli_dir, f) for f in ("cameraInit.sfm", "features", "pairs.txt"))
    front = [("cameraInit", ["--imageFolder", images, "--output", init, "--defaultFocalPx",
                             str(chip_smoke.CLI_FOCAL_PX)]),
             ("featureExtraction", ["--input", init, "--output", feats]),
             ("imageMatching", ["--input", init, "--features", feats, "--output", pairs]),
             ("featureMatching", ["--input", init, "--features", feats, "--pairs", pairs,
                                  "--output", os.path.join(cli_dir, "matches.npz")])]
    rows = chip_smoke.run_chain(jcli.main, front, "extras reference")
    ex = os.path.join(work, "extras")
    os.makedirs(ex, exist_ok=True)
    rows.update(chip_smoke.run_chain(jcli.main, chip_smoke.extras_front_chain(ex, init, feats, pairs),
                                     "extras reference"))
    rep = chip_smoke.extras_front_report(ex, posed, feats, 8)
    filt = chip_smoke.extras_filter_readings(ex, images, posed, feats, kvld_filter, photometric_filter)
    filt.pop("masks")
    kf_dir = os.path.join(ex, "frames")
    sharp = chip_smoke.make_keyframe_sequence(kf_dir)
    chip_smoke.run_chain(jcli.main, chip_smoke.keyframe_chain(kf_dir, ex), "extras reference")
    kf = chip_smoke.read_keyframes(ex)
    t1 = time.perf_counter()
    draws = voctree_draws(init, feats, args.draws)
    block = chip_smoke.EXTRAS_VOCTREE["draws"]
    ref = {
        "akaze": {k: rep["akaze"][k] for k in ("matches", "median_sampson_px", "frac_within_2px")},
        "akaze_mldb": {k: rep["akaze_mldb"][k] for k in ("matches", "median_sampson_px", "frac_within_2px")},
        "homography_growing": {k: rep["homography_growing"][k]
                               for k in ("matches", "median_sampson_px", "frac_within_2px")},
        "putative": filt["putative"], "kvld": filt["kvld"], "photometric": filt["photometric"],
        "keyframes_smart": kf["smart"], "keyframes_regular": kf["regular"],
        "voctree": {"draws": len(draws), "adjacent_per_draw_mean": float(np.mean(draws)),
                    "adjacent_per_draw_min": int(min(draws)), "of_per_draw": 7, "block": block},
        "voctree_total_gate": total_gate(draws, block),
    }
    print(json.dumps({"extras_reference": ref, "keypoints_per_view": {d: rep[d]["keypoints_per_view"]
                                                                       for d in ("akaze", "akaze_mldb")},
                      "sharp_frames": [k for k, s in enumerate(sharp) if s],
                      "chain_seconds": {k: v["seconds"] for k, v in rows.items()},
                      "voctree_seconds": time.perf_counter() - t1,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
