#!/usr/bin/env python3
"""The JAX package's readings for chip_smoke.py's `aux` phase, on the CPU:
the numbers its gates (`chip_smoke.AUX_REFERENCE`, with the margins of
`chip_smoke.AUX_GATES`) are set from.

    python3 scripts/aux_reference.py [--work DIR] [--skip-front]

from the repository root. It makes the phase's inputs as the card does
(`chip_smoke.make_posed_scene`'s 8 views at 1280x960, `aux_photo` at 12 and
24 MP, `fcn_resnet50_onnx`, `make_lidar_inputs`, `gained_scene`) and runs
the JAX CLI on them: the cli phase's front (cameraInit, featureExtraction,
imageMatching, featureMatching: the features and matches the harmonization
reads), `chip_smoke.masking_chain`, imageSegmentation by the classical
scorer, sfmColorHarmonize and `chip_smoke.lidar_chain`. The FCN file is
written by the same function as on the card (its sha256 printed); the JAX
executor and the port's on the CPU run its two picked tiles, and the port's
logits are held to JAX's per pixel. It prints the readings as one JSON line:
paste the `aux_reference` object into chip_smoke.AUX_REFERENCE. With
`--skip-front`, a `--work` folder's earlier front is reused. About 10-15
minutes on 8 CPU threads, most of it JAX's DSP-SIFT and the graph cut.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from alicevision_tpu.pipeline import cli as jcli  # noqa: E402
from alicevision_tpu.utils.onnx_rt import OnnxModel as JaxOnnxModel  # noqa: E402
from alicevision_tpu_torch.utils.onnx_rt import OnnxModel  # noqa: E402


def run(chain: list, printed: dict | None = None) -> dict:
    """Each (name, argv) through the JAX CLI, timed; stdout kept by name."""
    secs = {}
    for name, argv in chain:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = jcli.main([name, *argv])
        if rc != 0:
            raise RuntimeError(f"JAX `{name} {' '.join(argv)}` exited {rc}")
        if printed is not None:
            printed[name] = buf.getvalue()
        secs[name if name not in secs else f"{name}#{len(secs)}"] = time.perf_counter() - t0
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None, help="keep the inputs and outputs here")
    ap.add_argument("--skip-front", action="store_true", help="reuse --work's cli front")
    args = ap.parse_args()
    work = args.work or tempfile.mkdtemp(prefix="aux_ref_")
    os.makedirs(work, exist_ok=True)
    cfg = chip_smoke.AUX
    seconds = {}
    t0 = time.perf_counter()
    images, cli = os.path.join(work, "images"), os.path.join(work, "cli")
    if not args.skip_front:
        chip_smoke.make_posed_scene(work, n_views=8)
        os.makedirs(cli, exist_ok=True)
        chain = [(n, a[1:]) for n, a in chip_smoke.cli_chain(cli, images)
                 if n in ("cameraInit", "featureExtraction", "imageMatching", "featureMatching")]
        seconds["front"] = run(chain)
    ax = os.path.join(work, "aux")
    os.makedirs(ax, exist_ok=True)
    photo = chip_smoke.aux_photo(cfg["photo_wh"], seed=0)
    photo_path, photo24 = os.path.join(ax, "photo.npy"), os.path.join(ax, "photo24.npy")
    np.save(photo_path, photo)
    np.save(photo24, chip_smoke.aux_photo(cfg["mask_photo_wh"], seed=1))
    fcn_path = os.path.join(ax, "fcn_resnet50.onnx")
    fcn = chip_smoke.fcn_resnet50_onnx(fcn_path, **cfg["fcn"])
    print(json.dumps({"fcn": fcn}), flush=True)
    lidar_in = chip_smoke.make_lidar_inputs(ax, cfg["lidar"]["samples"], cfg["lidar"]["seed"])
    gained = chip_smoke.gained_scene(cli, os.path.join(ax, "gained"), cfg["gains"])
    seconds["inputs"] = time.perf_counter() - t0

    out = os.path.join(ax, "run_jax")
    os.makedirs(out, exist_ok=True)
    printed = {}
    seconds["masking"] = run(chip_smoke.masking_chain(out, images, photo24, cfg))
    seconds["segmentation"] = run([("imageSegmentation", ["--input", photo_path, "--output",
                                                          os.path.join(out, "sky_mask.png")])])
    seconds["harmonize"] = run([("sfmColorHarmonize", ["--input", gained["sfm"], "--features",
                                                       os.path.join(cli, "features"), "--matches",
                                                       os.path.join(cli, "matches.npz"), "--imagesFolder",
                                                       os.path.dirname(gained["sfm"]), "--output",
                                                       os.path.join(out, "harmonized")])])
    seconds["lidar"] = run(chip_smoke.lidar_chain(out, lidar_in, cfg["lidar"]["cell"]), printed)

    from alicevision_tpu_torch.image.io import read_image

    masks = chip_smoke.mask_counts(out)
    lidar = chip_smoke.lidar_report(out, printed)

    # the FCN's picked tiles through both executors on the CPU
    t0 = time.perf_counter()
    tiles = chip_smoke.fcn_tiles(photo)
    jnet, tnet = JaxOnnxModel(fcn_path), OnnxModel(fcn_path, device="cpu")
    jl = [np.asarray(jnet(t)[0]) for t in tiles]
    tl = [tnet(t)[0].numpy() for t in tiles]
    classes = cfg["fcn"]["classes"]
    scale = max(float(np.abs(z).max()) for z in jl)
    seconds["fcn_tiles"] = time.perf_counter() - t0
    ref = {
        "mask_counts": {k: int(m.sum()) for k, m in masks.items()},
        "sky_classical_count": int((read_image(os.path.join(out, "sky_mask.png")) > 0.5).sum()),
        "fcn_sha256": fcn["sha256"],
        "fcn_tiles": {
            "tiles": [list(t.shape[2:]) for t in tiles],
            "jax_label_counts": [chip_smoke.label_counts(z, classes) for z in jl],
            "port_cpu_label_counts": [chip_smoke.label_counts(z, classes) for z in tl],
            "port_cpu_label_agreement": [float((np.argmax(a[0], 0) == np.argmax(b[0], 0)).mean())
                                         for a, b in zip(tl, jl)],
            "port_cpu_max_abs_logit_diff": max(float(np.abs(a - b).max()) for a, b in zip(tl, jl)),
            "logit_scale": scale,
        },
        "harmonize": chip_smoke.harmonize_recovery(os.path.join(out, "harmonized"), gained),
        "lidar": {k: lidar[k] for k in ("merged", "decimated", "mesh", "mesh_median_box_distance",
                                        "mesh_p90_box_distance")},
    }
    print(json.dumps({"seconds": seconds}), flush=True)
    print(json.dumps({"aux_reference": ref}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
