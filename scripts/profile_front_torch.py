#!/usr/bin/env python3
"""Where the time of the port's SfM front end goes, on one GPU.

    python3 scripts/profile_front_torch.py [--out DIR]

from the repository root, on a machine with a CUDA card. On chip_smoke.py's
rendered 8-view 1280x960 scene it

1. takes one featureExtraction batch — the 8 views resized to 1024x768 as
   the stage resizes them, `sift.extract` at the runner's 4096 keypoints —
   and times its pieces with CUDA events (median of 5): the resize, the
   scale space, and for each octave the detection, the orientation and the
   descriptors;
2. takes one featureMatching chunk — 8 view pairs — and times the batched
   top-2 match over the (8, 4096, 128) descriptor stacks and the pieces of
   the batched AC-RANSAC F (sampling, the 8 x 256 eight-point solves with
   their batched `eigh` and `svd` alone, the residual matrix, the
   a-contrario selection, the refit);
3. traces each of the two with torch.profiler after a warm-up and prints
   the device time by kernel, the launches and the device's busy share of
   the wall time, and counts the operations that made the host wait for
   the device (CUDA's synchronization debug mode).

Prints JSON lines; with --out, also writes the profiler's tables there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alicevision_tpu_torch import multiview as mv  # noqa: E402
from alicevision_tpu_torch import robust  # noqa: E402
from alicevision_tpu_torch.features import sift  # noqa: E402
from alicevision_tpu_torch.image.filtering import _resize_bilinear  # noqa: E402
from alicevision_tpu_torch.matching import descriptor_matching as dm  # noqa: E402
from alicevision_tpu_torch.numeric import _f32_matmul_scope  # noqa: E402
from alicevision_tpu_torch.robust.estimators import _gather_points  # noqa: E402
from alicevision_tpu_torch.utils.rendered import render_views  # noqa: E402

PAIRS = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7), (0, 2)]
SIZE = (1024, 768)
WH = (1280.0, 960.0)


def trace(name, fn, out_dir) -> dict:
    """fn() once as a warm-up, once with its host syncs counted, once
    under torch.profiler: wall time, device time by kernel, launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    _, syncs = chip_smoke._count_syncs(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    rows = sorted(
        ((e.key, dev_us(e) / 1e3, e.count) for e in events
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_front_{name}.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "kernel_launches": sum(r[2] for r in rows),
        "host_syncs": syncs,
        "top_kernels": [{"kernel": k[:90], "device_ms": ms, "count": n} for k, ms, n in rows[:15]],
    }


def extraction_phases(imgs, cfg) -> dict:
    """Median device milliseconds of the pieces of one extraction batch."""
    t = chip_smoke._time_ms
    x = _resize_bilinear(imgs, SIZE)
    octaves, steps = sift.build_scale_space(x, cfg)
    budget = max(256, cfg.max_keypoints // len(octaves))
    out = {
        "resize_ms": t(lambda: _resize_bilinear(imgs, SIZE), 5),
        "scale_space_ms": t(lambda: sift.build_scale_space(x, cfg), 5),
        "extract_ms": t(lambda: sift.extract(x, cfg), 5),
    }
    with _f32_matmul_scope():
        for o, (g, step) in enumerate(zip(octaves, steps)):
            _, _, _, level, _, (x_o, y_o, sig_o) = sift._detect_octave(g, step, cfg, budget)
            theta = sift._orientation(g, x_o, y_o, sig_o, level)
            out[f"octave{o}"] = {
                "shape": list(g.shape),
                "detect_ms": t(lambda: sift._detect_octave(g, step, cfg, budget), 5),
                "orientation_ms": t(lambda: sift._orientation(g, x_o, y_o, sig_o, level), 5),
                "descriptor_ms": t(lambda: sift._descriptor_raw(g, x_o, y_o, sig_o, theta, cfg, level), 5),
            }
    return out


def matching_chunk(f, n_hyps=256):
    """The chunk's inputs: descriptor stacks of the 8 pairs, and the padded
    putative correspondences of each pair as the stage builds them."""
    ii = torch.tensor([p[0] for p in PAIRS], device=f.desc.device)
    jj = torch.tensor([p[1] for p in PAIRS], device=f.desc.device)
    m = dm.match_bruteforce(f.desc[ii], f.desc[jj], f.valid[ii], f.valid[jj])
    idx2 = m.idx2.cpu().numpy()
    xy = f.xy.cpu().numpy()
    pms = [np.nonzero(idx2[g] >= 0)[0] for g in range(len(PAIRS))]
    cap = max(len(r) for r in pms)
    x1 = np.zeros((len(PAIRS), cap, 2), np.float32)
    x2 = np.zeros_like(x1)
    valid = np.zeros((len(PAIRS), cap), bool)
    for g, ((i, j), rows) in enumerate(zip(PAIRS, pms)):
        x1[g, : len(rows)] = xy[i, rows]
        x2[g, : len(rows)] = xy[j, idx2[g][rows]]
        valid[g, : len(rows)] = True
    dev = f.desc.device
    return ii, jj, *(torch.from_numpy(a).to(dev) for a in (x1, x2, valid)), [len(r) for r in pms]


def matching_phases(f, ii, jj, x1, x2, valid, n_hyps=256) -> dict:
    t = chip_smoke._time_ms
    gen = torch.Generator(device=x1.device).manual_seed(0)
    idx = robust.sample_minimal(gen, x1.shape[1], 8, n_hyps, valid)
    a, b = _gather_points(x1, idx), _gather_points(x2, idx)
    with _f32_matmul_scope():
        F = mv.fundamental_8pt(a, b)
        res = mv.epipolar_distance_sq(F, x1[:, None], x2[:, None])
        sel = robust.acransac_select(res, 8, robust.logalpha0_line(*WH), 0.5, valid, max_threshold_sq=16.0)
        A = mv.epipolar._epipolar_design(mv.normalize_points(a)[0], mv.normalize_points(b)[0])
        AtA = A.transpose(-1, -2) @ A
        return {
            "match_bruteforce_ms": t(lambda: dm.match_bruteforce(f.desc[ii], f.desc[jj], f.valid[ii], f.valid[jj]), 5),
            "sample_minimal_ms": t(lambda: robust.sample_minimal(gen, x1.shape[1], 8, n_hyps, valid), 5),
            "fundamental_8pt_hypotheses_ms": t(lambda: mv.fundamental_8pt(a, b), 5),
            "eigh_9x9_batch_ms": t(lambda: torch.linalg.eigh(AtA), 5),
            "svd_3x3_batch_ms": t(lambda: torch.linalg.svd(F), 5),
            "residual_matrix_ms": t(lambda: mv.epipolar_distance_sq(F, x1[:, None], x2[:, None]), 5),
            "acransac_select_ms": t(
                lambda: robust.acransac_select(res, 8, robust.logalpha0_line(*WH), 0.5, valid, max_threshold_sq=16.0), 5),
            "refit_ms": t(lambda: mv.fundamental_8pt(x1, x2, mask=sel.inliers), 5),
            "robust_fundamental_batch_ms": t(
                lambda: robust.robust_fundamental_batch(gen, x1, x2, WH, valid, n_hyps=n_hyps), 5),
            "hypotheses": list(F.shape[:2]),
            "residual_matrix_shape": list(res.shape),
        }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the profiler's tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_front_torch.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    imgs, *_ = render_views(8, (1280, 960), focal_px=1120.0, arc=0.6, seed=0)
    imgs = torch.from_numpy(imgs).to(dev)
    cfg = sift.SiftConfig(max_keypoints=chip_smoke.FRONT_MAX_KEYPOINTS, n_octaves=4)
    print("extraction_phases " + json.dumps(extraction_phases(imgs, cfg)), flush=True)
    print("extraction_trace " + json.dumps(
        trace("extraction", lambda: sift.extract(_resize_bilinear(imgs, SIZE), cfg), args.out)), flush=True)

    f = sift.extract(_resize_bilinear(imgs, SIZE), cfg)
    ii, jj, x1, x2, valid, counts = matching_chunk(f)
    print("matching_chunk " + json.dumps({"pairs": PAIRS, "putative": counts}), flush=True)
    print("matching_phases " + json.dumps(matching_phases(f, ii, jj, x1, x2, valid)), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def chunk():
        dm.match_bruteforce(f.desc[ii], f.desc[jj], f.valid[ii], f.valid[jj])
        return robust.robust_fundamental_batch(gen, x1, x2, WH, valid, n_hyps=256)

    print("matching_trace " + json.dumps(trace("matching", chunk, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
