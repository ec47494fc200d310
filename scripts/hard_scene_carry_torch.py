#!/usr/bin/env python3
"""Hold the port's joint intrinsics refinement to the JAX package's on the
hard scene, step by step, on the CPU.

    python3 scripts/hard_scene_carry_torch.py [--prior normal|stressed] [--refines N]

Runs the JAX package's incremental engine on `hard_scene(40, 600)`'s
verified matches with a RADIALK3 prior of zeros (the normal prior: focal
2 % off; the stressed one: 10 % off and a (20, -12) px principal point),
as tests/test_hard_scene.py does. Before each of its first N
`refine_intrinsics_now` calls, the JAX engine's state is carried into a
port engine (`convert.carry_engine_state`), both engines take the step,
and one line compares them: the refined focal, principal point and K3 of
each, their largest differences, the largest difference of the
undistorted observations that `_recompute_obs_norm` leaves (and how many
are not finite), and of the posed centres. Needs JAX (CPU) and the port;
about a minute a refine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from alicevision_tpu import camera as jcam  # noqa: E402
from alicevision_tpu.sfm.incremental import IncrementalConfig as JConfig  # noqa: E402
from alicevision_tpu.sfm.incremental import IncrementalSfM as JEngine  # noqa: E402
from alicevision_tpu.tracks.builder import build_tracks  # noqa: E402
from alicevision_tpu.utils.rendered import hard_scene, verified_matches_from_scene  # noqa: E402
from alicevision_tpu_torch import convert  # noqa: E402
from alicevision_tpu_torch.sfm.incremental import IncrementalConfig, IncrementalSfM  # noqa: E402

PRIORS = {"normal": (1.02, (0.0, 0.0)), "stressed": (1.10, (20.0, -12.0))}


class _Done(Exception):
    pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prior", choices=sorted(PRIORS), default="stressed")
    ap.add_argument("--refines", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    hs = hard_scene(40, 600)
    pm, fxy, nf = verified_matches_from_scene(hs)
    tracks = build_tracks(pm, nf, min_track_length=2)
    w, h = hs.image_size
    focal, offset = PRIORS[args.prior]
    intr = jcam.make_intrinsics(w, h, float(hs.K[0, 0]) * focal, disto_kind=jcam.DISTO_RADIALK3,
                                disto_params=(0.0, 0.0, 0.0), offset=offset)
    intr = [np.asarray(x)[None] for x in intr]
    sizes = np.tile([w, h], (40, 1))
    ref = JEngine(tracks, fxy, jcam.Intrinsics(*intr), np.zeros(40, np.int32), sizes,
                  JConfig(robust_triangulation=True, seed=0))
    port_tracks = convert.tracks_from_numpy(np.asarray(tracks.track_ids), np.asarray(tracks.views),
                                            np.asarray(tracks.features), tracks.n_tracks)
    step = ref.refine_intrinsics_now
    done = [0]

    def carried_refine():
        port = IncrementalSfM(port_tracks, fxy, intr, np.zeros(40, np.int32), sizes,
                              IncrementalConfig(robust_triangulation=True, seed=0), device="cpu")
        convert.carry_engine_state(ref, port)
        n_posed = int(ref.res.posed.sum())
        port.refine_intrinsics_now()
        step()
        a, b = ref.intr_np, port.intr_np

        def diff(name):
            return float(np.abs(np.asarray(getattr(a, name), np.float64) - getattr(b, name)).max())

        on, pn = np.asarray(ref.obs_norm), port.obs_norm
        fin = np.isfinite(on).all(1) & np.isfinite(pn).all(1)
        print(json.dumps({
            "posed": n_posed,
            "jax": {"focal": np.asarray(a.scale).ravel().tolist(), "pp": np.asarray(a.offset).ravel().tolist(),
                    "k": np.asarray(a.disto).ravel()[:3].tolist()},
            "port": {"focal": b.scale.ravel().tolist(), "pp": b.offset.ravel().tolist(),
                     "k": b.disto.ravel()[:3].tolist()},
            "max_diff": {"focal": diff("scale"), "pp": diff("offset"), "k": diff("disto"),
                         "obs_norm": float(np.abs(on - pn)[fin].max()),
                         "centres": float(np.abs(ref.res.pose_c - port.res.pose_c)[ref.res.posed].max())},
            "obs_norm_not_finite": {"jax": int((~np.isfinite(on).all(1)).sum()),
                                    "port": int((~np.isfinite(pn).all(1)).sum())},
        }), flush=True)
        done[0] += 1
        if done[0] >= args.refines:
            raise _Done

    ref.refine_intrinsics_now = carried_refine
    try:
        ref.process()
    except _Done:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
