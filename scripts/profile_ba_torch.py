#!/usr/bin/env python3
"""Where the time of one LM iteration of the port's bundle adjuster goes, on
one GPU.

    python3 scripts/profile_ba_torch.py [--out DIR]

from the repository root, on a machine with a CUDA card. For each of the two
problems of chip_smoke.py (100 cameras / 10k landmarks, dense Schur solve;
1024 cameras / 300k landmarks, PCG with 8 CG iterations) it

1. times the pieces of one LM iteration with CUDA events (median of 10):
   the residual/Jacobian pass, the Schur prelude, the dense reduced solve
   (elimination factor, S = U - B B^T, Cholesky) or one PCG matvec, the
   back-substitution and the cost evaluation;
2. traces one LM iteration (`ba_solve(max_iters=1)`, after a warm-up) with
   torch.profiler and prints the device time by kernel and the device's
   busy share of the iteration's wall time;
3. counts the operations that made the host wait for the device during the
   iteration (CUDA's synchronization debug mode).

Prints JSON lines; with --out, also writes the profiler's tables there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.numeric import _f32_matmul_scope  # noqa: E402
from alicevision_tpu_torch.sfm import ba  # noqa: E402


def phases(problem, solver: str) -> dict:
    """Median device milliseconds of each piece of one LM iteration."""
    q, c, X = problem.cam_q, problem.cam_c, problem.points
    lam = torch.tensor(1e-4, device=q.device)
    huber = torch.tensor(4.0, device=q.device)
    C = q.shape[0]
    t = chip_smoke._time_ms
    with _f32_matmul_scope():
        r, Jc, Jl = ba._residuals_and_jacobians(problem, q, c, X)
        parts = ba._schur_prelude(problem, r, Jc, Jl, lam)
        out = {
            "residuals_jacobians_ms": t(lambda: ba._residuals_and_jacobians(problem, q, c, X), 10),
            "schur_prelude_ms": t(lambda: ba._schur_prelude(problem, r, Jc, Jl, lam), 10),
            "back_substitute_ms": t(lambda: ba._back_substitute(parts, parts.b), 10),
            "cost_ms": t(lambda: ba._cost(problem, q, c, X, huber), 10),
        }
        if solver == "dense":
            Bm = ba._elimination_factor(parts, C)
            S = ba._reduced_camera_matrix(parts, Bm, C)
            S.diagonal().add_(1e-8)
            out["elimination_factor_ms"] = t(lambda: ba._elimination_factor(parts, C), 10)
            out["reduced_matrix_ms"] = t(lambda: ba._reduced_camera_matrix(parts, Bm, C), 10)
            out["cholesky_solve_ms"] = t(lambda: ba._chol_solve(S, parts.b.reshape(-1)), 10)
            out["schur_solve_ms"] = t(lambda: ba._schur_solve(problem, r, Jc, Jl, lam), 10)
        else:
            S_apply, M_apply = ba._s_operator(parts, C, r.dtype)
            out["s_operator_setup_ms"] = t(lambda: ba._s_operator(parts, C, r.dtype), 10)
            out["pcg_matvec_ms"] = t(lambda: S_apply(parts.b), 10)
            out["preconditioner_apply_ms"] = t(lambda: M_apply(parts.b), 10)
            out["schur_solve_pcg_ms"] = t(
                lambda: ba._schur_solve_pcg(problem, r, Jc, Jl, lam, cg_iters=8, loop="fori"), 10
            )
    return out


def trace_iteration(name, problem, solve_kw, out_dir) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = dict(solve_kw, max_iters=1)
    ba.ba_solve(problem, **kw)  # warm-up
    torch.cuda.synchronize()
    _, syncs = chip_smoke._count_syncs(lambda: ba.ba_solve(problem, **kw))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ba.ba_solve(problem, **kw)
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
        with open(os.path.join(out_dir, f"profile_ba_{name}.txt"), "w") as f:
            f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "kernel_launches": sum(r[2] for r in rows),
        "host_syncs": syncs,
        "top_kernels": [{"kernel": k[:90], "device_ms": ms, "count": n} for k, ms, n in rows[:15]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the profiler's tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_ba_torch.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    cases = [
        ("headline", chip_smoke.make_headline_problem, "dense",
         dict(rtol=0.0, solver="dense", loop="unrolled")),
        ("large", chip_smoke.make_large_problem, "pcg",
         dict(rtol=0.0, solver="pcg", cg_iters=8, loop="unrolled")),
    ]
    for name, make, solver, kw in cases:
        problem = make(dev)
        print(f"phases {name} " + json.dumps(phases(problem, solver)), flush=True)
        print(f"iteration {name} " + json.dumps(trace_iteration(name, problem, kw, args.out)), flush=True)
        del problem
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
