#!/usr/bin/env python3
"""The K-draw count gates of chip_smoke.py's `localization` phase, set from
the JAX package's readings on card reconstructions.

    python3 scripts/localization_gates_reference.py [--readings FILE] [--draws K] [--alpha A]

Reads scripts/localization_k_draw_readings.json (the JAX CLI's queries right
a draw, `scripts/localization_reference.py --keys K --sweep-only`, per saved
card reconstruction) and, for each run of `chip_smoke.LOC_SWEEP_RUNS`, fits
a two-level model to JAX's draws: a reconstruction's rate of queries right
a draw, spread over reconstructions with variance sb^2, and its draws about
that rate with variance sw^2 (pooled within reconstructions). A K-draw total
then has mean K*mu and variance K*sw^2 + K^2*sb^2, and the gate is its
`alpha` quantile (normal approximation), floored: a tree that localizes as
the JAX package does falls under it in about `alpha` of its runs, whatever
reconstruction the card's incrementalSfm gives that run. Where K times the
fewest JAX read in any one draw is higher, that is the gate: direct
matching at 2x reads 3-5 of 8 a draw by the reconstruction (its spread is
between reconstructions and skewed upwards, so the normal tail reaches far
under every reading) and never under 2.

It prints one JSON line: each run's fit, its gate, and, as a check on the
model, the share of runs under the gate when the runs are drawn from JAX's
own readings (a reconstruction read, then K of its draws, with
replacement), both as read and with each right query kept with probability
f < 1 (a fault that loses a share 1 - f of what a sound tree localizes),
beside the share under the gates this one replaces: the single draw of the
CLI (`single`) and the 8-draw total at JAX's lowest 8-draw reading
(`k8_lowest`). Needs only numpy; runs in about ten seconds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from statistics import NormalDist

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READINGS = os.path.join(ROOT, "scripts", "localization_k_draw_readings.json")
RUNS = ("voctree", "voctree_full", "voctree_crop", "voctree_2x", "direct_2x")
# the gates this one replaces: right in the CLI's one draw (the 2x runs had
# none), and the 8-draw total at JAX's lowest 8-draw reading
SINGLE = {"voctree": 0, "voctree_full": 2, "voctree_crop": 1}
K8_LOWEST = {"voctree": 0, "voctree_full": 14, "voctree_crop": 9, "voctree_2x": 3, "direct_2x": 23}
KEEP = (1.0, 0.9, 0.75, 0.5)


def jax_draws(readings: dict, run: str) -> list:
    """JAX's queries right a draw on each reconstruction, every block of
    keys read there concatenated."""
    return [np.concatenate([np.asarray(b[run]["right"], float) for b in rec["jax_cpu"]])
            for rec in readings["reconstructions"].values()]


def fit(draws: list) -> dict:
    """mu, sw (within a reconstruction) and sb (between reconstructions) of
    the queries right a draw."""
    n = np.array([len(d) for d in draws], float)
    means = np.array([d.mean() for d in draws])
    sw2 = sum(((d - d.mean()) ** 2).sum() for d in draws) / (n.sum() - len(draws))
    sb2 = max(0.0, float(means.var(ddof=1) - np.mean(sw2 / n)))
    return {"mu": float(np.concatenate(draws).mean()), "sw": math.sqrt(sw2), "sb": math.sqrt(sb2),
            "fewest": int(min(d.min() for d in draws)), "reconstructions": len(draws), "draws": int(n.sum())}


def gate(f: dict, k: int, alpha: float) -> int:
    """The K-draw total's alpha quantile under the fit, floored, or K times
    the fewest right in one draw where that is higher."""
    z = NormalDist().inv_cdf(1.0 - alpha)
    q = k * f["mu"] - z * math.sqrt(k * f["sw"] ** 2 + k * k * f["sb"] ** 2)
    return max(0, math.floor(q), k * f["fewest"])


def under(draws: list, k: int, want: int, keep: float, trials: int, rng) -> float:
    """The share of K-draw runs drawn from JAX's readings (a reconstruction,
    then k of its draws) whose total, each right query kept with
    probability `keep`, falls under `want`."""
    rec = rng.integers(0, len(draws), trials)
    tot = np.zeros(trials)
    for i, d in enumerate(draws):
        sel = rec == i
        x = d[rng.integers(0, len(d), (int(sel.sum()), k))].astype(np.int64)
        tot[sel] = rng.binomial(x, keep).sum(1)
    return float((tot < want).mean())


def k_draw_gates(readings: dict, k: int, alpha: float) -> dict:
    """{run: gate} for `RUNS`."""
    return {run: gate(fit(jax_draws(readings, run)), k, alpha) for run in RUNS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--readings", default=READINGS)
    ap.add_argument("--draws", type=int, default=32, help="K, the draws a run's total sums")
    ap.add_argument("--alpha", type=float, default=1e-3, help="the share of sound runs the gate may fail")
    ap.add_argument("--trials", type=int, default=200000)
    args = ap.parse_args()
    with open(args.readings) as fh:
        readings = json.load(fh)
    rng = np.random.default_rng(0)
    out = {}
    for run in RUNS:
        draws = jax_draws(readings, run)
        f = fit(draws)
        g = gate(f, args.draws, args.alpha)
        row = {"fit": f, "gate": g, "per_draw": g / args.draws,
               "under": {str(p): under(draws, args.draws, g, p, args.trials, rng) for p in KEEP},
               "k8_lowest": K8_LOWEST[run],
               "under_k8_lowest": {str(p): under(draws, 8, K8_LOWEST[run], p, args.trials, rng) for p in KEEP}}
        if run in SINGLE:
            row["single"] = SINGLE[run]
            row["under_single"] = {str(p): under(draws, 1, SINGLE[run], p, args.trials, rng) for p in KEEP}
        out[run] = row
    print(json.dumps({"draws": args.draws, "alpha": args.alpha, "gates": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
