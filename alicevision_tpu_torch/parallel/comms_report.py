"""Collective-traffic accounting for the sharded BA and the sharded fusion.

Port of `alicevision_tpu/parallel/comms_report.py`. Scaling over several
devices cannot be timed on one; what can be counted exactly is what the
sharded programs move: the bytes of their collectives against the work
each shard does. The JAX package reads both off the compiled XLA program
(`collective_bytes` of its HLO text, XLA's cost analysis). The port has no
HLO: it runs its sharded programs (`parallel/ba_sharded.py`,
`mvs/sharded.py::make_sharded_consistency_filter`) and tallies the bytes
its own collectives move (`distributed.comm_bytes`: all-reduce the summed
tensor, collective-permute the halo maps received) and counts the
floating-point operations of a shard with
`torch.utils.flop_counter.FlopCounterMode`.

That counter sees matrix products and convolutions only (mm, bmm, addmm,
einsums that lower to them, conv); elementwise work is not in it. So a
row's `flops_per_shard` is the BA's dense -B B^T product and the 3x3 / 6x6
einsums of its operator, not its per-observation Jacobian planes, and the
fusion's per-pixel 3x3 rotations (einsums), not its comparisons: a lower
bound on a shard's work, comparable across shard counts.

`projected_ici_efficiency` = t_compute / (t_compute + t_comms), from a link
rate (GB/s) and a compute rate (TFLOP/s) that the caller states for the
hardware in question; without both it is None.
"""

from __future__ import annotations

import re
import tempfile

import numpy as np

_SHAPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "s32": 4, "u64": 8, "u32": 4, "s8": 1, "u8": 1, "pred": 1,
}
_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)
_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|s32|u64|u32|s8|u8|pred)\[([0-9,]*)\]")


def _shapes_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _SHAPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """{collective_kind: result bytes} summed over an HLO module's text.

    Handles both scalar results ("f32[6,128]{1,0} all-reduce(...") and
    TUPLE results ("(f32[32,21]{1,0}, f32[...]) all-reduce(..." — XLA
    fuses several psums into one tuple all-reduce)."""
    out: dict = {}
    for line in hlo_text.splitlines():
        ls = line.strip()
        if "=" not in ls:
            continue
        rhs = ls.split("=", 1)[1]
        for kind in _COLLECTIVES:
            m = re.search(rf"^\s*(.+?)\s+{kind}[(.]", rhs)
            if m:
                out[kind] = out.get(kind, 0) + _shapes_bytes(m.group(1))
                break
    return out


def _row(n: int, coll: dict, flops: float, link_gbps, tflops) -> dict:
    total = sum(coll.values())
    eff = None
    if link_gbps is not None and tflops is not None:
        t_compute = flops / (tflops * 1e12)
        t_comms = total / (link_gbps * 1e9)
        eff = round(t_compute / max(t_compute + t_comms, 1e-30), 4)
    return {
        "shards": n,
        "collective_bytes": int(total),
        "by_kind": {k: int(v) for k, v in coll.items()},
        "flops_per_shard": float(flops),
        "bytes_per_flop": total / max(flops, 1.0),
        "projected_ici_efficiency": eff,
    }


def _measure(run) -> tuple:
    """(bytes by kind, FLOPs) of one call of `run` in this process."""
    from torch.utils.flop_counter import FlopCounterMode

    from . import distributed

    distributed.reset_comm_bytes()
    with FlopCounterMode(display=False) as fc:
        run()
    return dict(distributed.comm_bytes), float(fc.get_total_flops())


def _rows(target: str, shard_counts, inputs_of, device: str, link_gbps, tflops, timeout: float) -> list:
    """One shard in this process on `device`; n > 1 shards on n local gloo
    ranks, each row the largest of its ranks' tallies."""
    import importlib

    from . import distributed

    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    rows = []
    for n in shard_counts:
        inputs = inputs_of(n)
        if inputs is None:
            continue
        if n == 1:
            out = [fn(inputs, device)]
        else:
            with tempfile.TemporaryDirectory() as work:
                out = distributed.launch_local(target, n, inputs, work, timeout=timeout)
        kinds = {k[len("bytes."):] for o in out for k in o if k.startswith("bytes.")}
        coll = {k: max(int(o.get("bytes." + k, 0)) for o in out) for k in sorted(kinds)}
        rows.append(_row(n, coll, max(float(o["flops"]) for o in out), link_gbps, tflops))
    return rows


def _tally_out(coll: dict, flops: float) -> dict:
    out = {"bytes." + k: np.asarray(v) for k, v in coll.items()}
    out["flops"] = np.asarray(flops)
    return out


def ba_tally_rank(inputs: dict, device) -> dict:
    """One shard of `ba_comms_table`: one LM iteration of the sharded BA on
    this rank's block, tallied."""
    from .ba_sharded import make_sharded_ba, problem_from_arrays, shard_problem
    from .mesh import make_mesh

    mesh = make_mesh(n_view=1)
    local = shard_problem(problem_from_arrays(inputs, device), mesh)
    solve = make_sharded_ba(mesh, max_iters=1, solver=str(inputs["solver"]))
    return _tally_out(*_measure(lambda: solve(local)))


def ba_problem(n_views: int, n_points: int, max_track: int = 6, device="cuda"):
    """The ring problem the comms tables solve: the port's
    `utils/synthetic.ring_scene` seen by up to `max_track` cameras a
    landmark, points moved by 0.02 (seeded), the first two cameras fixed
    (the JAX package's toy problem)."""
    from .. import camera as cam
    from ..sfm import ba
    from ..utils.synthetic import ring_scene

    scene = ring_scene(n_views=n_views, n_points=n_points, seed=0, device="cpu")
    vis = scene.visible.numpy()
    keep = np.cumsum(vis, axis=0) <= max_track
    o_cam, o_lm = np.nonzero(vis & keep)
    o_uv = scene.observations.numpy()[o_cam, o_lm]
    pts0 = scene.points.numpy() + 0.02 * np.random.RandomState(0).randn(n_points, 3).astype(np.float32)
    return ba.build_problem(
        scene.poses.q, scene.poses.c, pts0, cam.Intrinsics(*(a[None] for a in scene.intrinsics)),
        o_lm, o_cam, np.zeros(len(o_lm), np.int32), o_uv, max_track=max_track,
        cam_fixed=np.arange(n_views) < 2, device=device,
    )


def ba_comms_table(
    shard_counts=(1, 2, 4, 8),
    n_points_per_shard: int = 1024,
    n_views: int = 32,
    link_gbps: float | None = None,
    tflops: float | None = None,
    solver: str = "dense",
    device="cuda",
    timeout: float = 300.0,
) -> list[dict]:
    """Collective bytes against a shard's FLOPs for ONE LM iteration of the
    sharded BA, at each shard count, with `n_points_per_shard` landmarks a
    shard (weak scaling). One shard runs in this process on `device`,
    more on that many local gloo ranks on the CPU. One row a shard count:
    shards, collective_bytes, by_kind, flops_per_shard, bytes_per_flop,
    projected_ici_efficiency (see the module's docstring for what the FLOPs
    cover and when the efficiency is None)."""
    from .ba_sharded import problem_arrays

    def inputs_of(n):
        p = ba_problem(n_views, n_points_per_shard * n, device="cpu")
        return dict(problem_arrays(p), solver=np.asarray(solver))

    return _rows("alicevision_tpu_torch.parallel.comms_report:ba_tally_rank", shard_counts, inputs_of, device,
                 link_gbps, tflops, timeout)


def fusion_scene(V: int, hw):
    """fusion_comms_table's stack: V random depth maps in [2, 8] and
    cameras turning on a 0.5 rad arc (the JAX package's inputs)."""
    H, W = hw
    rng = np.random.RandomState(0)
    depths = rng.uniform(2.0, 8.0, (V, H, W)).astype(np.float32)
    K = np.tile(np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32), (V, 1, 1))
    ang = np.linspace(0, 0.5, V)
    R = np.stack([
        np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
        for a in ang
    ])
    c = np.stack([np.array([0.5 * a, 0, 0], np.float32) for a in ang])
    return depths, K, R, c


def fusion_tally_rank(inputs: dict, device) -> dict:
    """One shard of `fusion_comms_table`: the ring-halo filter on this
    rank's block of the stack, tallied."""
    from ..mvs.sharded import make_sharded_consistency_filter
    from .mesh import make_mesh

    fuse = make_sharded_consistency_filter(make_mesh(n_landmark=1), k=int(inputs["k"]), device=device)
    return _tally_out(*_measure(lambda: fuse(inputs["depths"], inputs["K"], inputs["R"], inputs["c"])))


def fusion_comms_table(
    shard_counts=(1, 2, 4, 8),
    V: int = 32,
    hw=(272, 480),
    k: int = 4,
    link_gbps: float | None = None,
    tflops: float | None = None,
    device="cuda",
    timeout: float = 300.0,
) -> list[dict]:
    """Collective bytes of the SHARDED DEPTH FUSION: the ring-halo
    `make_sharded_consistency_filter` at each shard count that divides V
    (2·k boundary maps a shard, whatever V and the shard count) against a
    shard's FLOPs. One shard runs in this process on `device`, more on
    that many local gloo ranks on the CPU. Rows as `ba_comms_table`'s."""
    depths, K, R, c = fusion_scene(V, hw)

    def inputs_of(n):
        return None if V % n else {"depths": depths, "K": K, "R": R, "c": c, "k": np.asarray(k)}

    return _rows("alicevision_tpu_torch.parallel.comms_report:fusion_tally_rank", shard_counts, inputs_of, device,
                 link_gbps, tflops, timeout)
