"""Rank functions of the port's multi-process tests: targets of
`alicevision_tpu_torch.parallel.distributed.launch_local`, each called as
fn(inputs, device) on every rank of a gloo world, returning a dict of
arrays."""

import os
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def sleep_forever(inputs, device):
    """A rank that never returns."""
    time.sleep(3600)


def fails(inputs, device):
    raise ValueError("this rank fails")


def ba_solve_rank(inputs, device):
    """parallel.ba_sharded.solve_sharded over the whole world on the problem
    of `problem_arrays`, for `max_iters`, with each solver of `solvers`:
    "<solver>.<BAResult field>" (the points of all ranks)."""
    from alicevision_tpu_torch.parallel.ba_sharded import problem_from_arrays, solve_sharded
    from alicevision_tpu_torch.parallel.mesh import make_mesh

    problem = problem_from_arrays(inputs, device)
    mesh = make_mesh()
    out = {}
    for solver in str(inputs["solvers"]).split(","):
        res = solve_sharded(problem, mesh, int(inputs["max_iters"]), solver=solver)
        out.update({f"{solver}.{k}": np.asarray(v.cpu()) for k, v in res._asdict().items()})
    return out


def fusion_rank(inputs, device):
    """The ring-halo filter over the world's ranks for each case i of
    `cases` (rows of V, k): the stack's first V views, this rank's block
    passed alone (`case{i}.local.*`) and as the whole stack
    (`case{i}.whole.*`), each gathered on the primary."""
    import torch

    from alicevision_tpu_torch.mvs.sharded import gather_to_primary, make_sharded_consistency_filter
    from alicevision_tpu_torch.parallel import distributed
    from alicevision_tpu_torch.parallel.mesh import AXES, make_mesh, shard_leading

    mesh = make_mesh(n_landmark=1)
    out = {}
    for i, (V, k) in enumerate(inputs["cases"]):
        d, K, R, c = (inputs[n][:V] for n in ("depths", "K", "R", "c"))
        fuse = make_sharded_consistency_filter(mesh, k=int(k), device=device)
        for form, depths in (("local", shard_leading(mesh, AXES, d)), ("whole", d)):
            distributed.reset_comm_bytes()
            filt, counts = fuse(depths, K, R, c)
            got = (gather_to_primary(filt, mesh), gather_to_primary(counts, mesh))
            out[f"case{i}.{form}.permute_bytes"] = np.asarray(distributed.comm_bytes.get("collective-permute", 0))
            if got[0] is not None:
                out[f"case{i}.{form}.filt"] = got[0].numpy()
                out[f"case{i}.{form}.counts"] = got[1].to(torch.int32).numpy()
    return out


def sgm_rank(inputs, device):
    """mvs.sharded.make_sharded_sgm over the world's ranks on `batched_sgm`'s
    arrays, the depth maps gathered on the primary."""
    from alicevision_tpu_torch.mvs.plane_sweep import SgmParams
    from alicevision_tpu_torch.mvs.sharded import gather_to_primary, make_sharded_sgm
    from alicevision_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    params = SgmParams(n_depths=int(inputs["n_depths"]), method=str(inputs["method"]))
    names = ("ref_imgs", "t_imgs", "K_ref", "K_t", "R_rel", "t_rel", "depths")
    depth, _ = make_sharded_sgm(mesh, params, device=device)(*(inputs[n] for n in names))
    full = gather_to_primary(depth, mesh)
    return {} if full is None else {"depth": full.numpy()}
