"""The process runtime of the scale-out paths: one process a device.

Port of `alicevision_tpu/parallel/distributed.py` on `torch.distributed`.
The reference scales across machines with farm-chunked processes sharing a
filesystem (--rangeStart/--rangeSize with Meshroom); here one program runs
as one process a device, started by `torchrun` (or any launcher that sets
its variables):

  * `init_distributed()` once a process joins the process group (nccl on
    cards, gloo for `device="cpu"`); after it the ranks of the group make
    the 2-D mesh of `parallel/mesh.py`;
  * each rank loads its own contiguous block of views
    (`host_local_view_range`, the analog of a range chunk);
  * the primary rank (`is_primary()`) writes the stage files, which keeps
    the reference's resumable file contract.

The collectives of the scale-out modules go through `all_reduce`,
`all_gather` and `ring_exchange` below, which tally the bytes they move by
kind (`comm_bytes`, named as XLA names its collectives) for
`parallel/comms_report.py`. `launch_local` starts a world of local ranks
with torchrun's variables (the CPU tests and the comms report run gloo
ranks this way).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

# Bytes moved by this process's collectives since the last reset, by kind:
# all-reduce and all-gather count the result tensor, collective-permute
# the tensors received (the sizes XLA's HLO reports for the same kinds).
comm_bytes: dict = {}


def reset_comm_bytes() -> None:
    comm_bytes.clear()


def _tally(kind: str, n: int) -> None:
    comm_bytes[kind] = comm_bytes.get(kind, 0) + int(n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def init_distributed(
    device="cuda",
    master_addr: str | None = None,
    master_port: int | None = None,
    world_size: int | None = None,
    rank: int | None = None,
) -> bool:
    """Join the process group from the arguments or torchrun's variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the card).
    nccl for a CUDA `device`, gloo for `device="cpu"`.

    Returns True if a process group of more than one process was joined,
    False for a single-process run (no MASTER_ADDR, or a world of one)."""
    dev = resolve_device(device)
    addr = master_addr or os.environ.get("MASTER_ADDR")
    if addr is None:
        return False
    n = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    r = rank if rank is not None else int(os.environ.get("RANK", "0"))
    if n <= 1:
        return False
    port = master_port if master_port is not None else int(os.environ["MASTER_PORT"])
    join_group(dev, addr, port, n, r)
    return True


def join_group(device, addr: str, port: int, world_size: int, rank: int) -> None:
    """Join the process group at tcp://addr:port as `rank` of `world_size`:
    nccl on this process's card (`local_device`) for a CUDA `device`, gloo
    for the CPU. `init_distributed` calls it for a world of more than one;
    a caller may call it for a group of one, whose collectives then run
    over the backend and return their input."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(dev.type))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{addr}:{port}", world_size=world_size, rank=rank,
    )


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes stage files."""
    return process_index() == 0


def local_device(device="cuda") -> torch.device:
    """This process's device: `cuda:{LOCAL_RANK}` for a CUDA device, else
    the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def host_local_view_range(n_views: int) -> tuple[int, int]:
    """(start, count) of the contiguous views this rank loads from disk,
    the in-process analog of the reference's --rangeStart/--rangeSize."""
    p, n = process_index(), process_count()
    per = (n_views + n - 1) // n
    start = p * per
    return start, min(per, n_views - start)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` across the group in place; returns it."""
    _tally("all-reduce", _nbytes(t))
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` stacked along a new leading axis, in rank order."""
    n = dist.get_world_size(group)
    out = [torch.empty_like(t) for _ in range(n)]
    _tally("all-gather", n * _nbytes(t))
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def gather_to_primary(t: torch.Tensor, group=None, dst: int = 0):
    """Every rank's `t` concatenated along the leading axis on rank `dst`
    (a global rank); None on the other ranks."""
    n = dist.get_world_size(group)
    me = dist.get_rank()
    out = [torch.empty_like(t) for _ in range(n)] if me == dst else None
    if me == dst:
        _tally("gather", n * _nbytes(t))
    dist.gather(t.contiguous(), out, dst=dst, group=group)
    return torch.cat(out) if me == dst else None


def ring_exchange(to_next: torch.Tensor, to_prev: torch.Tensor, nxt: int, prv: int, group=None):
    """One ring step both ways: send `to_next` to rank `nxt` and `to_prev`
    to rank `prv`; return (what `prv` sent forward, what `nxt` sent back).
    The four point-to-point operations go in one `batch_isend_irecv`, in the
    same order on every rank (NCCL matches a peer pair's operations by
    order, gloo by tag), so a ring of two ranks pairs them right."""
    from_prev = torch.empty_like(to_next)
    from_next = torch.empty_like(to_prev)
    ops = [
        dist.P2POp(dist.isend, to_next.contiguous(), nxt, group, tag=0),
        dist.P2POp(dist.isend, to_prev.contiguous(), prv, group, tag=1),
        dist.P2POp(dist.irecv, from_prev, prv, group, tag=0),
        dist.P2POp(dist.irecv, from_next, nxt, group, tag=1),
    ]
    _tally("collective-permute", _nbytes(from_prev) + _nbytes(from_next))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def free_port() -> int:
    """A free local TCP port (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(target: str, world_size: int, inputs: dict, workdir: str, device: str = "cpu",
                 timeout: float = 120.0, path=()) -> list:
    """Run `target` ("package.module:function") on `world_size` local ranks
    and return each rank's result, in rank order.

    Each rank is a `python -m alicevision_tpu_torch.parallel.launch`
    process with torchrun's variables set (MASTER_ADDR=127.0.0.1 on a free
    port, WORLD_SIZE, RANK, LOCAL_RANK). It joins the group through
    `init_distributed(device)`, calls `function(inputs, device)` with the
    arrays of `inputs` (saved once to `workdir/inputs.npz`) and saves the
    dict of arrays it returns (`path`: more folders the ranks import from,
    besides this repository). Every rank gets `timeout` seconds: past it
    all ranks are killed and this raises, so a rank that waits for a
    collective its peers never start cannot hang the caller."""
    os.makedirs(workdir, exist_ok=True)
    src = os.path.join(workdir, "inputs.npz")
    np.savez(src, **inputs)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world_size), PYTHONPATH=os.pathsep.join(
                   [root, *path] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    for r in range(world_size):
        out = os.path.join(workdir, f"rank{r}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "alicevision_tpu_torch.parallel.launch", target, src, out, device],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    deadline = time.monotonic() + timeout
    logs, failed = [], []
    try:
        for r, p in enumerate(procs):
            try:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"{target}: rank {r} of {world_size} ran past {timeout} s") from None
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{logs[-1][-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"{target} on {world_size} ranks: " + "\n".join(failed))
    results = []
    for r in range(world_size):
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results
