"""One rank of a local world: `distributed.launch_local`'s worker.

    python -m alicevision_tpu_torch.parallel.launch MODULE:FUNCTION IN.npz OUT.npz [DEVICE]

with torchrun's variables set (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK). It joins the process group (`init_distributed(DEVICE)`, gloo
for the default `cpu`), calls FUNCTION(inputs, DEVICE) with the arrays of
IN.npz, saves the dict of arrays it returns to OUT.npz, and leaves the
group.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from .distributed import init_distributed


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    target, src, out = argv[:3]
    device = argv[3] if len(argv) > 3 else "cpu"
    torch.set_num_threads(1)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    with np.load(src) as f:
        inputs = {k: f[k] for k in f.files}
    joined = init_distributed(device)
    try:
        result = fn(inputs, device)
    finally:
        if joined:
            dist.destroy_process_group()
    np.savez(out, **{k: np.asarray(v) for k, v in result.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
