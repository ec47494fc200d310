#!/usr/bin/env python3
"""What bounds the SGM sweep kernel: compile-time variants of
`alicevision_tpu_torch/csrc/sgm_directional.cu`, timed on one GPU.

    python3 scripts/sgm_kernel_variants.py

from the repository root, on a machine with a CUDA card and `nvcc`. It
builds the kernel source as it is ("base") and with one change each
(the source is edited in memory, the repository's file is not touched):

- "K4", "K16": the register-carry kernel's ring 4 or 16 steps deep;
- "nocopy": no cp.async copies (the kernels compute on stale shared
  memory): what is left is the serial chain and the instruction stream;
- "nocopy_nostore": neither copies nor stores of the register-carry kernel;
- "every_width": a register-carry kernel for every width of 1 to 16 values
  a lane (64 instantiations), where the source rounds the width up to a
  rung of 1, 2, 3, 4, 6, 8, 12, 16: what the rounding costs (D = 320 runs
  10 values a lane there, 12 here).

It times each with CUDA events (median of 30 launches, ms a launch) as one
sweep of chip_smoke.py's TIMED_SHAPES and as the two accumulating sweeps of
a (D, 480, 640) volume at D = 96 and 320 (horizontal and vertical).
Prints one line a timing.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from alicevision_tpu_torch.ops import build  # noqa: E402

SOURCE = os.path.join(ROOT, "alicevision_tpu_torch", "csrc", "sgm_directional.cu")
FLAGS = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
VARIANTS = {
    "base": [],
    "K4": ["-DSGM_K=4"],
    "K16": ["-DSGM_K=16"],
    "nocopy": ["-DSGM_NO_COPY=1"],
    "nocopy_nostore": ["-DSGM_NO_COPY=1", "-DSGM_NO_STORE=1"],
    "every_width": ["-DSGM_EVERY_WIDTH=1"],
}
RUNGS = "1, 2, 3, 4, 6, 8, 12, 16"
EVERY_WIDTH = ", ".join(map(str, range(1, 17)))


def _edit(src: str, old: str, new: str, count: int) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"the kernel source no longer has {count} of {old!r}")
    return src.replace(old, new)


def variant_source() -> str:
    """The kernel source with the four switches (off unless defined)."""
    src = open(SOURCE).read()
    src = _edit(src, "__host__ __device__ constexpr int ring_depth(int vpl) {\n",
                "__host__ __device__ constexpr int ring_depth(int vpl) {\n"
                "#ifdef SGM_K\n  return SGM_K;\n#endif\n", 1)
    src = _edit(src, "    if (s_in < w.S) {", "    if (!SGM_NO_COPY && s_in < w.S) {", 2)
    src = _edit(src, "      if (d < D) o_s[d] = ",
                "      if (d < D && (!SGM_NO_STORE || nl == -1.f)) o_s[d] = ", 1)
    src = _edit(src, f"dispatch_rungs<{RUNGS}>(", "dispatch_rungs<SGM_RUNGS>(", 1)
    return "#ifndef SGM_NO_COPY\n#define SGM_NO_COPY 0\n#endif\n" \
           "#ifndef SGM_NO_STORE\n#define SGM_NO_STORE 0\n#endif\n" \
           f"#ifdef SGM_EVERY_WIDTH\n#define SGM_RUNGS {EVERY_WIDTH}\n" \
           f"#else\n#define SGM_RUNGS {RUNGS}\n#endif\n" + src


def build_variants(work: str) -> dict:
    """{name: the C entry sgm_sweep_f32 of that variant}, built in parallel."""
    src = os.path.join(work, "variant.cu")
    with open(src, "w") as f:
        f.write(variant_source())
    nvcc = build._nvcc()
    jobs = {}
    for name, defs in VARIANTS.items():
        lib = os.path.join(work, f"lib{name}.so")
        jobs[name] = (subprocess.Popen([nvcc, *FLAGS, *defs, "-o", lib, src], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(lib).sgm_sweep_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_ms(call, reps: int = 30) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if call() != 0:
            raise RuntimeError("launch failed")
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("sgm_kernel_variants.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = tempfile.mkdtemp(prefix=".chip_smoke_variants_", dir=ROOT)
    try:
        fns = build_variants(work)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for S, N, D in chip_smoke.TIMED_SHAPES:
            cost = torch.rand(S, N, D, device=dev) * 100
            p2 = torch.rand(S, N, device=dev) * 50 + 10
            out = torch.empty_like(cost)
            ptrs = (cost.data_ptr(), p2.data_ptr(), out.data_ptr())
            for name, fn in fns.items():
                ms = time_ms(lambda: fn(*ptrs, 1, S, N, D, 0, D, N * D, 0, 1, N, 10.0, 0, dev.index,
                                        stream))
                print(f"sweep {S},{N},{D} {name}: {ms:.4f} ms", flush=True)
            del cost, p2, out
        H, W = 480, 640
        for D in (96, 320):  # the two accumulating sweeps of sgm_aggregate
            vol = torch.rand(H, W, D, device=dev) * 255
            p2 = torch.rand(H, W, device=dev) * 90 + 10
            total = torch.rand(H, W, D, device=dev)
            ptrs = (vol.data_ptr(), p2.data_ptr(), total.data_ptr())
            for name, fn in fns.items():
                ms_h = time_ms(lambda: fn(*ptrs, 1, W, H, D, 0, W * D, D, 0, W, 1, 10.0, 1, dev.index,
                                          stream))
                ms_v = time_ms(lambda: fn(*ptrs, 1, H, W, D, 0, D, W * D, 0, 1, W, 10.0, 1, dev.index,
                                          stream))
                print(f"accumulate {H},{W},{D} {name}: horizontal {ms_h:.4f} ms, "
                      f"vertical {ms_v:.4f} ms", flush=True)
            del vol, p2, total
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
