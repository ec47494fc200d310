"""The SGM directional sweep: hand-written CUDA kernel + its dispatch.

Replaces the Pallas TPU kernel `alicevision_tpu/ops/sgm_pallas.py`
(`sgm_directional_pass`). The kernel is `csrc/sgm_directional.cu`, built at
first use by `ops/build.py` and called through its plain C interface. A
tensor on the CPU goes to the plain version
(`mvs/plane_sweep.py::_directional_pass`); a tensor on a CUDA device
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Two carry rows of one warp in an H100 block's 227 KB of shared memory
# (kMaxD of csrc/sgm_directional.cu).
MAX_D = 29056

# Kernel launches since the last reset (a plain count; the CPU path does not
# add to it).
launches = 0

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("sgm_directional").sgm_directional_pass_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def sgm_directional_pass(cost: torch.Tensor, p2: torch.Tensor, p1: float) -> torch.Tensor:
    """One forward SGM sweep along axis 0 of cost (S, N, D) with per-position
    P2 (S, N) and constant P1. Returns the aggregated costs (S, N, D)."""
    if cost.device.type == "cpu":
        from ..mvs.plane_sweep import _directional_pass  # imports this module

        return _directional_pass(cost, p2, p1)
    if cost.device.type != "cuda":
        raise ValueError(f"sgm_directional_pass: unsupported device {cost.device}")
    if cost.dtype != torch.float32 or p2.dtype != torch.float32:
        raise TypeError("sgm_directional_pass: cost and p2 must be float32")
    if cost.dim() != 3 or tuple(p2.shape) != tuple(cost.shape[:2]):
        raise ValueError(
            f"sgm_directional_pass: cost (S, N, D) and p2 (S, N) expected, got "
            f"{tuple(cost.shape)} and {tuple(p2.shape)}"
        )
    if p2.device != cost.device:
        raise ValueError("sgm_directional_pass: cost and p2 on different devices")
    if not (cost.is_contiguous() and p2.is_contiguous()):
        raise ValueError("sgm_directional_pass: cost and p2 must be contiguous")
    S, N, D = cost.shape
    if min(S, N, D) < 1 or D > MAX_D:
        raise ValueError(f"sgm_directional_pass: need S, N, D >= 1 and D <= {MAX_D}, got {(S, N, D)}")
    out = torch.empty_like(cost)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    err = _kernel()(
        cost.data_ptr(), p2.data_ptr(), out.data_ptr(), S, N, D, float(p1),
        cost.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"sgm_directional_pass: CUDA launch failed (cudaError {err})")
    global launches
    launches += 1
    return out
