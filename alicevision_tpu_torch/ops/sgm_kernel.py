"""The SGM directional sweeps: hand-written CUDA kernel + its dispatch.

Replaces the Pallas TPU kernel `alicevision_tpu/ops/sgm_pallas.py`
(`sgm_directional_pass`). The kernel is `csrc/sgm_directional.cu`, built at
first use by `ops/build.py` and called through its plain C interface
`sgm_sweep_f32`, which walks B*N chains of S steps through the strides it is
given (a negative step stride walks a chain backwards). Two entries launch
it:

- `sgm_directional_pass(cost, p2, p1)`: one forward sweep of a contiguous
  (S, N, D) volume, the counterpart of the JAX function (one launch);
- `sgm_axis_sweeps(vol, p2, p1, axis, total)`: the forward and the backward
  sweep along one spatial axis of an (H, W, D) or (B, H, W, D) volume,
  added into a running total by index, with no transposed, flipped or
  concatenated copy (two launches). `mvs/plane_sweep.sgm_aggregate` calls it
  twice a depth map, so a map takes four launches.

A tensor on the CPU goes to the plain version (`mvs/plane_sweep.py`:
`_directional_pass`, `_axis_sweeps`); a tensor on a CUDA device launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

# The largest D the kernel takes (kMaxD of csrc/sgm_directional.cu).
MAX_D = 29056

# Kernel launches since the last reset, by entry (plain counts; the CPU path
# does not add to them).
launches = {"sgm_directional_pass": 0, "sgm_axis_sweeps": 0}

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("sgm_directional").sgm_sweep_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *[ctypes.c_longlong] * 6,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


class SweepPlan(NamedTuple):
    """Where one launch finds its B*N chains of S steps: the offset of
    (b, n, s) = (0, 0, 0) and the (b, n, s) strides, in floats, of the
    volume (which the output shares) and of P2. D is innermost, stride 1."""

    S: int
    N: int
    offset: int
    strides: tuple[int, int, int]
    p2_offset: int
    p2_strides: tuple[int, int, int]


def axis_sweep_plan(shape, axis: int, reverse: bool) -> SweepPlan:
    """The plan of one sweep along `axis` (0: H, 1: W) of a contiguous
    (B, H, W, D) volume with a contiguous (B, H, W) P2; `reverse` walks each
    chain from its last step to its first."""
    B, H, W, D = shape
    if axis == 1:  # along W: one chain a row
        S, N, c_n, c_s, p_n, p_s = W, H, W * D, D, W, 1
    elif axis == 0:  # along H: one chain a column
        S, N, c_n, c_s, p_n, p_s = H, W, D, W * D, 1, W
    else:
        raise ValueError(f"axis must be 0 (H) or 1 (W), got {axis}")
    off = p_off = 0
    if reverse:
        off, p_off = (S - 1) * c_s, (S - 1) * p_s
        c_s, p_s = -c_s, -p_s
    return SweepPlan(S, N, off, (H * W * D, c_n, c_s), p_off, (H * W, p_n, p_s))


def _launch(cost, p2, out, B, D, plan: SweepPlan, p1: float, accumulate: bool, name: str):
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    err = _kernel()(
        cost.data_ptr() + 4 * plan.offset, p2.data_ptr() + 4 * plan.p2_offset,
        out.data_ptr() + 4 * plan.offset, B, plan.S, plan.N, D,
        *plan.strides, *plan.p2_strides, float(p1), int(accumulate),
        cost.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    launches[name] += 1


def _check_cuda(name: str, tensors: dict):
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    for key, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {key} on {t.device}, expected {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def sgm_directional_pass(cost: torch.Tensor, p2: torch.Tensor, p1: float) -> torch.Tensor:
    """One forward SGM sweep along axis 0 of cost (S, N, D) with per-position
    P2 (S, N) and constant P1. Returns the aggregated costs (S, N, D)."""
    if cost.device.type == "cpu":
        from ..mvs.plane_sweep import _directional_pass  # imports this module

        return _directional_pass(cost, p2, p1)
    name = "sgm_directional_pass"
    _check_cuda(name, {"cost": cost, "p2": p2})
    if cost.dim() != 3 or tuple(p2.shape) != tuple(cost.shape[:2]):
        raise ValueError(
            f"{name}: cost (S, N, D) and p2 (S, N) expected, got "
            f"{tuple(cost.shape)} and {tuple(p2.shape)}"
        )
    S, N, D = cost.shape
    if min(S, N, D) < 1 or D > MAX_D:
        raise ValueError(f"{name}: need S, N, D >= 1 and D <= {MAX_D}, got {(S, N, D)}")
    out = torch.empty_like(cost)
    plan = SweepPlan(S, N, 0, (0, D, N * D), 0, (0, 1, N))
    _launch(cost, p2, out, 1, D, plan, p1, False, name)
    return out


def sgm_axis_sweeps(
    vol: torch.Tensor,
    p2: torch.Tensor,
    p1: float,
    axis: int,
    total: torch.Tensor | None = None,
) -> torch.Tensor:
    """The forward and the backward SGM sweep along `axis` (0: H, 1: W) of
    vol (H, W, D), or (B, H, W, D) for B views, with per-position P2 of
    vol's shape without D. Adds the forward, then the backward sweep into
    `total` in place and returns it ((total + fwd) + bwd, the plain
    sgm_aggregate's order); with no total, returns a new fwd + bwd."""
    if vol.device.type == "cpu":
        from ..mvs.plane_sweep import _axis_sweeps  # imports this module

        return _axis_sweeps(vol, p2, p1, axis, total)
    name = "sgm_axis_sweeps"
    tensors = {"vol": vol, "p2": p2}
    if total is not None:
        tensors["total"] = total
    _check_cuda(name, tensors)
    if vol.dim() not in (3, 4) or tuple(p2.shape) != tuple(vol.shape[:-1]) or (
        total is not None and total.shape != vol.shape
    ):
        raise ValueError(
            f"{name}: vol ([B,] H, W, D), p2 ([B,] H, W) and total like vol expected, got "
            f"{tuple(vol.shape)}, {tuple(p2.shape)} and "
            f"{None if total is None else tuple(total.shape)}"
        )
    shape = tuple(vol.shape) if vol.dim() == 4 else (1, *vol.shape)
    if min(shape) < 1 or shape[-1] > MAX_D:
        raise ValueError(f"{name}: need every size >= 1 and D <= {MAX_D}, got {tuple(vol.shape)}")
    if total is not None and total.data_ptr() == vol.data_ptr():
        raise ValueError(f"{name}: total must not be vol")
    accumulate = total is not None
    if total is None:
        total = torch.empty_like(vol)
    for reverse in (False, True):
        plan = axis_sweep_plan(shape, axis, reverse)
        _launch(vol, p2, total, shape[0], shape[-1], plan, p1, accumulate, name)
        accumulate = True
    return total
