"""Numeric helpers shared by the solvers.

Port of the part of `alicevision_tpu/numeric.py` that the bundle adjuster
needs: `f32_matmuls`, which runs a solver with full float32 matrix products.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def _f32_matmul_scope():
    prev_precision = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_precision)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        torch.backends.cudnn.allow_tf32 = prev_cudnn


def f32_matmuls(fn):
    """Run ``fn`` with float32 matrix products in full precision.

    Geometry needs it: with TF32 (about three decimal digits) the J^T J
    normal equations and 3x3 rotation products lose enough that
    Gauss-Newton stalls near 1e-3 px residuals. The wrapper turns TF32 off
    and sets the float32 matmul precision to "highest" for the call, and
    restores the caller's settings on exit, so a caller who enabled TF32
    elsewhere cannot degrade a solve."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _f32_matmul_scope():
            return fn(*args, **kwargs)

    return wrapper
