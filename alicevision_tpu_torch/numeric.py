"""Numeric helpers shared by the solvers.

Port of the parts of `alicevision_tpu/numeric.py` that the ported solvers
need: `f32_matmuls`, which runs a solver with full float32 matrix products,
and the closed-form real cubic roots of the 7-point solver.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

_EPS = 1e-12


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


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root with sign, safe for negatives."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_roots_real(c3, c2, c1, c0):
    """Real roots of c3 x^3 + c2 x^2 + c1 x + c0, branch-free and batched
    (`alicevision_tpu/numeric.py::cubic_roots_real`).

    Returns (roots (..., 3), n_real (...,)). When only one real root exists it
    is replicated into all three slots (downstream scoring dedups naturally).
    """
    c3 = torch.where(torch.abs(c3) < 1e-12, torch.full_like(c3, 1e-12), c3)
    a = c2 / c3
    b = c1 / c3
    c = c0 / c3
    # Depressed cubic t^3 + p t + q, x = t - a/3.
    p = b - a * a / 3.0
    q = 2.0 * a**3 / 27.0 - a * b / 3.0 + c

    disc = -4.0 * p**3 - 27.0 * q**2  # > 0 => 3 real roots

    # Three-real-root branch (trigonometric).
    p_neg = torch.clamp(p, max=-_EPS)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = torch.arccos(arg)
    k = torch.arange(3, dtype=theta.dtype, device=theta.device)
    t3 = m[..., None] * torch.cos((theta[..., None] - 2.0 * math.pi * k) / 3.0)

    # Single-real-root branch (Cardano).
    s = torch.sqrt(torch.clamp(q**2 / 4.0 + p**3 / 27.0, min=0.0))
    t1 = cbrt(-q / 2.0 + s) + cbrt(-q / 2.0 - s)
    t1 = t1[..., None].expand(t3.shape)

    three = (disc > 0.0)[..., None]
    roots = torch.where(three, t3, t1) - (a / 3.0)[..., None]
    n_real = torch.where(disc > 0.0, 3, 1)
    return roots, n_real
