"""Numeric helpers shared by the solvers.

Port of the parts of `alicevision_tpu/numeric.py` that the ported solvers
need: `f32_matmuls`, which runs a solver with full float32 matrix products,
the closed-form real cubic roots of the 7-point solver, the Ferrari quartic
of P3P, and homogeneous coordinates.
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


def quartic_roots_real(c4, c3, c2, c1, c0):
    """Real roots of a quartic via Ferrari's method, branch-free and batched
    (`alicevision_tpu/numeric.py::quartic_roots_real`).

    Returns (roots (..., 4), valid (..., 4) bool). Complex roots are flagged
    invalid (their slots hold the real part of the quadratic vertex).
    """
    c4 = torch.where(torch.abs(c4) < 1e-12, torch.full_like(c4, 1e-12), c4)
    a = c3 / c4
    b = c2 / c4
    c = c1 / c4
    d = c0 / c4
    # Depressed quartic y^4 + p y^2 + q y + r with x = y - a/4.
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a**3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a**4 / 256.0

    # Resolvent cubic 8 m^3 + 8 p m^2 + (2 p^2 - 8 r) m - q^2 = 0; its
    # largest real root is >= 0 for a valid factorization.
    m_roots, _ = cubic_roots_real(torch.full_like(p, 8.0), 8.0 * p, 2.0 * p * p - 8.0 * r, -q * q)
    m = torch.clamp(torch.amax(m_roots, dim=-1), min=0.0)
    s = torch.sqrt(torch.clamp(2.0 * m, min=_EPS))

    # Factor into two quadratics: y^2 +- s y + (p/2 + m -+ q/(2s)).
    t0 = p / 2.0 + m - q / (2.0 * s)
    t1 = p / 2.0 + m + q / (2.0 * s)

    def quad_roots(bq, cq):
        disc = bq * bq / 4.0 - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return -bq / 2.0 + sq, -bq / 2.0 - sq, disc >= 0.0

    y0a, y0b, ok0 = quad_roots(s, t0)
    y1a, y1b, ok1 = quad_roots(-s, t1)
    roots = torch.stack([y0a, y0b, y1a, y1b], dim=-1) - (a / 4.0)[..., None]
    valid = torch.stack([ok0, ok0, ok1, ok1], dim=-1)
    return roots, valid


def homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def euclidean(xh: torch.Tensor) -> torch.Tensor:
    w = xh[..., -1:]
    return xh[..., :-1] / torch.where(torch.abs(w) < _EPS, torch.full_like(w, _EPS), w)
