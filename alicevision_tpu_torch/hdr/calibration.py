"""HDR response-curve calibration: Debevec, Grossberg/EMoR and Laguerre.

Port of `alicevision_tpu/hdr/calibration.py` (ref:
src/aliceVision/hdr/DebevecCalibrate.cpp — the gsolve linear system;
GrossbergCalibrate.cpp — the EMoR inverse-response basis;
LaguerreBACalibration.cpp — the parametric Laguerre curve, fitted here by
Gauss-Newton on the bracket-consistency residuals; sampling.cpp — stable
pixel sample selection, host numpy). The solvers are dense linear algebra
and fixed-iteration Gauss-Newton on the samples' device, with no host
synchronization inside a loop. The EMoR tables are the port's own copy,
`data/emor.npz`.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..numeric import f32_matmuls


def weight_triangle(z: torch.Tensor) -> torch.Tensor:
    """Hat weighting over [0, 1] (Debevec's w)."""
    return torch.clamp(1.0 - torch.abs(2.0 * z - 1.0), min=0.0)


def weight_gaussian(z: torch.Tensor, sigma: float = 0.25) -> torch.Tensor:
    return torch.exp(-((z - 0.5) ** 2) / (2 * sigma * sigma))


def sample_bracket_pixels(images: np.ndarray, n_samples: int = 1000, seed: int = 0) -> np.ndarray:
    """Select sample pixel indices with good value coverage (host numpy).

    images: (B, H, W) single channel. Returns flat indices (n_samples,).
    Mirrors hdr/sampling.cpp's intent: prefer pixels spanning the range and
    not saturated in every bracket.
    """
    B = images.shape[0]
    flat = images.reshape(B, -1)
    usable = ((flat > 0.02) & (flat < 0.98)).sum(0) >= max(1, B // 2)
    idx = np.nonzero(usable)[0]
    if len(idx) == 0:
        idx = np.arange(flat.shape[1])
    # stratify by mid-bracket intensity
    mid = flat[B // 2, idx]
    order = np.argsort(mid)
    take = np.linspace(0, len(idx) - 1, min(n_samples, len(idx))).astype(int)
    return idx[order[take]]


class DebevecResponse(NamedTuple):
    g: torch.Tensor  # (256,) log-exposure response: g[z] = ln E + ln dt


@f32_matmuls
def debevec_calibrate(
    samples: torch.Tensor,  # (B, N) pixel values in [0, 1] across B brackets
    exposures: torch.Tensor,  # (B,) exposure times
    lambda_smooth: float = 20.0,
    n_levels: int = 256,
) -> DebevecResponse:
    """Solve for g and log radiances (gsolve of [Debevec97],
    DebevecCalibrate.cpp). Dense least squares over the unknowns
    [g(0..255), lnE_i], built by scatter-add and solved through float32
    normal equations with a 1e-8 ridge, as the reference package does."""
    B, N = samples.shape
    dev, dt = samples.device, samples.dtype
    z = torch.clamp((samples * (n_levels - 1)).to(torch.int64), 0, n_levels - 1)
    w = weight_triangle(samples) + 1e-4

    n_unk = n_levels + N
    n_eq = B * N + n_levels - 2 + 1
    A = torch.zeros((n_eq, n_unk), dtype=dt, device=dev)
    b = torch.zeros((n_eq,), dtype=dt, device=dev)

    rows = torch.arange(B * N, device=dev)
    wf = w.reshape(-1)
    if_ = torch.arange(N, device=dev).repeat(B)
    lt = torch.repeat_interleave(torch.log(exposures.to(dt)), N)
    A.index_put_((rows, z.reshape(-1)), wf, accumulate=True)
    A.index_put_((rows, n_levels + if_), -wf, accumulate=True)
    b[rows] = wf * lt

    # smoothness: lambda * (g[k-1] - 2 g[k] + g[k+1]) = 0
    ks = torch.arange(1, n_levels - 1, device=dev)
    r2 = B * N + ks - 1
    wk = weight_triangle(ks.to(dt) / (n_levels - 1.0)) + 1e-4
    A.index_put_((r2, ks - 1), lambda_smooth * wk, accumulate=True)
    A.index_put_((r2, ks), -2.0 * lambda_smooth * wk, accumulate=True)
    A.index_put_((r2, ks + 1), lambda_smooth * wk, accumulate=True)

    # gauge: g[mid] = 0
    A[n_eq - 1, n_levels // 2] = 1.0

    AtA = A.T @ A + 1e-8 * torch.eye(n_unk, dtype=dt, device=dev)
    x = torch.linalg.solve(AtA, A.T @ b)
    return DebevecResponse(g=x[:n_levels])


_EMOR_CACHE: dict = {}


def emor_tables():
    """(mean f0 (1024,), basis h (25, 1024)) of the INVERSE EMoR model, as
    numpy float arrays.

    The learned DoRF PCA data of Grossberg & Nayar ("What is the Space of
    Camera Response Functions?", CVPR 2003) — factual published tables,
    shipped like the sensor DB (ref: src/aliceVision/hdr/emorCurveInv.cpp,
    GrossbergCalibrate.cpp uses the same inverse-curve basis)."""
    if "inv" not in _EMOR_CACHE:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "emor.npz")
        with np.load(path) as z:
            _EMOR_CACHE["inv"] = (z["emor_inv"][0], z["emor_inv"][1:])
            _EMOR_CACHE["fwd"] = (z["emor"][0], z["emor"][1:])
    return _EMOR_CACHE["inv"]


def _emor_interp(table, v: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of (..., 1024)-sampled curves at v in [0, 1]."""
    t = torch.as_tensor(table, dtype=v.dtype, device=v.device)
    q = t.shape[-1]
    x = torch.clamp(v, 0.0, 1.0) * (q - 1)
    i0 = torch.floor(x).to(torch.int64)
    i1 = torch.clamp(i0 + 1, 0, q - 1)
    f = x - i0
    return t[..., i0] * (1 - f) + t[..., i1] * f


def grossberg_basis(v: torch.Tensor, n_coeffs: int, kind: str = "emor") -> torch.Tensor:
    """Inverse-response basis h_k at v, stacked (..., K).

    kind="emor": the learned EMoR PCA basis (the reference's
    GrossbergCalibrate model, emorCurveInv.cpp). kind="analytic": the
    Fourier sine fallback sin(pi k v)/(pi k) — same function class
    (smooth deviations pinned at h(0)=0, h(1)=1), weaker prior."""
    if kind == "emor":
        _, h = emor_tables()
        return torch.movedim(_emor_interp(h[:n_coeffs], v), 0, -1)  # (..., K)
    ks = torch.arange(1, n_coeffs + 1, dtype=v.dtype, device=v.device)
    return torch.sin(math.pi * ks * v[..., None]) / (math.pi * ks)


def grossberg_mean(v: torch.Tensor, kind: str = "emor") -> torch.Tensor:
    """The basis's mean inverse response f0 (identity for analytic)."""
    if kind == "emor":
        f0, _ = emor_tables()
        return _emor_interp(f0, v)
    return v


def grossberg_apply(coeffs: torch.Tensor, v: torch.Tensor, kind: str = "emor") -> torch.Tensor:
    """Inverse response: radiance = f0(v) + sum_k c_k h_k(v)."""
    return grossberg_mean(v, kind) + torch.sum(grossberg_basis(v, coeffs.shape[-1], kind) * coeffs, dim=-1)


@f32_matmuls
def grossberg_calibrate(
    samples: torch.Tensor,  # (B, N) pixel values in [0, 1], same scene points
    exposures: torch.Tensor,  # (B,) exposure times
    n_coeffs: int = 6,
    ridge: float = 1e-4,
    kind: str = "emor",
) -> torch.Tensor:
    """Grossberg-Nayar style inverse-response calibration, linear LS.

    For each bracket pair (a, b): h(v_a) * t_b / t_a = h(v_b). With
    h(v) = f0(v) + H(v) c this is linear in c — one (K, K) normal system
    (ref: hdr/GrossbergCalibrate.cpp:40-120 builds the same pairwise-
    consistency quadratic program over the EMoR basis coefficients).
    Returns coeffs (K,) for grossberg_apply.
    """
    B, N = samples.shape
    rows, rhs = [], []
    for b in range(B - 1):
        ratio = exposures[b + 1] / exposures[b]
        va, vb = samples[b], samples[b + 1]
        w = weight_triangle(va) * weight_triangle(vb)
        # (f0a + Ha c) ratio = f0b + Hb c -> (ratio Ha - Hb) c = f0b - ratio f0a
        A = ratio * grossberg_basis(va, n_coeffs, kind) - grossberg_basis(vb, n_coeffs, kind)
        rows.append(A * w[:, None])
        rhs.append((grossberg_mean(vb, kind) - ratio * grossberg_mean(va, kind)) * w)
    A = torch.cat(rows)  # (P, K)
    r = torch.cat(rhs)
    AtA = A.T @ A + ridge * torch.eye(n_coeffs, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(AtA, A.T @ r)


def laguerre_apply(phi, x: torch.Tensor) -> torch.Tensor:
    """Laguerre tone curve in [0, 1] (LaguerreBACalibration's model):
    f(x) = x + (2/pi) atan(phi sin(pi x) / (1 - phi cos(pi x)))."""
    s = torch.sin(math.pi * x)
    c = torch.cos(math.pi * x)
    return x + (2.0 / math.pi) * torch.atan2(phi * s, 1.0 - phi * c)


def laguerre_inverse(phi, y: torch.Tensor) -> torch.Tensor:
    """Inverse curve — the Laguerre family is closed under inversion with
    negated parameter."""
    return laguerre_apply(-phi, y)


def _laguerre_inverse_dphi(phi: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d laguerre_inverse(phi, y) / d phi, in closed form:
    d/dphi atan2(-phi s, 1 + phi c) = -s / ((1 + phi c)^2 + (phi s)^2)."""
    s = torch.sin(math.pi * y)
    c = torch.cos(math.pi * y)
    return (2.0 / math.pi) * -s / ((1.0 + phi * c) ** 2 + (phi * s) ** 2)


def laguerre_calibrate(
    samples: torch.Tensor,  # (B, N) in [0, 1]
    exposures: torch.Tensor,  # (B,)
    iters: int = 30,
) -> torch.Tensor:
    """Fit the single Laguerre parameter by Gauss-Newton on pairwise bracket
    consistency: linearize(sample_b1) * dt2/dt1 = linearize(sample_b2).
    The Jacobian is the closed-form derivative of `laguerre_inverse` (the
    reference package differentiates forward); `iters` steps run on the
    samples' device without reading phi back."""
    ratio = (exposures[1:] / exposures[:-1])[:, None]  # (B-1, 1)
    w = weight_triangle(samples[:-1]) * weight_triangle(samples[1:])  # (B-1, N)
    phi = torch.zeros((), dtype=samples.dtype, device=samples.device)
    for _ in range(iters):
        lin = laguerre_inverse(phi, samples)
        dlin = _laguerre_inverse_dphi(phi, samples)
        r = w * (lin[:-1] * ratio - lin[1:])
        J = w * (dlin[:-1] * ratio - dlin[1:])
        phi = torch.clamp(phi - torch.sum(J * r) / (torch.sum(J * J) + 1e-9), -0.95, 0.95)
    return phi
