"""Nistér 5-point essential-matrix solver, batched and branch-free.

Port of `alicevision_tpu/multiview/five_point.py` (ref:
src/aliceVision/multiview/relativePose/Essential5PSolver.hpp:17). The same
design:

1. the 4-dim null-space basis E(x,y,z) = x*X + y*Y + z*Z + W from an eigh
   of the 9x9 normal matrix;
2. the exact 10x20 cubic-constraint coefficients through fixed monomial
   structure tensors (det E = 0 and 2 E Eᵀ E - tr(E Eᵀ) E = 0);
3. Gauss-Jordan to [I | A], the 3x3 polynomial matrix B(z), and its
   degree-10 determinant n(z) by fixed-size convolutions;
4. real roots of n(z) by a fixed tan-grid sign scan plus bisection, in
   homogeneous form so that it never overflows;
5. every candidate polished by Levenberg-Marquardt, first over the unit
   sphere of null-space coordinates, then over unit-norm E in R^9 with the
   five epipolar rows, and kept iff its final constraint residual is small.

The reference takes the LM Jacobians from `jax.jvp`; here they are the
closed-form directional derivatives of the same residuals
(`_constraints_jvp`), all tangent directions in one batched evaluation.
Linear solves use `torch.linalg.solve_ex`, which neither raises nor reads
back on a singular system (the reference's non-finite steps become 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..numeric import f32_matmuls, normal_eigh

# Monomial order (Nistér's split): the 10 leading cubic monomials that
# Gauss-Jordan eliminates, then the 10-dim tail the reduced rows live in.
_LEAD = ["x3", "y3", "x2y", "xy2", "x2z", "x2", "y2z", "y2", "xyz", "xy"]
_TAIL = ["xz2", "xz", "x", "yz2", "yz", "y", "z3", "z2", "z", "1"]
_POWERS = {
    "x3": (3, 0, 0), "y3": (0, 3, 0), "x2y": (2, 1, 0), "xy2": (1, 2, 0),
    "x2z": (2, 0, 1), "x2": (2, 0, 0), "y2z": (0, 2, 1), "y2": (0, 2, 0),
    "xyz": (1, 1, 1), "xy": (1, 1, 0), "xz2": (1, 0, 2), "xz": (1, 0, 1),
    "x": (1, 0, 0), "yz2": (0, 1, 2), "yz": (0, 1, 1), "y": (0, 1, 0),
    "z3": (0, 0, 3), "z2": (0, 0, 2), "z": (0, 0, 1), "1": (0, 0, 0),
}
_MON1 = ["x", "y", "z", "1"]
_MON2 = ["x2", "xy", "xz", "x", "y2", "yz", "y", "z2", "z", "1"]
_MON3 = _LEAD + _TAIL


def _structure_tensors():
    """T2[m, a, b] = 1 iff mon1[a] * mon1[b] == mon2[m];
    T3[m, c, a] = 1 iff mon2[c] * mon1[a] == mon3[m]."""
    idx2 = {_POWERS[n]: i for i, n in enumerate(_MON2)}
    idx3 = {_POWERS[n]: i for i, n in enumerate(_MON3)}
    T2 = np.zeros((10, 4, 4), np.float32)
    for a, na in enumerate(_MON1):
        for b, nb in enumerate(_MON1):
            T2[idx2[tuple(np.add(_P1[na], _P1[nb]))], a, b] = 1.0
    T3 = np.zeros((20, 10, 4), np.float32)
    for c, nc in enumerate(_MON2):
        for a, na in enumerate(_MON1):
            T3[idx3[tuple(np.add(_P2[nc], _P1[na]))], c, a] = 1.0
    return T2, T3


_P1 = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1), "1": (0, 0, 0)}
_P2 = {n: _POWERS[n] for n in _MON2}
_T2, _T3 = _structure_tensors()

# fixed quasi-random unit seeds on the null-space 4-sphere (the reference's,
# drawn once by numpy): multi-start fallbacks for roots whose float32
# polynomial chain misdirects every data-derived seed
_QSEEDS = np.random.RandomState(7).randn(8, 4).astype(np.float32)
_QSEEDS /= np.linalg.norm(_QSEEDS, axis=-1, keepdims=True)


def _constraint_coeffs(XYZW: torch.Tensor) -> torch.Tensor:
    """Exact 10x20 cubic-constraint coefficients from the null-space basis
    XYZW (..., 4, 3, 3) -> (..., 10, 20) over _LEAD + _TAIL. Row 0 is
    det E; rows 1..9 the entries of 2 E Eᵀ E - tr(E Eᵀ) E."""
    T2 = torch.as_tensor(_T2, dtype=XYZW.dtype, device=XYZW.device)
    T3 = torch.as_tensor(_T3, dtype=XYZW.dtype, device=XYZW.device)
    P = XYZW
    C2 = torch.einsum("mab,...aik,...bjk->...mij", T2, P, P)  # E Eᵀ, (..., 10, 3, 3)
    tr2 = C2[..., 0, 0] + C2[..., 1, 1] + C2[..., 2, 2]  # (..., 10)
    TE = 2.0 * torch.einsum("mca,...cik,...akj->...mij", T3, C2, P) - torch.einsum(
        "mca,...c,...aij->...mij", T3, tr2, P
    )  # (..., 20, 3, 3)

    def prod2(p, q):
        return torch.einsum("mab,...a,...b->...m", T2, p, q)

    def prod3(r, p):
        return torch.einsum("mca,...c,...a->...m", T3, r, p)

    def e(i, j):
        return P[..., :, i, j]

    m0 = prod2(e(1, 1), e(2, 2)) - prod2(e(1, 2), e(2, 1))
    m1 = prod2(e(1, 0), e(2, 2)) - prod2(e(1, 2), e(2, 0))
    m2 = prod2(e(1, 0), e(2, 1)) - prod2(e(1, 1), e(2, 0))
    det3 = prod3(m0, e(0, 0)) - prod3(m1, e(0, 1)) + prod3(m2, e(0, 2))
    rowsT = TE.reshape(TE.shape[:-2] + (9,)).transpose(-1, -2)  # (..., 9, 20)
    return torch.cat([det3[..., None, :], rowsT], dim=-2)


def _cofactor(E: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix of E (..., 3, 3): d det(E) = sum(cof * dE)."""
    r0, r1, r2 = E[..., 0, :], E[..., 1, :], E[..., 2, :]
    return torch.stack(
        [torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0), torch.linalg.cross(r0, r1)], dim=-2
    )


def _constraints(E: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints on an essential matrix. E: (..., 3, 3) ->
    (..., 10): [det E, flatten(2 E Eᵀ E - tr(E Eᵀ) E)]."""
    EEt = E @ E.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    T = 2.0 * (EEt @ E) - tr[..., None, None] * E
    det = torch.sum(E[..., 0, :] * torch.linalg.cross(E[..., 1, :], E[..., 2, :]), dim=-1)
    return torch.cat([det[..., None], T.reshape(T.shape[:-2] + (9,))], dim=-1)


def _constraints_jvp(E: torch.Tensor, dE: torch.Tensor):
    """The constraints at E (..., 3, 3) and their directional derivatives
    along each of the tangents dE (..., t, 3, 3): (r (..., 10), J (..., 10, t))."""
    Ee = E[..., None, :, :]
    Et = E.transpose(-1, -2)[..., None, :, :]
    dEt = dE.transpose(-1, -2)
    EEt = E @ E.transpose(-1, -2)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    dtr = 2.0 * torch.sum(Ee * dE, dim=(-2, -1))  # (..., t)
    dT = 2.0 * (dE @ Et @ Ee + Ee @ dEt @ Ee + EEt[..., None, :, :] @ dE) - dtr[..., None, None] * Ee \
        - tr[..., None, None, None] * dE
    ddet = torch.sum(_cofactor(E)[..., None, :, :] * dE, dim=(-2, -1))
    J = torch.cat([ddet[..., None], dT.reshape(dT.shape[:-2] + (9,))], dim=-1)  # (..., t, 10)
    return _constraints(E), J.transpose(-1, -2)


def _normalized_tangents(v: torch.Tensor):
    """v / |v| and its derivative along each basis direction: rows of
    (I - n nᵀ) / |v|, (..., n, n)."""
    nv = torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-20)
    n = v / nv
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    return n, (eye - n[..., :, None] * n[..., None, :]) / nv[..., None]


def _polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Convolution of coefficient vectors (highest degree first), batched."""
    na, nb = a.shape[-1], b.shape[-1]
    out = torch.zeros(a.shape[:-1] + (na + nb - 1,), dtype=a.dtype, device=a.device)
    for i in range(na):
        out[..., i : i + nb] += a[..., i : i + 1] * b
    return out


def _poly_homval(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """h(z) = p(z) for |z| <= 1, z^-10 p(z) otherwise (reversed Horner in
    1/z, so it never overflows); same sign as p. coeffs (..., 11)."""
    inner = torch.abs(z) <= 1.0
    one = torch.ones_like(z)
    zi = torch.where(inner, z, one)
    ui = torch.where(inner, one, 1.0 / torch.where(z == 0, one, z))

    def horner(c, t):
        acc = c[..., 0]
        for i in range(1, c.shape[-1]):
            acc = acc * t + c[..., i]
        return acc

    return torch.where(inner, horner(coeffs, zi), horner(coeffs.flip(-1), ui))


def _poly_sign(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.sign(_poly_homval(coeffs, z))


def real_roots_deg10(coeffs: torch.Tensor, grid: int = 768, iters: int = 56):
    """Up to 10 real roots of a degree-10 polynomial, batched and
    branch-free. coeffs: (..., 11) highest power first -> (roots (..., 10),
    valid (..., 10)). Intervals are ranked sign flips first, then near-zero
    dips; `torch.topk` may order tied flips differently from the
    reference's `lax.top_k`, so the slots hold the same set in another
    order."""
    dt, dev = coeffs.dtype, coeffs.device
    half = math.pi / 2 * 0.9999
    zs = torch.tan(torch.linspace(-half, half, grid, dtype=dt, device=dev))
    c = coeffs / torch.clamp(torch.amax(torch.abs(coeffs), dim=-1, keepdim=True), min=1e-30)
    cb = c[..., None, :]
    h = _poly_homval(cb, zs)
    sgn = torch.sign(h)
    flip = sgn[..., :-1] * sgn[..., 1:] < 0
    minmag = torch.minimum(torch.abs(h[..., :-1]), torch.abs(h[..., 1:]))
    score = torch.where(flip, torch.full_like(minmag, 2.0), -minmag)
    idx = torch.topk(score, 10, dim=-1).indices
    valid = torch.gather(flip, -1, idx)
    lo, hi = zs[idx], zs[idx + 1]
    s_lo = _poly_sign(cb, lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s_mid = _poly_sign(cb, mid)
        go_left = s_mid * s_lo < 0  # root in [lo, mid]
        hi = torch.where(go_left, mid, hi)
        lo = torch.where(go_left, lo, mid)
        s_lo = torch.where(go_left, s_lo, s_mid)
    return 0.5 * (lo + hi), valid


def _lm_step(v, lam, r0, J, residuals, n_params):
    """One damped step of the reference's LM polishes: solve
    (JᵀJ + (lam tr/n + 1e-12) I) d = -Jᵀr, reject a norm collapse, keep the
    step iff it lowers the cost, and adapt lam."""
    H = J.transpose(-1, -2) @ J
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / n_params
    H = H + (lam * tr + 1e-12)[..., None, None] * torch.eye(n_params, dtype=v.dtype, device=v.device)
    g = -(J.transpose(-1, -2) @ r0[..., None])
    d = torch.linalg.solve_ex(H, g)[0][..., 0]
    d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    v_new = v + d
    # the zero vector is a spurious minimum of the homogeneous system
    nn = torch.linalg.norm(v_new, dim=-1, keepdim=True)
    v_new = torch.where(nn > 1e-3, v_new / torch.clamp(nn, min=1e-20), v)
    r_new = residuals(v_new)
    better = torch.sum(r_new * r_new, -1) < torch.sum(r0 * r0, -1)
    v = torch.where(better[..., None], v_new, v)
    lam = torch.clamp(torch.where(better, lam * 0.3, lam * 4.0), 1e-8, 1e4)
    return v, lam


def _polish_q(XYZW: torch.Tensor, q: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """LM on the 10 constraints over the unit sphere of null-space
    coordinates. XYZW: (..., 4, 3, 3) orthonormal basis, q: (..., R, 4)."""

    def residuals(qv):
        qn = qv / torch.clamp(torch.linalg.norm(qv, dim=-1, keepdim=True), min=1e-20)
        return _constraints(torch.einsum("...rc,...cij->...rij", qn, XYZW))

    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-20)
    lam = torch.full(q.shape[:-1], 1e-3, dtype=q.dtype, device=q.device)
    for _ in range(iters):
        qn, dqn = _normalized_tangents(q)  # dqn (..., R, 4 tangents, 4)
        E = torch.einsum("...rc,...cij->...rij", qn, XYZW)
        dE = torch.einsum("...rtc,...cij->...rtij", dqn, XYZW)
        r0, J = _constraints_jvp(E, dE)  # (..., R, 10), (..., R, 10, 4)
        q, lam = _lm_step(q, lam, r0, J, residuals, 4)
    return q


def _polish_e9(A5: torch.Tensor, e: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """LM over unit-norm E in R^9 on the 5 epipolar products A5 @ e plus the
    10 cubic constraints (15 residuals). A5: (..., 5, 9); e: (..., R, 9)."""
    A = A5[..., None, :, :]  # (..., 1, 5, 9)

    def residuals(ev):
        en = ev / torch.clamp(torch.linalg.norm(ev, dim=-1, keepdim=True), min=1e-20)
        epi = (A @ en[..., None])[..., 0]  # (..., R, 5)
        return torch.cat([epi, _constraints(en.reshape(en.shape[:-1] + (3, 3)))], dim=-1)

    e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-20)
    lam = torch.full(e.shape[:-1], 1e-3, dtype=e.dtype, device=e.device)
    for _ in range(iters):
        en, den = _normalized_tangents(e)  # den (..., R, 9 tangents, 9)
        epi = (A @ en[..., None])[..., 0]
        depi = A @ den.transpose(-1, -2)  # (..., R, 5, 9)
        rc, Jc = _constraints_jvp(en.reshape(en.shape[:-1] + (3, 3)), den.reshape(den.shape[:-1] + (3, 3)))
        r0 = torch.cat([epi, rc], dim=-1)
        J = torch.cat([depi, Jc], dim=-2)  # (..., R, 15, 9)
        e, lam = _lm_step(e, lam, r0, J, residuals, 9)
    return e


@f32_matmuls
def essential_5pt(x1n: torch.Tensor, x2n: torch.Tensor):
    """Nistér 5-point essential matrix from 5 normalized-camera
    correspondences. x1n, x2n: (..., 5, 2) -> (E (..., 24, 3, 3),
    valid (..., 24)).

    Slots 0-9 are the sign-scan root candidates, 10-15 fixed tan-fan z
    seeds, 16-23 fixed null-space sphere seeds; every slot is LM-polished
    and masked by its final constraint residual."""
    dt, dev = x1n.dtype, x1n.device
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)
    # float64 on a card: there the batched float32 eigh agreed with the CPU
    # on 0.960 of 4096 samples (chip_smoke.py's `solvers` step)
    _, V = normal_eigh(A)
    basis = V[..., :, :4].transpose(-1, -2)  # (..., 4, 9) null space
    XYZW = basis.reshape(basis.shape[:-1] + (3, 3))

    K = _constraint_coeffs(XYZW)  # (..., 10, 20)
    K10, Ktail = K[..., :10], K[..., 10:]
    ok_gj = torch.abs(torch.linalg.det(K10)) > 1e-20
    K10s = torch.where(ok_gj[..., None, None], K10, torch.eye(10, dtype=dt, device=dev))
    Atail = torch.linalg.solve_ex(K10s, Ktail)[0]  # (..., 10, 10)

    # rows 4..9 lead with x2z, x2, y2z, y2, xyz, xy: z*row(m) - row(m*z) is
    # linear in x, y with z-polynomial coefficients (tail order:
    # xz2 xz x | yz2 yz y | z3 z2 z 1)
    def combo(rz, r):
        p = torch.stack([r[..., 0], r[..., 1] - rz[..., 0], r[..., 2] - rz[..., 1], -rz[..., 2]], dim=-1)
        q = torch.stack([r[..., 3], r[..., 4] - rz[..., 3], r[..., 5] - rz[..., 4], -rz[..., 5]], dim=-1)
        s = torch.stack([r[..., 6], r[..., 7] - rz[..., 6], r[..., 8] - rz[..., 7], r[..., 9] - rz[..., 8],
                         -rz[..., 9]], dim=-1)
        # det roots are invariant to row scaling; unit rows keep the
        # float32 expansion well conditioned
        m = torch.clamp(torch.maximum(torch.amax(torch.abs(p), -1), torch.maximum(
            torch.amax(torch.abs(q), -1), torch.amax(torch.abs(s), -1))), min=1e-30)[..., None]
        return p / m, q / m, s / m

    p1, q1, s1 = combo(Atail[..., 4, :], Atail[..., 5, :])
    p2, q2, s2 = combo(Atail[..., 6, :], Atail[..., 7, :])
    p3, q3, s3 = combo(Atail[..., 8, :], Atail[..., 9, :])

    # n(z) = det [[p1 q1 s1], [p2 q2 s2], [p3 q3 s3]]  (degree 10)
    t1 = _polymul(q2, s3) - _polymul(q3, s2)
    t2 = _polymul(p2, s3) - _polymul(p3, s2)
    t3 = _polymul(p2, q3) - _polymul(p3, q2)
    n = _polymul(p1, t1) - _polymul(q1, t2) + _polymul(s1, t3)
    n = torch.nan_to_num(n, nan=0.0, posinf=0.0, neginf=0.0)
    roots, _ = real_roots_deg10(n)

    # a fixed tan fan of extra z seeds: where float32 noise erases a sign
    # flip, a seed still lands in the lost root's LM basin
    extra = torch.tan(torch.linspace(-1.42, 1.42, 6, dtype=dt, device=dev))
    roots = torch.cat([roots, extra.expand(roots.shape[:-1] + (6,))], dim=-1)

    def polyval(cf, z):
        acc = cf[..., 0:1] * torch.ones_like(z)
        for i in range(1, cf.shape[-1]):
            acc = acc * z + cf[..., i : i + 1]
        return acc

    P = torch.stack([polyval(p1, roots), polyval(p2, roots), polyval(p3, roots)], dim=-1)
    Q = torch.stack([polyval(q1, roots), polyval(q2, roots), polyval(q3, roots)], dim=-1)
    S = torch.stack([polyval(s1, roots), polyval(s2, roots), polyval(s3, roots)], dim=-1)
    # back-substitution: least squares [p q] [x y]ᵀ = -s over the 3 rows
    a11, a12, a22 = torch.sum(P * P, -1), torch.sum(P * Q, -1), torch.sum(Q * Q, -1)
    b1, b2 = -torch.sum(P * S, -1), -torch.sum(Q * S, -1)
    det2 = a11 * a22 - a12 * a12
    det2s = torch.where(torch.abs(det2) > 1e-30, det2, torch.ones_like(det2))
    x = (b1 * a22 - b2 * a12) / det2s
    y = (b2 * a11 - b1 * a12) / det2s

    q0 = torch.stack([x, y, roots, torch.ones_like(roots)], dim=-1)  # (..., 16, 4)
    qr = torch.as_tensor(_QSEEDS, dtype=dt, device=dev).expand(q0.shape[:-2] + (8, 4))
    q = _polish_q(XYZW, torch.cat([q0, qr], dim=-2))  # (..., 24, 4)
    e9 = _polish_e9(A, q @ basis)
    E = e9.reshape(e9.shape[:-1] + (3, 3))
    # valid = the polished candidate satisfies the constraints (meaningful
    # only at unit scale: the zero matrix satisfies them trivially)
    res = torch.linalg.norm(_constraints(E), dim=-1)
    e_norm = torch.linalg.norm(e9, dim=-1)
    valid = (res < 5e-4) & (e_norm > 0.5) & ok_gj[..., None] & torch.all(torch.isfinite(e9), dim=-1)
    E = torch.where(valid[..., None, None], E, torch.eye(3, dtype=dt, device=dev))
    return E, valid
