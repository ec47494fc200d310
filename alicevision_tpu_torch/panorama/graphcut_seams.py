"""Graph-cut seam optimization for panorama compositing.

A host copy of `alicevision_tpu/panorama/graphcut_seams.py` over the
port's C++ max-flow (`native/maxflow.cpp`), the split of the reference's
seam finding (ref: src/aliceVision/panorama/graphcut.hpp GraphcutSeams,
seams.cpp): the per-pixel photometric seam costs are numpy, and the
irregular min-cut runs on the host through the same Boykov-Kolmogorov
max-flow the Delaunay meshing uses. Only the initial labels
(`compositing.seam_labels`) run on a torch device.

Energy over pixel labels l_p (which view paints pixel p):
  D_p(l)   = 0 if view l covers p else INF   (+ INF for uncovered keeps)
  V_pq(a,b)= 0 if a == b else |I_a(p)-I_b(p)| + |I_a(q)-I_b(q)| + bias
(the classic graphcut-textures seam cost: switching views where the two
images agree is free, crossing moving objects is expensive; `bias` prefers
shorter seams). Minimized by alpha-expansion — one binary BK cut per label
per sweep, with the standard truncation of non-submodular edges.
"""

from __future__ import annotations

import numpy as np

from ..native import maxflow

_INF = 1e9


def _pair_cost(img_a, img_b, valid):
    """|I_a - I_b| per pixel, 0 where the pair is invalid."""
    return np.where(valid, np.abs(img_a - img_b), 0.0)


def _expand(alpha, labels, warped, masks, seam_bias):
    """One alpha-expansion move. Returns the updated label map."""
    V, H, W = warped.shape
    n = H * W
    lab = labels.reshape(-1)
    cov_a = masks[alpha].reshape(-1)

    # unary: theta0 = cost of keeping current label, theta1 = taking alpha
    theta0 = np.where(lab < 0, _INF, 0.0)
    theta1 = np.where(cov_a, 0.0, _INF)

    # per-pixel image value of the current label (0 for unlabeled)
    lab_safe = np.clip(lab, 0, V - 1)
    img_cur = np.take_along_axis(
        warped.reshape(V, n), lab_safe[None], axis=0
    )[0]
    img_cur = np.where(lab < 0, 0.0, img_cur)
    img_a = warped[alpha].reshape(-1)

    terminal = np.zeros(n, np.float64)
    edges_u, edges_v, caps = [], [], []

    flat = np.arange(n).reshape(H, W)
    for du, dv in ((0, 1), (1, 0)):  # right, down neighbors
        p = flat[: H - du, : W - dv].reshape(-1)
        q = flat[du:, dv:].reshape(-1)
        lp, lq = lab[p], lab[q]
        both = (lp >= 0) & (lq >= 0)
        diff = lp != lq
        # V(a, b; p, q) pieces
        d_cur = np.abs(img_cur[p] - img_cur[q])  # proxy when labels differ
        # exact cross terms: I_{l_q}(p) and I_{l_p}(q)
        lq_safe = np.clip(lq, 0, V - 1)
        lp_safe = np.clip(lp, 0, V - 1)
        I_lq_p = warped.reshape(V, n)[lq_safe, p]
        I_lp_q = warped.reshape(V, n)[lp_safe, q]
        A = np.where(
            both & diff,
            np.abs(img_cur[p] - I_lq_p) + np.abs(I_lp_q - img_cur[q]) + seam_bias,
            0.0,
        )
        I_a_p, I_a_q = img_a[p], img_a[q]
        B = np.where(
            (lp >= 0) & (lp != alpha),
            np.abs(img_cur[p] - I_a_p) + np.abs(I_lp_q - I_a_q) + seam_bias,
            0.0,
        )  # V(l_p, alpha)
        C = np.where(
            (lq >= 0) & (lq != alpha),
            np.abs(I_a_p - I_lq_p) + np.abs(I_a_q - img_cur[q]) + seam_bias,
            0.0,
        )  # V(alpha, l_q)
        D = 0.0
        # Kolmogorov-Zabih decomposition (x=1 <-> sink <-> take alpha):
        #   theta_p(1) += C - A ; theta_q(1) += D - C ; edge p->q: B+C-A-D
        np.add.at(terminal, p, C - A)
        np.add.at(terminal, q, D - C)
        cap = np.maximum(B + C - A - D, 0.0)  # truncate non-submodular
        sel = cap > 0
        edges_u.append(p[sel])
        edges_v.append(q[sel])
        caps.append(cap[sel])

    # terminal net = theta(1) - theta(0); positive = source->p capacity,
    # which is cut (paid) exactly when p lands on the sink side (x=1).
    terminal += theta1 - theta0
    eu = np.concatenate(edges_u) if edges_u else np.zeros(0, np.int64)
    ev = np.concatenate(edges_v) if edges_v else np.zeros(0, np.int64)
    cp = np.concatenate(caps) if caps else np.zeros(0, np.float64)
    _, source_side = maxflow(n, eu, ev, cp, np.zeros_like(cp), terminal)
    take = ~np.asarray(source_side, bool)  # sink side = take alpha
    take &= cov_a
    new_lab = np.where(take, alpha, lab)
    return new_lab.reshape(H, W)


def graphcut_seam_labels(
    warped,
    masks,
    init_labels=None,
    sweeps: int = 2,
    seam_bias: float = 1e-3,
    device="cuda",
):
    """Optimize seam labels by alpha-expansion.

    warped: (V, H, W) float images in a common (panorama) frame;
    masks: (V, H, W) bool coverage. init_labels defaults to the distance-
    transform WTA of seam_labels(), computed on `device`. Returns (H, W)
    int32 labels, -1 where uncovered."""
    warped = np.asarray(warped, np.float64)
    masks = np.asarray(masks, bool)
    V = warped.shape[0]
    if init_labels is None:
        import torch

        from ..device import resolve_device
        from .compositing import seam_labels

        m = torch.as_tensor(masks, device=resolve_device(device))
        init_labels = seam_labels(m).cpu().numpy()
    labels = np.asarray(init_labels, np.int64).copy()
    for _ in range(sweeps):
        prev = labels.copy()
        for alpha in range(V):
            labels = _expand(alpha, labels, warped, masks, seam_bias)
        if np.array_equal(prev, labels):
            break
    return labels.astype(np.int32)


def seam_cost(warped, labels):
    """Total photometric seam cost of a label map (evaluation metric):
    sum over neighbor pairs with different labels of the cross-image
    differences at both endpoints."""
    warped = np.asarray(warped, np.float64)
    labels = np.asarray(labels)
    V, H, W = warped.shape
    n = H * W
    lab = labels.reshape(-1)
    total = 0.0
    flat = np.arange(n).reshape(H, W)
    for du, dv in ((0, 1), (1, 0)):
        p = flat[: H - du, : W - dv].reshape(-1)
        q = flat[du:, dv:].reshape(-1)
        lp, lq = lab[p], lab[q]
        sel = (lp >= 0) & (lq >= 0) & (lp != lq)
        if not sel.any():
            continue
        wf = warped.reshape(V, n)
        total += float(
            np.sum(
                np.abs(wf[lp[sel], p[sel]] - wf[lq[sel], p[sel]])
                + np.abs(wf[lp[sel], q[sel]] - wf[lq[sel], q[sel]])
            )
        )
    return total
