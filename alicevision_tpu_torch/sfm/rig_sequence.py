"""Rig-sequence calibration and bundle adjustment.

Port of `alicevision_tpu/sfm/rig_sequence.py`, the counterpart of the
reference's RigSequence (ref:
src/aliceVision/sfm/pipeline/sequential/RigSequence.cpp): after the rig's
views have been reconstructed independently, (1) estimate each fixed
sub-pose by averaging the per-frame relative transforms, (2)
re-parameterize the scene over *frame* poses + shared sub-poses, and (3)
run the alternating rig bundle adjustment (`sfm.ba.rig_solve`, the
sub-pose chain in the BA core) on the device.

Conventions: a view's world->cam transform is R_v = R_s R_f with
x_cam = R_s x_frame + t_s, x_frame = R_f (X - c_f); hence
R_s = R_v R_fᵀ and t_s = t_v + R_v c_f, and a view's center is
c_v = c_f - R_fᵀ R_sᵀ t_s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.rotations import mat_to_quat, quat_to_mat
from ..misc.rig import average_quaternions
from . import ba as ba_mod


def _f32(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)


def estimate_subposes(view_R, view_c, posed, view_frame, view_sub, n_sub, device="cuda"):
    """Average sub-poses over frames from independently-posed rig views.

    Returns (sub_R (S,3,3), sub_t (S,3), frame_R (F,3,3), frame_c (F,3),
    frame_ok (F,)). Frame poses come from the sub-0 views (sub-pose 0 is the
    rig body by definition); frames without a posed sub-0 view are completed
    from any posed sibling using the averaged sub-pose."""
    dev = resolve_device(device)
    view_R = np.asarray(view_R, np.float64)
    view_c = np.asarray(view_c, np.float64)
    posed = np.asarray(posed, bool)
    view_frame = np.asarray(view_frame)
    view_sub = np.asarray(view_sub)
    t_v = -np.einsum("vij,vj->vi", view_R, view_c)

    F = int(view_frame.max()) + 1
    frame_R = np.tile(np.eye(3), (F, 1, 1))
    frame_c = np.zeros((F, 3))
    frame_ok = np.zeros(F, bool)
    sub0 = (view_sub == 0) & posed
    frame_R[view_frame[sub0]] = view_R[sub0]
    frame_c[view_frame[sub0]] = view_c[sub0]
    frame_ok[view_frame[sub0]] = True

    sub_R = [np.eye(3)]
    sub_t = [np.zeros(3)]
    for s in range(1, n_sub):
        sel = (view_sub == s) & posed & frame_ok[view_frame]
        if sel.sum() == 0:
            sub_R.append(np.eye(3))
            sub_t.append(np.zeros(3))
            continue
        Rf = frame_R[view_frame[sel]]
        cf = frame_c[view_frame[sel]]
        R_rel = np.einsum("vij,vkj->vik", view_R[sel], Rf)  # R_v R_fᵀ
        t_rel = t_v[sel] + np.einsum("vij,vj->vi", view_R[sel], cf)
        # Markley averaging (sum q qᵀ) is sign-invariant: no hemisphere
        # alignment needed
        q = average_quaternions(mat_to_quat(_f32(R_rel, dev)))
        sub_R.append(quat_to_mat(q[None])[0].cpu().numpy())
        sub_t.append(t_rel.mean(axis=0))

    sub_R = np.stack(sub_R)
    sub_t = np.stack(sub_t)

    # complete frames that lack a sub-0 pose from any posed sibling:
    # R_f = R_sᵀ R_v,  c_f solves t_v = t_s - R_s R_f c_f
    for f in np.nonzero(~frame_ok)[0]:
        idx = np.nonzero((view_frame == f) & posed)[0]
        if len(idx) == 0:
            continue
        v = idx[0]
        s = int(view_sub[v])
        Rf = sub_R[s].T @ view_R[v]
        frame_R[f] = Rf
        frame_c[f] = -Rf.T @ (sub_R[s].T @ (t_v[v] - sub_t[s]))
        frame_ok[f] = True
    return sub_R, sub_t, frame_R, frame_c, frame_ok


def view_poses_from_rig(frame_R, frame_c, sub_R, sub_t, view_frame, view_sub):
    """Compose per-view world->cam poses from frame poses + sub-poses."""
    Rf = np.asarray(frame_R)[np.asarray(view_frame)]
    cf = np.asarray(frame_c)[np.asarray(view_frame)]
    Rs = np.asarray(sub_R)[np.asarray(view_sub)]
    ts = np.asarray(sub_t)[np.asarray(view_sub)]
    R_v = np.einsum("vij,vjk->vik", Rs, Rf)
    c_v = cf - np.einsum("vji,vkj,vk->vi", Rf, Rs, ts)
    return R_v, c_v


def solve_rig_sequence(
    view_R,
    view_c,
    posed,
    view_frame,
    view_sub,
    n_sub,
    points,
    intr,
    obs_lm,
    obs_view,
    obs_intr,
    obs_uv,
    max_track: int = 16,
    rounds: int = 10,
    fix_gauge: int = 2,
    device="cuda",
):
    """Full rig-sequence pass over flat observation arrays, the rig BA on
    `device`. Returns (view_R, view_c, sub_R, sub_t, frame_R, frame_c,
    points, BAResult)."""
    dev = resolve_device(device)
    sub_R, sub_t, frame_R, frame_c, frame_ok = estimate_subposes(
        view_R, view_c, posed, view_frame, view_sub, n_sub, device=dev
    )
    obs_view = np.asarray(obs_view)
    keep = np.asarray(posed)[obs_view] & frame_ok[np.asarray(view_frame)[obs_view]]
    o_frame = np.asarray(view_frame)[obs_view[keep]]
    o_sub = np.asarray(view_sub)[obs_view[keep]]

    ok_frames = np.nonzero(frame_ok)[0]
    cam_fixed = ~frame_ok
    cam_fixed[ok_frames[:fix_gauge]] = True

    problem = ba_mod.build_problem(
        mat_to_quat(_f32(frame_R, dev)),
        frame_c,
        points,
        intr,
        np.asarray(obs_lm)[keep],
        o_frame,
        np.asarray(obs_intr)[keep],
        np.asarray(obs_uv)[keep],
        max_track=max_track,
        cam_fixed=cam_fixed,
        obs_sub=o_sub,
        sub_q=mat_to_quat(_f32(sub_R, dev)),
        sub_t=sub_t,
        device=dev,
    )
    res, sq, st = ba_mod.rig_solve(problem, rounds=rounds)

    frame_R = quat_to_mat(res.cam_q).cpu().numpy().astype(np.float64)
    frame_c = res.cam_c.cpu().numpy().astype(np.float64)
    sub_R = quat_to_mat(sq).cpu().numpy().astype(np.float64)
    sub_t = st.cpu().numpy().astype(np.float64)
    R_v, c_v = view_poses_from_rig(frame_R, frame_c, sub_R, sub_t, view_frame, view_sub)
    return R_v, c_v, sub_R, sub_t, frame_R, frame_c, res.points.cpu().numpy(), res
