"""Trajectory export in the two reference formats.

Counterpart of lldslam_tpu/io/trajectory.py (numpy, copied unchanged).

Replaces System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM /
SaveTrajectoryKITTI (reference src/System.cc:327-477):

- TUM:   `t tx ty tz qx qy qz qw` per frame, camera-to-world (System.cc:381),
- KITTI: 3x4 row-major camera-to-world per frame (System.cc:471-473).

Per-frame poses are replayed as `T_cw = T_cr @ T_rw(ref)` through each frame's
reference keyframe (Tracking.cc:497-514 bookkeeping) so keyframe-pose updates
from BA/loop closure propagate to the full trajectory.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) from a rotation matrix (TUM convention)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.empty(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def replay_trajectory(rel_poses, ref_kfs, kf_poses) -> np.ndarray:
    """Per-frame world poses T_wc from relative-pose bookkeeping.

    rel_poses: (F, 4, 4) T_cr (frame from its reference KF),
    ref_kfs: (F,) keyframe index per frame,
    kf_poses: (K, 4, 4) current (possibly BA-corrected) keyframe T_cw."""
    rel_poses = np.asarray(rel_poses)
    ref_kfs = np.asarray(ref_kfs)
    kf_poses = np.asarray(kf_poses)
    T_cw = np.einsum("fij,fjk->fik", rel_poses, kf_poses[ref_kfs])
    R = T_cw[:, :3, :3]
    t = T_cw[:, :3, 3]
    Rwc = np.transpose(R, (0, 2, 1))
    twc = -np.einsum("fij,fj->fi", Rwc, t)
    T_wc = np.tile(np.eye(4, dtype=T_cw.dtype), (len(T_cw), 1, 1))
    T_wc[:, :3, :3] = Rwc
    T_wc[:, :3, 3] = twc
    return T_wc


def save_kitti(path: str | Path, T_wc: np.ndarray) -> None:
    """3x4 row-major, one line per frame (System.cc:424-477)."""
    rows = []
    for T in np.asarray(T_wc):
        rows.append(" ".join(f"{v:.9e}" for v in T[:3].reshape(-1)))
    Path(path).write_text("\n".join(rows) + "\n")


def save_tum(path: str | Path, timestamps: np.ndarray, T_wc: np.ndarray) -> None:
    """`t tx ty tz qx qy qz qw` (System.cc:327-387)."""
    lines = []
    for ts, T in zip(np.asarray(timestamps), np.asarray(T_wc)):
        q = _rot_to_quat(T[:3, :3])
        t = T[:3, 3]
        lines.append(
            f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
        )
    Path(path).write_text("\n".join(lines) + "\n")


def ate_rmse(est_T_wc: np.ndarray, gt_T_wc: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3)/umeyama alignment —
    the external-evaluation step the reference leaves to the KITTI devkit/evo
    (SURVEY.md §4)."""
    p = np.asarray(est_T_wc)[:, :3, 3]
    g = np.asarray(gt_T_wc)[:, :3, 3]
    assert p.shape == g.shape
    if align:
        mu_p, mu_g = p.mean(0), g.mean(0)
        pc, gc = p - mu_p, g - mu_g
        H = pc.T @ gc
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        p = (R @ pc.T).T + mu_g
        g = gc + mu_g
    return float(np.sqrt(np.mean(np.sum((p - g) ** 2, axis=-1))))
