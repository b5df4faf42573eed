"""Trajectory evaluation: ATE, RPE and the NEES of the per-frame ICP
covariance (port of `svnicp_tpu/io/metrics.py`)."""

from __future__ import annotations

import numpy as np


def _as_positions(poses: np.ndarray) -> np.ndarray:
    return poses[:, :3, 3] if poses.ndim == 3 else poses


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares SE(3) (with `with_scale`, Sim(3)) alignment est -> gt:
    (s, R, t) minimizing ||gt - (s R est + t)||."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    cov = xg.T @ xe / len(est)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    rot = u @ s_mat @ vt
    scale = (float(np.trace(np.diag(d) @ s_mat) / (xe**2).sum() * len(est))
             if with_scale else 1.0)
    return scale, rot, mu_g - scale * rot @ mu_e


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: str = "umeyama") -> float:
    """Absolute trajectory error RMSE [m] over positions; `align` is
    "umeyama" (the SE(3) fit, from 3 poses on), "first" (anchor the first
    pose) or "none"."""
    est = _as_positions(est_poses)
    gt = _as_positions(gt_poses)
    if est.shape != gt.shape:
        raise ValueError(f"trajectory shapes differ: {est.shape} vs {gt.shape}")
    if align == "umeyama" and len(est) >= 3:
        s, r, t = umeyama_alignment(est, gt)
        est = (s * (r @ est.T)).T + t
    elif align == "first":
        est = est - est[0] + gt[0]
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over `delta`-frame intervals of [N,4,4] poses ->
    (RMSE translation [m], RMSE rotation [rad])."""
    if est_poses.ndim != 3 or gt_poses.ndim != 3:
        raise ValueError("rpe takes [N,4,4] poses")
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        err = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(err[:3, 3]))
        cos_a = np.clip((np.trace(err[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.arccos(cos_a))
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))


def _so3_log_np(r: np.ndarray) -> np.ndarray:
    cos_a = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    a = np.arccos(cos_a)
    vee = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    if a < 1e-8:
        return vee / 2.0
    return a / (2.0 * np.sin(a)) * vee


def nees(est_poses: np.ndarray, gt_poses: np.ndarray, guess_poses: np.ndarray,
         covs: np.ndarray) -> tuple[float, np.ndarray]:
    """Normalized estimation error squared of the per-frame ICP correction:
    per frame e = c_est - c_true in the correction coordinates [t, log R]
    (c = guess^-1 pose), NEES = e^T Sigma^-1 e; ~6 when the 6-DoF
    covariance is calibrated. est and guess are first moved into the gt
    frame by anchoring the first poses; frames with a singular covariance
    are skipped -> (mean NEES, per-frame values)."""
    t0 = gt_poses[0] @ np.linalg.inv(est_poses[0])
    est_poses = t0[None] @ est_poses
    guess_poses = t0[None] @ guess_poses
    vals = []
    for i in range(len(est_poses)):
        rg, tg = guess_poses[i][:3, :3], guess_poses[i][:3, 3]

        def corr(pose):
            return np.concatenate([rg.T @ (pose[:3, 3] - tg),
                                   _so3_log_np(rg.T @ pose[:3, :3])])

        e = corr(est_poses[i]) - corr(gt_poses[i])
        try:
            vals.append(float(e @ np.linalg.solve(covs[i], e)))
        except np.linalg.LinAlgError:
            continue
    vals = np.asarray(vals)
    return (float(vals.mean()) if len(vals) else float("nan")), vals
