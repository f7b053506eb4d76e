"""Trajectory I/O and accuracy evaluation (port of
`lins_tpu/utils/trajectory.py`): TUM-format files (timestamp x y z qx qy
qz qw), nearest-stamp association, and ATE/RPE with SE(3) (Umeyama)
alignment.  Host numpy only."""
from __future__ import annotations

import numpy as np


def write_tum(path: str, times, pos, quat_wxyz):
    """Write a TUM-format trajectory file (qx qy qz qw ordering)."""
    times = np.asarray(times)
    pos = np.asarray(pos)
    q = np.asarray(quat_wxyz)
    with open(path, "w") as f:
        for i in range(len(times)):
            f.write(f"{times[i]:.6f} {pos[i,0]:.6f} {pos[i,1]:.6f} "
                    f"{pos[i,2]:.6f} {q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} "
                    f"{q[i,0]:.6f}\n")


def read_tum(path: str):
    """Read a TUM trajectory -> (times, pos (N,3), quat_wxyz (N,4))."""
    data = np.loadtxt(path).reshape(-1, 8)
    q = np.concatenate([data[:, 7:8], data[:, 4:7]], axis=1)
    return data[:, 0], data[:, 1:4], q


def associate(t_a, t_b, max_dt=0.02):
    """Greedy nearest-timestamp association -> index pairs."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(np.asarray(t_a)):
        while j + 1 < len(t_b) and abs(t_b[j + 1] - t) < abs(t_b[j] - t):
            j += 1
        if abs(t_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_align(src, dst, with_scale=False):
    """Least-squares SE(3) (or Sim(3)) alignment src -> dst."""
    src, dst = np.asarray(src), np.asarray(dst)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    S = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(S)
    sgn = np.sign(np.linalg.det(U @ Vt))
    W = np.diag([1.0, 1.0, sgn])
    R = U @ W @ Vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ W) / var
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate(est_pos, gt_pos, align=True):
    """Absolute trajectory error RMSE (m), optionally Umeyama-aligned."""
    est, gt = np.asarray(est_pos), np.asarray(gt_pos)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 3:
        s, R, t = umeyama_align(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def _quat_to_mat(q):
    """(N,4) wxyz -> (N,3,3), numpy."""
    q = np.asarray(q, float)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def rpe(est_pos, gt_pos, delta: int = 10, est_quat=None, gt_quat=None):
    """Relative translation error RMSE over a fixed frame delta.

    With orientations, the TUM-benchmark definition: each window's
    displacement in its own start frame, so the metric does not depend on
    the rotation between the estimator's world frame and the ground
    truth's.  Without them, est is Umeyama-aligned onto gt first for the
    same reason."""
    est, gt = np.asarray(est_pos), np.asarray(gt_pos)
    n = min(len(est), len(gt))
    if n <= delta:
        return float("nan")
    if est_quat is not None and gt_quat is not None:
        Re = _quat_to_mat(np.asarray(est_quat)[: n - delta])
        Rg = _quat_to_mat(np.asarray(gt_quat)[: n - delta])
        de = np.einsum("nij,nj->ni", Re.transpose(0, 2, 1),
                       est[delta:n] - est[: n - delta])
        dg = np.einsum("nij,nj->ni", Rg.transpose(0, 2, 1),
                       gt[delta:n] - gt[: n - delta])
    else:
        if n >= 3:
            s, R, t = umeyama_align(est[:n], gt[:n])
            est = (s * (R @ est[:n].T)).T + t
        de = est[delta:n] - est[: n - delta]
        dg = gt[delta:n] - gt[: n - delta]
    err = np.linalg.norm(de - dg, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))
