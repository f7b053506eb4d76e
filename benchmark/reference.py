"""The plain reference that decides `correct`: what each of the port's
outputs says, judged against the drive the benchmark made.

The benchmark knows the truth of a synthetic drive: the analytic
trajectory (the sensor's pose at any time) and the world (ground, walls,
poles).  Every output of the port is a claim about them, and is judged by
what it says:

- a feature point of the front end (in its scan's end frame) claims a
  surface there: placed by the true pose at the scan's end, its distance
  to the nearest surface of the world;
- an odometry pose claims the motion since the previous scan: the error
  of the increment's translation, in the previous scan's body frame;
- a fused pose claims where the sensor was: the position error after one
  rigid fit (Umeyama) of the drive's fused track to the true one;
- a loop-closure edge claims the relative pose of two keyframes: the error
  of its translation against the true relative translation.

Plain PyTorch in float64 on the CPU; it imports nothing of the port and
takes nothing the port made but the outputs it judges.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import so3

# the share of a sweep, at its end, whose feature points the de-skew
# leaves (almost) where they were fired: what the front end passed
# through is checked there to float32 accuracy
LATE_SHARE = 0.02


def surface_distance(pts, walls, poles):
    """Distance (N,) of world points (N, 3) to the nearest surface: the
    ground plane z = 0, the walls (vertical rectangles) and the poles
    (vertical cylinders), all float64."""
    walls, poles = walls.double(), poles.double()
    x, y, z = pts[:, 0, None], pts[:, 1, None], pts[:, 2, None]
    x0, y0, x1, y1, h = walls.unbind(-1)
    ex, ey = x1 - x0, y1 - y0
    u = (((x - x0) * ex + (y - y0) * ey) / (ex * ex + ey * ey)).clamp(0, 1)
    dz = torch.clamp(torch.maximum(z - h, -z), min=0.0)
    d_wall = torch.sqrt((x - x0 - u * ex) ** 2 + (y - y0 - u * ey) ** 2
                        + dz ** 2).amin(dim=1)
    cx, cy, r, ph = poles.unbind(-1)
    radial = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) - r
    dzp = torch.clamp(torch.maximum(z - ph, -z), min=0.0)
    d_pole = torch.sqrt(radial ** 2 + dzp ** 2).amin(dim=1)
    return torch.minimum(pts[:, 2].abs(), torch.minimum(d_wall, d_pole))


def fired_share(pts):
    """The share of the sweep (0 at its start, 1 at its end) at which a
    point in the sensor frame was fired, from its azimuth: the sweep runs
    from azimuth pi down to -pi."""
    az = torch.atan2(pts[:, 1], pts[:, 0])
    return torch.remainder((math.pi - az) / (2.0 * math.pi), 1.0)


def late_surf_distances(clouds, gt_pos, gt_quat, walls, poles):
    """Distances of the surf feature points fired in the last LATE_SHARE
    of their sweep.  `clouds`: [(scan index, xyz (N, 3), valid (N,))] in
    each scan's end frame; gt_pos / gt_quat: the true poses at each
    sweep's end."""
    out = []
    for i, xyz, valid in clouds:
        p = torch.as_tensor(np.asarray(xyz)[np.asarray(valid)],
                            dtype=torch.float64)
        p = p[fired_share(p) > 1.0 - LATE_SHARE]
        q = torch.as_tensor(gt_quat[i], dtype=torch.float64)
        t = torch.as_tensor(gt_pos[i], dtype=torch.float64)
        out.append(surface_distance(so3.quat_rotate(q[None], p) + t,
                                    walls, poles))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)


def umeyama(src, dst):
    """Rotation R and translation t minimising |R src + t - dst| (no
    scale); src, dst (N, 3) float64 numpy."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    S = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(S)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    return R, mu_d - R @ mu_s


def fitted_errors(est_pos, gt_pos):
    """Per-pose position errors (N,) after the rigid fit of the estimated
    track to the true one."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    R, t = umeyama(est, gt)
    return np.linalg.norm(est @ R.T + t - gt, axis=1)


def increment_errors(pos, quat, gt_pos, gt_quat):
    """Translation errors (N-1,) of consecutive increments, each in the
    earlier scan's body frame (independent of either world frame)."""
    def steps(p, q):
        p = torch.as_tensor(np.asarray(p), dtype=torch.float64)
        q = torch.as_tensor(np.asarray(q), dtype=torch.float64)
        return so3.quat_rotate_inv(q[:-1], p[1:] - p[:-1])

    d = steps(pos, quat) - steps(gt_pos, gt_quat)
    return torch.linalg.vector_norm(d, dim=1).numpy()


def true_pose(pose_fn, times):
    """The true (pos (N, 3), quat (N, 4)) at host times, float64."""
    from torch.func import vmap

    t = torch.as_tensor(np.asarray(times, np.float64))
    p, q = vmap(pose_fn)(t)
    return p.numpy(), q.numpy()


def loop_edge_errors(edges, pose_fn):
    """Translation errors of loop edges [(t_i, t_j, trans (3,))]: each
    claims the pose of keyframe j (at time t_j) in keyframe i's frame."""
    if not edges:
        return np.zeros(0)
    ti, tj, tr = zip(*edges)
    pi, qi = true_pose(pose_fn, ti)
    pj, _ = true_pose(pose_fn, tj)
    want = so3.quat_rotate_inv(torch.as_tensor(qi), torch.as_tensor(pj - pi))
    return np.linalg.norm(np.asarray(tr, np.float64) - want.numpy(), axis=1)
