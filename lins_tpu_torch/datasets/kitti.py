"""KITTI odometry loader (port of `lins_tpu/datasets/kitti.py`; BASELINE.json
config 3: seq 00/05 with loop closure).

Reads the standard KITTI odometry layout:
  sequences/NN/velodyne/*.bin   (N,4) float32 x y z reflectance (HDL-64E)
  sequences/NN/times.txt
  poses/NN.txt                  3x4 row-major cam0 poses (optional)
  sequences/NN/calib.txt        Tr: velodyne -> cam0 (optional)

KITTI odometry ships no IMU; when ground-truth poses are available the
loader synthesizes IMU samples from them (finite-difference accelerations
and gyro rates), the usual harness for LiDAR-inertial systems on KITTI.
The output is host numpy, as the reference's; the rotation math runs on
the CPU in float64 through the port's `geom/so3`.
"""
from __future__ import annotations

import os

import numpy as np

from lins_tpu_torch.config import SlamConfig


def read_velodyne_bin(path: str) -> np.ndarray:
    pts = np.fromfile(path, np.float32).reshape(-1, 4)
    return pts[:, :3]


def read_times(seq_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(seq_dir, "times.txt"))


def read_poses(poses_file: str, calib_file: str | None = None) -> np.ndarray:
    """(N,4,4) velodyne-frame poses (applies Tr when calib is given)."""
    raw = np.loadtxt(poses_file).reshape(-1, 3, 4)
    n = len(raw)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :] = raw
    if calib_file and os.path.exists(calib_file):
        Tr = None
        with open(calib_file) as f:
            for line in f:
                if line.startswith("Tr:"):
                    Tr = np.eye(4)
                    Tr[:3, :] = np.fromstring(
                        line[3:], sep=" ").reshape(3, 4)
        if Tr is not None:
            Tr_inv = np.linalg.inv(Tr)
            T = np.einsum("ij,njk,kl->nil", Tr_inv, T, Tr)
    return T


def synthesize_imu_from_poses(times: np.ndarray, T: np.ndarray,
                              rate: float = 100.0, gravity: float = 9.81,
                              ba=(0, 0, 0), bw=(0, 0, 0)):
    """IMU samples interpolated from a pose sequence (finite differences):
    (times, specific force (n,3), angular rate (n,3)) in the body frame."""
    import torch

    from lins_tpu_torch.geom import so3

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64))

    pos = T[:, :3, 3]
    quats = so3.mat_to_quat(f64(T[:, :3, :3])).numpy()
    # enforce quaternion sign continuity
    for i in range(1, len(quats)):
        if np.dot(quats[i], quats[i - 1]) < 0:
            quats[i] = -quats[i]

    t_out = np.arange(times[0], times[-1], 1.0 / rate)
    dt = 1.0 / rate

    # velocities/accelerations by central differences on the resampled track
    p_i = np.stack([np.interp(t_out, times, pos[:, k]) for k in range(3)], 1)
    v = np.gradient(p_i, dt, axis=0)
    a_w = np.gradient(v, dt, axis=0)

    q_i = np.stack([np.interp(t_out, times, quats[:, k]) for k in range(4)], 1)
    q_i /= np.linalg.norm(q_i, axis=1, keepdims=True)
    g = np.asarray([0.0, 0.0, -gravity])
    q = f64(q_i)
    out_acc = so3.quat_rotate_inv(q, f64(a_w - g)).numpy()
    out_gyr = np.zeros((len(t_out), 3))
    if len(t_out) > 1:
        dq = so3.quat_mul(so3.quat_inv(q[:-1]), q[1:])
        out_gyr[:-1] = so3.log_quat(dq).numpy() / dt
        out_gyr[-1] = out_gyr[-2]
    return (t_out, out_acc + np.asarray(ba), out_gyr + np.asarray(bw))


def load_sequence(root: str, seq: str, cfg: SlamConfig,
                  max_scans: int | None = None, imu_rate: float = 100.0):
    """KITTI sequence -> the runner's sequence dict (+ gt poses if found)."""
    seq_dir = os.path.join(root, "sequences", seq)
    vel_dir = os.path.join(seq_dir, "velodyne")
    files = sorted(f for f in os.listdir(vel_dir) if f.endswith(".bin"))
    if max_scans:
        files = files[:max_scans]
    times = read_times(seq_dir)[: len(files)]

    scans = np.zeros((len(files), cfg.max_points, 3), np.float32)
    counts = np.zeros(len(files), np.int32)
    for k, fname in enumerate(files):
        xyz = read_velodyne_bin(os.path.join(vel_dir, fname))
        xyz = xyz[np.isfinite(xyz).all(1)][: cfg.max_points]
        scans[k, : len(xyz)] = xyz
        counts[k] = len(xyz)

    out = dict(scans_xyz=scans, scans_n=counts,
               scan_times=times - cfg.scan_period)

    poses_file = os.path.join(root, "poses", f"{seq}.txt")
    if os.path.exists(poses_file):
        T = read_poses(poses_file, os.path.join(seq_dir, "calib.txt"))
        T = T[: len(files)]
        out["gt_pos"] = T[:, :3, 3]
        imu_t, acc, gyr = synthesize_imu_from_poses(
            times, T, imu_rate, cfg.gravity)
        out["imu_times"] = imu_t
        out["imu_acc"] = acc
        out["imu_gyr"] = gyr
    return out
