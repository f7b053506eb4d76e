"""SLAM pipeline orchestrator (port of `lins_tpu/slam.py`): odometry ->
mapping -> fused output.

The reference's 4-process ROS graph (run_port_exp.launch:17-31) becomes an
in-process pipeline: LinsOdometry (image_projection + lins_fusion nodes),
LinsMapper (lidar_mapping node) and the high-rate pose fusion of
transform_fusion_node.cpp:91-215 (odometry pose composed with the latest
map correction).  `enable_mapping=False` runs the odometry alone.  With
mapping, the mapper follows the odometry at its 0.3 s cadence and attempts
a loop closure at 1 Hz (`loop_attempts`), in the order process -> loop ->
fuse.
"""
from __future__ import annotations

import numpy as np
import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.mapping.mapper import (LinsMapper, imu_roll_pitch,
                                           warm_start)
from lins_tpu_torch.odometry.estimator import STATUS_RUNNING, LinsOdometry
from lins_tpu_torch.utils.lazy import LazyRows, to_numpy
from lins_tpu_torch.utils.metrics import trace_scope

__all__ = ["LinsSlam", "ate_rmse", "imu_roll_pitch", "run_sequence"]


class LinsSlam:
    """End-to-end LINS: feed IMU + scans, read fused poses.

    device / dtype: as `LinsOdometry` (the card and float32 unless given);
    the mapper runs on the same device in the same dtype.  `mapper_kw`
    (corner_cap, surf_cap, outlier_cap, n_window, map_corner_cap, ...) go
    to `LinsMapper`.
    """

    def __init__(self, cfg: SlamConfig, dtype=None, enable_mapping=True,
                 device=None, **mapper_kw):
        self.cfg = cfg
        self.odometry = LinsOdometry(cfg, dtype=dtype, device=device)
        self.mapper = (LinsMapper(cfg, dtype=self.odometry.dtype,
                                  device=self.odometry.device, **mapper_kw)
                       if enable_mapping else None)
        self.trajectory = []   # fused (t, pos, quat), tensors or lazy rows

    def warmup(self, chunk=None):
        """Build the kernels ahead of the run on the card
        (LinsOdometry.warmup, LinsMapper.warmup)."""
        self.odometry.warmup(chunk=chunk)
        if self.mapper is not None:
            self.mapper.warmup(chunk=chunk)

    def add_imu(self, t, acc, gyr):
        self.odometry.add_imu(t, acc, gyr)

    def add_scan(self, t, xyz, n_points):
        """One scan through the odometry, the mapper and the fusion, the
        span `slam.scan`; returns the fused (pos, quat), or None while the
        odometry initialises."""
        with trace_scope("slam.scan", t=float(t)):
            out = self.odometry.add_scan(t, xyz, n_points)
            if out is None:
                return None
            pos, quat = out
            if self.mapper is not None:
                odo, m = self.odometry, self.mapper
                # the bootstrap scan's pose comes as host arrays
                pos = torch.as_tensor(pos, dtype=m.dtype, device=m.device)
                quat = torch.as_tensor(quat, dtype=m.dtype, device=m.device)
                imu = odo._last_imu
                rp = (imu_roll_pitch(imu[0], self.cfg.gravity)
                      if imu is not None else None)
                self.mapper.process(
                    t, pos, quat, odo.last_corner["xyz"],
                    odo.last_corner["valid"], odo.last_surf["xyz"],
                    odo.last_surf["valid"], odo.last_outlier["xyz"],
                    odo.last_outlier["valid"], imu_rp=rp)
                self.mapper.maybe_close_loop(t)
                # high-rate fused output (transform_fusion_node)
                pos, quat = warm_start(self.mapper.state, pos, quat)
            self.trajectory.append((t, pos, quat))
            return pos, quat

    def trajectory_arrays(self):
        ts = np.asarray([t for t, _, _ in self.trajectory])
        ps = np.stack([to_numpy(p) for _, p, _ in self.trajectory])
        qs = np.stack([to_numpy(q) for _, _, q in self.trajectory])
        return ts, ps, qs

    def run_replay(self, data: dict, n_scans: int | None = None,
                   chunk: int = 24):
        """Offline replay: stream until the odometry is RUNNING, then
        prefetch the remaining scans AND their IMU batches to the device and
        process `chunk` scans per `LinsOdometry.add_scan_chunk` call, the
        mapper following at its cadence on the chunk's outputs
        (`LinsMapper.process_chunk`), with no host->device transfer inside
        the chunked loop and no host read but the flags that decide the
        odometry's and the mapper's loops and branches.  Scans past the
        last full chunk are streamed through `add_scan`.  The result equals
        streaming up to float rounding.
        """
        jobs, tail = self.stage_replay(data, n_scans, chunk)
        for job in jobs:
            self.run_chunk(job)
        for j in tail:
            t_scan = float(data["scan_times"][j]) + self.cfg.scan_period
            self.add_scan(t_scan, data["scans_xyz"][j], data["scans_n"][j])
        return self

    def stage_replay(self, data: dict, n_scans: int | None = None,
                     chunk: int = 24, min_streamed: int = 0):
        """The set-up half of `run_replay`: stream the first scans (until
        the odometry is RUNNING, and at least `min_streamed`), buffer the
        rest of the IMU, and stage every full chunk on the device, the span
        `slam.stage_replay`.  Returns (jobs for `run_chunk`, indices of the
        tail scans to stream)."""
        with trace_scope("slam.stage_replay", K=chunk):
            cfg = self.cfg
            odo = self.odometry
            n = n_scans or len(data["scans_xyz"])
            imu_i, k = 0, 0
            # 1) stream until RUNNING (bootstrap needs per-scan host logic)
            while k < n and (k < min_streamed or odo.status != STATUS_RUNNING):
                t_scan = float(data["scan_times"][k]) + cfg.scan_period
                while (imu_i < len(data["imu_times"])
                       and data["imu_times"][imu_i] <= t_scan + 1e-9):
                    self.add_imu(data["imu_times"][imu_i],
                                 data["imu_acc"][imu_i],
                                 data["imu_gyr"][imu_i])
                    imu_i += 1
                self.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
                k += 1
            # 2) buffer the remaining IMU, prefetch + replay the rest chunked
            while imu_i < len(data["imu_times"]):
                self.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                             data["imu_gyr"][imu_i])
                imu_i += 1
            ks = list(range(k, n))
            tail = len(ks) % chunk
            scan_ts = [float(data["scan_times"][j]) + cfg.scan_period
                       for j in ks]
            rp_all = self._roll_pitch_at(scan_ts) if self.mapper else None
            chunks = odo.prefetch_chunks(
                scan_ts, [data["scans_xyz"][j] for j in ks],
                [data["scans_n"][j] for j in ks], chunk=chunk, with_imu=True)
            # stage what the mapper needs up front: mapping and loop cadence
            # flags (host), scan times and IMU roll/pitch per chunk (device)
            staged = []
            for ci, (ts, *_) in enumerate(chunks):
                if self.mapper is None:
                    staged.append(None)
                    continue
                mf, lf = self.mapper.plan_chunk(ts)
                # scan times as float32, as the reference stages them
                ts_dev = torch.as_tensor(np.asarray(ts, np.float32),
                                         device=odo.device)
                rp_dev = torch.as_tensor(rp_all[ci * chunk:(ci + 1) * chunk],
                                         dtype=odo.dtype, device=odo.device)
                staged.append((ts_dev, mf, lf, rp_dev))
            if odo.device.type == "cuda":
                torch.cuda.synchronize(odo.device)
            return (list(zip(chunks, staged)),
                    ks[len(ks) - tail:] if tail else [])

    def run_chunk(self, job):
        """One staged chunk of `stage_replay`: odometry, then mapping and
        the fused poses, the span `slam.chunk`."""
        (ts, xyz_k, n_k, imu), staged = job
        with trace_scope("slam.chunk", t=float(ts[0]), K=len(ts)):
            self.odometry.add_scan_chunk(ts, xyz_k, n_k, imu=imu)
            self._post_chunk(ts, staged)

    def _roll_pitch_at(self, scan_ts):
        """Raw-IMU roll/pitch (latest sample <= scan end) per scan, from the
        still-buffered IMU stream; NaN rows where there is none."""
        odo = self.odometry
        imu_t = np.asarray(odo._imu_t, float)
        imu_a = np.stack(odo._imu_a) if odo._imu_a else np.zeros((0, 3))
        rp_all = np.full((len(scan_ts), 2), np.nan)
        for i, t in enumerate(scan_ts):
            j = np.searchsorted(imu_t, t + 1e-9) - 1
            if j >= 0:
                rp_all[i] = imu_roll_pitch(imu_a[j], self.cfg.gravity)
        return rp_all

    def _post_chunk(self, ts, staged=None):
        """Mapping and loop closure over one finished chunk + per-scan fused
        poses, read lazily (one host copy of the whole block when first
        read)."""
        rns, qbns = self.odometry.last_chunk_poses
        if self.mapper is not None:
            ts_dev, mf, lf, rp_dev = staged
            ps, qs = self.mapper.process_chunk(
                ts, rns, qbns, self.odometry.last_chunk_clouds, ts_dev, mf,
                lf, imu_rp_dev=rp_dev)
        else:
            ps, qs = rns, qbns
        p_rows, q_rows = LazyRows(ps), LazyRows(qs)
        for i, t in enumerate(ts):
            self.trajectory.append((float(t), p_rows.row(i), q_rows.row(i)))


def run_sequence(slam: LinsSlam, data: dict, n_scans: int | None = None):
    """Drive a generated/loaded sequence dict through the pipeline."""
    cfg = slam.cfg
    n = n_scans or len(data["scans_xyz"])
    imu_i = 0
    for k in range(n):
        t_scan = float(data["scan_times"][k]) + cfg.scan_period
        while (imu_i < len(data["imu_times"])
               and data["imu_times"][imu_i] <= t_scan + 1e-9):
            slam.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                         data["imu_gyr"][imu_i])
            imu_i += 1
        slam.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
    return slam


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray,
             align_frame: tuple | None = None) -> float:
    """ATE RMSE with no fit: the ground truth put into the estimator's
    world frame (the first processed scan's end pose, `align_frame` = (R0,
    p0)) when given, then compared over the common length.  Host numpy.
    `utils/trajectory.ate` fits the frames (Umeyama) instead."""
    if align_frame is not None:
        R0, p0 = align_frame
        gt = (np.asarray(R0).T @ (gt_pos - p0).T).T
    else:
        gt = gt_pos
    m = min(len(est_pos), len(gt))
    err = np.linalg.norm(est_pos[:m] - gt[:m], axis=1)
    return float(np.sqrt(np.mean(err ** 2)))
