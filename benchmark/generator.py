"""The benchmark's drive generator: a frozen copy of the port's synthetic
LiDAR-inertial world (`lins_tpu_torch/datasets/synthetic.py`: the world,
the analytic trajectories, the VLP-16-style raycast with motion distortion
and the IMU synthesis), kept here so that the yardstick does not move when
the port's copy changes.

The arithmetic is the port's, operation for operation, so a drive equals
`generate_sequence`'s for the same arguments (benchmark/tests checks it at
the TINY size).  Only the batching differs: the raycast runs many sweeps
in one call and the scans are compacted on the device, so that a drive of
hundreds of HDL-64 sweeps is made in a few large calls.

`sensor` is anything with the port's sensor fields (line_num, scan_num,
scan_period, ang_bottom, ang_res_y, max_points, gravity); the harness
passes the cell's configuration.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch.func import jacfwd, vmap

from benchmark import so3

# rays the raycast handles in one call (a few hundred MB of float64
# temporaries against the default world)
RAYS_PER_CALL = 1 << 20


@dataclasses.dataclass(frozen=True)
class World:
    """Vertical rectangular walls, vertical cylinder poles, ground z=0."""

    walls: tuple = ()   # each: (x0, y0, x1, y1, height)
    poles: tuple = ()   # each: (cx, cy, radius, height)

    def as_arrays(self, device=None):
        """float32 tensors (W, 5) and (P, 4)."""
        walls = np.asarray(self.walls, np.float32).reshape(-1, 5)
        poles = np.asarray(self.poles, np.float32).reshape(-1, 4)
        return (torch.as_tensor(walls, device=device),
                torch.as_tensor(poles, device=device))


def default_world() -> World:
    """A corridor with poles: planar surfs, wall-corner and pole edges."""
    walls = (
        (-10.0, -8.0, 40.0, -8.0, 4.0),
        (-10.0, 8.0, 40.0, 8.0, 4.0),
        (40.0, -8.0, 40.0, 8.0, 4.0),
        (-10.0, -8.0, -10.0, 8.0, 4.0),
        (6.0, -8.0, 6.0, -5.5, 3.0),
        (12.0, 8.0, 12.0, 5.0, 3.0),
        (15.0, -8.0, 15.0, -3.0, 3.0),
        (20.0, 8.0, 20.0, 4.5, 3.0),
        (25.0, -8.0, 25.0, -4.0, 3.0),
        (30.0, 8.0, 30.0, 3.0, 3.0),
        (35.0, -8.0, 35.0, -5.0, 3.0),
        (2.0, 8.0, 2.0, 5.5, 3.0),
    )
    poles = (
        (5.0, -4.0, 0.06, 5.0),
        (8.0, 3.0, 0.06, 5.0),
        (18.0, 2.0, 0.05, 5.0),
        (22.0, -5.0, 0.06, 5.0),
        (30.0, 0.0, 0.07, 5.0),
        (12.0, 6.0, 0.05, 5.0),
        (34.0, -6.0, 0.06, 5.0),
        (2.0, 6.5, 0.05, 5.0),
    )
    return World(walls=walls, poles=poles)


def long_world() -> World:
    """The default corridor continued to x = 120 m: its side walls run on,
    its end wall moves to x = 120, and its cross walls and poles repeat
    every 40 m, so that a gentle drive at 1.5 m/s stays inside it for over
    70 s."""
    base = default_world()
    inner_walls = [w for w in base.walls if w[0] == w[2] and w[0] not in
                   (-10.0, 40.0)]
    walls = [(-10.0, -8.0, 120.0, -8.0, 4.0), (-10.0, 8.0, 120.0, 8.0, 4.0),
             (120.0, -8.0, 120.0, 8.0, 4.0), (-10.0, -8.0, -10.0, 8.0, 4.0)]
    poles = []
    for dx in (0.0, 40.0, 80.0):
        walls += [(x0 + dx, y0, x1 + dx, y1, h)
                  for x0, y0, x1, y1, h in inner_walls]
        poles += [(cx + dx, cy, r, h) for cx, cy, r, h in base.poles]
    return World(walls=tuple(walls), poles=tuple(poles))


WORLDS = {"default": default_world, "long": long_world}


def _ellipse_rate(a, b, speed):
    per = np.pi * (3.0 * (a + b) - np.sqrt((3.0 * a + b) * (a + 3.0 * b)))
    return 2.0 * np.pi * speed / per


def make_trajectory(kind: str = "gentle", speed: float = 1.0,
                    z0: float = 0.8, loop_scale: float = 1.0) -> Callable:
    """pose(t) -> (p_world (3,), q_wb (4,) wxyz) for a 0-dim tensor t; the
    body x-axis follows the direction of travel, with a small roll/pitch
    wobble."""
    sin, cos = torch.sin, torch.cos
    if kind == "gentle":
        def pos(t):
            return torch.stack([speed * t, 1.5 * sin(0.15 * t),
                                z0 + 0.05 * sin(0.3 * t)])
    elif kind == "loop":
        a, b = 14.0 * loop_scale, 5.5 * loop_scale
        om = _ellipse_rate(a, b, speed)

        def pos(t):
            return torch.stack([a * (1.0 - cos(om * t)), b * sin(om * t),
                                z0 + 0.05 * sin(0.3 * t)])
    else:
        raise ValueError(f"unknown trajectory kind {kind!r}")

    vel = jacfwd(pos)

    def pose(t):
        p = pos(t)
        v = vel(t)
        yaw = torch.atan2(v[1], torch.where(torch.abs(v[0]) < 1e-9, 1e-9,
                                            v[0]))
        roll = 0.02 * sin(0.5 * t)
        pitch = 0.02 * sin(0.37 * t + 1.0)
        q = so3.rpy_to_quat(torch.stack([roll, pitch, yaw]))
        return p, q

    return pose


def _ray_world_hits(origin, direction, walls, poles, max_range):
    """Least positive hit distance of rays (..., 3) against the ground,
    the walls and the poles (world constants float32, rays float64)."""
    dt = origin.dtype
    o = [origin[..., i, None] for i in range(3)]
    d = [direction[..., i, None] for i in range(3)]
    t_best = torch.full(origin.shape[:-1], max_range, dtype=dt,
                        device=origin.device)

    dz = d[2][..., 0]
    t_g = torch.where(dz < -1e-6,
                      -o[2][..., 0] / torch.where(dz < -1e-6, dz, -1.0),
                      torch.inf)
    t_best = torch.minimum(t_best, torch.where(t_g > 0.1, t_g, torch.inf))

    x0, y0, x1, y1, h = walls.unbind(-1)
    ex, ey = x1 - x0, y1 - y0
    seg_len2 = ex * ex + ey * ey
    x0, y0, h, ex, ey, seg_len2 = (v.to(dt)
                                   for v in (x0, y0, h, ex, ey, seg_len2))
    denom = d[0] * ey - d[1] * ex
    num = (x0 - o[0]) * ey - (y0 - o[1]) * ex
    t_w = torch.where(torch.abs(denom) > 1e-9, num / denom, torch.inf)
    px = o[0] + t_w * d[0]
    py = o[1] + t_w * d[1]
    pz = o[2] + t_w * d[2]
    u = ((px - x0) * ex + (py - y0) * ey) / torch.clamp(seg_len2, min=1e-9)
    ok = (t_w > 0.1) & (u >= 0.0) & (u <= 1.0) & (pz >= 0.0) & (pz <= h)
    t_best = torch.minimum(
        t_best, torch.amin(torch.where(ok, t_w, torch.inf), dim=-1))

    cx, cy, r, ph = poles.unbind(-1)
    r2 = (r * r).to(dt)
    cx, cy, ph = cx.to(dt), cy.to(dt), ph.to(dt)
    ox, oy = o[0] - cx, o[1] - cy
    a = d[0] ** 2 + d[1] ** 2
    b = 2.0 * (ox * d[0] + oy * d[1])
    c = ox * ox + oy * oy - r2
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_p = (-b - sq) / torch.clamp(2 * a, min=1e-9)
    pz = o[2] + t_p * d[2]
    ok = (disc > 0) & (t_p > 0.1) & (pz >= 0.0) & (pz <= ph)
    return torch.minimum(
        t_best, torch.amin(torch.where(ok, t_p, torch.inf), dim=-1))


def raycast_scans(pose_fn, t0s, walls, poles, sensor, max_range=80.0):
    """Sweeps starting at the times `t0s` (a list of floats), each with
    motion distortion.  Returns (xyz (B, L*S, 3) float64, hit (B, L*S)),
    points azimuth-major in the sensor frame at firing time."""
    L, S = sensor.line_num, sensor.scan_num
    dev, f64 = walls.device, torch.float64
    rel = torch.arange(S, dtype=f64, device=dev) * (1.0 / S)
    t0 = torch.as_tensor(t0s, dtype=f64, device=dev)
    times = t0[:, None] + rel[None, :] * sensor.scan_period     # (B, S)

    az = math.pi - 2.0 * math.pi * rel
    elev = so3.deg2rad(-sensor.ang_bottom + 0.1 + sensor.ang_res_y
                       * torch.arange(L, dtype=torch.float32, device=dev))
    ce, se = torch.cos(elev).to(f64), torch.sin(elev).to(f64)
    ca, sa = torch.cos(az), torch.sin(az)
    dirs = torch.stack([ce[None, :] * ca[:, None], ce[None, :] * sa[:, None],
                        se[None, :].expand(S, L)], dim=-1)   # (S, L, 3)

    B = len(t0s)
    p, q = vmap(pose_fn)(times.reshape(-1))
    p, q = p.reshape(B, S, 3), q.reshape(B, S, 4)
    d_world = so3.quat_rotate(q[:, :, None, :], dirs[None])
    ranges = _ray_world_hits(p[:, :, None, :].expand(B, S, L, 3), d_world,
                             walls, poles, max_range)        # (B, S, L)
    hit = ranges < max_range - 1e-3
    pts = dirs[None] * ranges[..., None]
    return pts.reshape(B, L * S, 3), hit.reshape(B, L * S)


def compact_scans(pts, hit, max_points: int):
    """Drop misses, keep the first `max_points` hits of each sweep in
    order, pad with zeros: (xyz (B, max_points, 3) float32, n (B,) int)
    on the device."""
    B = pts.shape[0]
    slot = torch.cumsum(hit.to(torch.int64), dim=1) - 1
    keep = hit & (slot < max_points)
    out = torch.zeros((B, max_points, 3), dtype=torch.float32,
                      device=pts.device)
    b = torch.arange(B, device=pts.device)[:, None].expand_as(slot)
    out[b[keep], slot[keep]] = pts[keep].to(torch.float32)
    n = torch.clamp(hit.sum(dim=1), max=max_points)
    return out, n


def generate_imu(pose_fn, t_start, t_end, rate, ba=(0, 0, 0), bw=(0, 0, 0),
                 acc_noise=0.0, gyr_noise=0.0, seed=0, gravity=9.81,
                 device=None):
    """IMU samples on [t_start, t_end] from the analytic trajectory:
    acc = R_wbᵀ (p̈ - g) + ba + n, gyr = (R_wbᵀ Ṙ_wb)∨ + bw + n, the
    derivatives by forward-mode autodiff, the noise numpy's (`seed`)."""
    def p_of_t(t):
        return pose_fn(t)[0]

    def q_of_t(t):
        return pose_fn(t)[1]

    acc_w_fn = jacfwd(jacfwd(p_of_t))
    dq_fn = jacfwd(q_of_t)
    n = int(round((t_end - t_start) * rate)) + 1
    times = np.asarray(t_start + np.arange(n) / rate, np.float64)
    g = torch.zeros(3, dtype=torch.float64, device=device)
    g[2] = -gravity

    def sample(t):
        _, q = pose_fn(t)
        f_b = so3.quat_rotate_inv(q, acc_w_fn(t) - g)
        wq = 2.0 * so3.quat_mul(so3.quat_conj(q), dq_fn(t))
        return f_b, wq[1:4]

    accs, gyrs = vmap(sample)(torch.as_tensor(times, device=device))
    rng = np.random.default_rng(seed)
    accs = (accs.cpu().numpy() + np.asarray(ba)
            + rng.normal(0, acc_noise, (n, 3)))
    gyrs = (gyrs.cpu().numpy() + np.asarray(bw)
            + rng.normal(0, gyr_noise, (n, 3)))
    return times, accs.astype(np.float64), gyrs.astype(np.float64)


def generate_sequence(sensor, n_scans: int = 20, kind: str = "gentle",
                      speed: float = 1.0, world: World | None = None,
                      imu_rate: float = 400.0, ba=(0, 0, 0), bw=(0, 0, 0),
                      acc_noise: float = 0.0, gyr_noise: float = 0.0,
                      seed: int = 0, loop_scale: float = 1.0, device=None):
    """Scans, IMU and ground-truth poses of `n_scans` sweeps from t=0, made
    on `device`.  Returns host numpy arrays: scans_xyz (n, max_points, 3)
    float32, scans_n (n,), scan_times (n,) (sweep starts), imu_times / acc
    / gyr, gt_pos / gt_quat at each sweep's end; and pose_fn."""
    dev = torch.device(device or "cuda")
    world = world or default_world()
    walls, poles = world.as_arrays(dev)
    pose_fn = make_trajectory(kind, speed, loop_scale=loop_scale)

    # sweeps start at float32 times, as the port's generator starts them
    t0s = [float(np.float32(k * sensor.scan_period)) for k in range(n_scans)]
    per = max(1, RAYS_PER_CALL // (sensor.line_num * sensor.scan_num))
    scans = np.zeros((n_scans, sensor.max_points, 3), np.float32)
    counts = np.zeros(n_scans, np.int64)
    for s in range(0, n_scans, per):
        pts, hit = raycast_scans(pose_fn, t0s[s:s + per], walls, poles,
                                 sensor)
        xyz, n = compact_scans(pts, hit, sensor.max_points)
        scans[s:s + per] = xyz.cpu().numpy()
        counts[s:s + per] = n.cpu().numpy()
        del pts, hit, xyz

    t_end = n_scans * sensor.scan_period
    imu_t, acc, gyr = generate_imu(pose_fn, 0.0, t_end + 0.01, imu_rate,
                                   ba, bw, acc_noise, gyr_noise, seed,
                                   sensor.gravity, device=dev)

    scan_times = np.arange(n_scans) * sensor.scan_period
    end_times = (scan_times + sensor.scan_period).astype(np.float32)
    gt_p, gt_q = vmap(pose_fn)(torch.as_tensor(end_times.astype(np.float64),
                                               device=dev))
    return dict(
        scans_xyz=scans, scans_n=counts.astype(np.int32),
        scan_times=scan_times, imu_times=imu_t, imu_acc=acc, imu_gyr=gyr,
        gt_pos=gt_p.cpu().numpy().astype(np.float32),
        gt_quat=gt_q.cpu().numpy().astype(np.float32),
        pose_fn=pose_fn,
    )
