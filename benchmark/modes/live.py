"""Live mode: a drive streamed one scan at a time, closed loop, as a robot
beside the sensor runs it: each scan's IMU samples and the scan are handed
to `LinsSlam.add_imu` / `add_scan`, and the next scan goes in when the
fused pose is on the host.  A scan's latency runs from handing its IMU and
scan over until its fused pose is on the host.

Set-up: the drive made from the seed, `LinsSlam`, `warmup`, and streaming
until the odometry runs, the mapper has made its first steps and two loop
attempts have run, so that every shape of the cell is warm.  A drive
that ends in the window is followed by a new `LinsSlam` on the same drive:
its construction and the scans it takes to initialise (as many as the
first drive's took) are the set-up of that drive, and their time counts
in the latency of its first fused pose.
"""
from __future__ import annotations

import time

import numpy as np

from benchmark import harness
from benchmark.drive import host, slam_outputs

# loop attempts that must have run before the window opens
WARM_ATTEMPTS = 2


class Stream:
    """One drive fed scan by scan, with the IMU up to each scan's end."""

    def __init__(self, ctx, data):
        self.ctx, self.data = ctx, data
        self.slam = ctx.new_slam()
        self.clouds = []
        self.k = self.imu_i = 0
        odo, mapper = self.slam.odometry, self.slam.mapper
        ctx.tracer.wrap(odo, "add_scan", "odometry.add_scan")
        ctx.tracer.wrap(mapper, "process", "mapper.process")
        ctx.tracer.wrap(mapper, "maybe_close_loop", "mapper.maybe_close_loop")

    def done(self) -> bool:
        return self.k >= len(self.data["scans_xyz"])

    def step(self):
        """Hand scan k and its IMU over; returns the fused pose on the
        host, or None while the odometry initialises."""
        d, slam, k = self.data, self.slam, self.k
        t_scan = float(d["scan_times"][k]) + self.ctx.cfg.scan_period
        imu_t = d["imu_times"]
        while self.imu_i < len(imu_t) and imu_t[self.imu_i] <= t_scan + 1e-9:
            i = self.imu_i
            slam.add_imu(imu_t[i], d["imu_acc"][i], d["imu_gyr"][i])
            self.imu_i += 1
        out = slam.add_scan(t_scan, d["scans_xyz"][k], d["scans_n"][k])
        self.k += 1
        if out is None:
            return None
        surf = slam.odometry.last_surf
        self.clouds.append((k, surf["xyz"], surf["valid"]))
        pos, quat = out
        return host(pos), host(quat)


def run(ctx):
    data = ctx.make_drive()
    ctx.done_generating()
    s = Stream(ctx, data)
    streams = [s]
    init_scans = None    # scans the odometry took to give its first pose
    while not (len(s.slam.mapper.loop_info) >= WARM_ATTEMPTS
               and s.slam.mapper.metrics):
        if s.done():
            raise RuntimeError("the drive ends before the cell is warm")
        if s.step() is not None and init_scans is None:
            init_scans = s.k - 1

    t0 = ctx.start_window()
    lat, attempted, profile_scans = [], 0, ctx.traffic["profile_scans"]
    t_in = None          # when the answer now awaited was asked for
    while ctx.window_open():
        if s.done():
            t_in = time.perf_counter()
            s = Stream(ctx, data)
            streams.append(s)
        if ctx.tracer.on and ctx.profiled is None:
            ctx.profiled = harness.Profiled(ctx.tracer, profile_scans)
            ctx.profiled.__enter__()
        if t_in is None:
            t_in = time.perf_counter()
        pose = s.step()
        if pose is None and s.k <= init_scans and not s.clouds:
            continue     # a new drive initialising: its set-up
        attempted += 1
        if pose is not None:
            lat.append(time.perf_counter() - t_in)
        t_in = None
        if ctx.profiled is not None and attempted == profile_scans:
            ctx.profiled.__exit__(None, None, None)
    if ctx.profiled is not None and attempted < profile_scans:
        ctx.profiled.__exit__(None, None, None)
        ctx.profiled.scans = attempted
    window_s = time.perf_counter() - t0
    ms = np.asarray(lat) * 1e3
    return dict(
        metrics={"live_p50_ms": float(np.percentile(ms, 50)),
                 "live_p95_ms": float(np.percentile(ms, 95))},
        attempted=attempted, produced=len(lat), window_s=window_s,
        collect=lambda: [slam_outputs(x.slam, data, x.clouds,
                                      ctx.cfg.scan_period) for x in streams],
        drives=len(streams), release=streams.clear,
        note=f"{len(lat)} latencies")
