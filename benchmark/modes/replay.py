"""Replay mode: logged drives replayed back to back, each as a user
replays one: a new `LinsSlam`, `stage_replay` (the bootstrap streamed
until the odometry runs, the rest staged on the device), then `run_chunk`
for each chunk, fenced by `torch.cuda.synchronize()` at each chunk's end.

Set-up: the drive made from the seed, the first drive's `LinsSlam`,
`warmup`, `stage_replay` and its first chunk.  The window counts every
fused pose completed after that, later drives' bootstraps and staging
included, over the time from its start to the last fence.
"""
from __future__ import annotations

import time

from benchmark import harness
from benchmark.drive import scan_index, slam_outputs


def _stage(ctx, data, name="driver.stage_replay"):
    slam = ctx.new_slam()
    ctx.tracer.wrap(slam.odometry, "add_scan_chunk",
                    "odometry.add_scan_chunk")
    if slam.mapper is not None:
        ctx.tracer.wrap(slam.mapper, "process_chunk", "mapper.process_chunk")
    with ctx.tracer.span(name):
        jobs, _ = slam.stage_replay(data, chunk=ctx.traffic["chunk"],
                                    min_streamed=ctx.traffic["streamed"])
    return slam, jobs, []


def _run_chunk(ctx, slam, job, clouds):
    slam.run_chunk(job)
    c = slam.odometry.last_chunk_clouds
    clouds.append((scan_index(job[0][0][0], ctx.cfg.scan_period), c["sxyz"],
                   c["sval"]))
    harness.sync(ctx.device)


def run(ctx):
    K = ctx.traffic["chunk"]
    data = ctx.make_drive()
    ctx.done_generating()
    slam, jobs, clouds = _stage(ctx, data)
    if not jobs:
        raise RuntimeError("the drive stages no chunk")
    _run_chunk(ctx, slam, jobs[0], clouds)
    drives = [(slam, clouds)]
    ci = 1
    poses0 = len(slam.trajectory)

    t0 = ctx.start_window()
    produced, attempted, t_last = 0, 0, t0
    while ctx.window_open():
        if ci == len(jobs):
            slam, jobs, clouds = _stage(ctx, data, "driver.restage")
            drives.append((slam, clouds))
            produced += len(slam.trajectory)
            attempted += len(slam.trajectory)
            ci = 0
            t_last = time.perf_counter()
            continue
        n0 = len(slam.trajectory)
        if ctx.tracer.on and ctx.profiled is None:
            ctx.profiled = harness.Profiled(ctx.tracer, K)
            with ctx.profiled:
                _run_chunk(ctx, slam, jobs[ci], clouds)
        else:
            _run_chunk(ctx, slam, jobs[ci], clouds)
        ci += 1
        produced += len(slam.trajectory) - n0
        attempted += K
        t_last = time.perf_counter()
    window_s = t_last - t0
    return dict(
        metrics={"replay_scans_per_s": produced / window_s},
        attempted=attempted, produced=produced, window_s=window_s,
        collect=lambda: [slam_outputs(s, data, c, ctx.cfg.scan_period)
                         for s, c in drives],
        drives=len(drives), release=drives.clear,
        note=f"{poses0} poses in set-up")
