"""Multi-stream replay mode: several drives replayed at once through
`parallel/replay.py::make_sharded_slam_replay` on a one-device mesh, as a
user replays several sequences at once.  Each stream bootstraps through
its own `LinsSlam.stage_replay`; the streams' states are then stacked and
every chunk of all streams goes through one call of the batched step,
fenced by `torch.cuda.synchronize()`.

Set-up: the drives made from the seed (stream b draws seed + b), each
stream's `LinsSlam`, `warmup` and `stage_replay`, the stacking, and the
first batched chunk.  The window counts every stream's fused poses after
that, later bootstraps included.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drive import host, scan_index


def _bootstrap(ctx, drives):
    """Each stream's LinsSlam staged; the batch-leading states and the
    stacked chunks of all streams."""
    from lins_tpu_torch.parallel import replay as rp
    from lins_tpu_torch.utils.tree import tree_map

    K = ctx.traffic["chunk"]
    slams, jobs = [], []
    with ctx.tracer.span("driver.stage_replay"):
        for data in drives:
            slam = ctx.new_slam()
            j, _ = slam.stage_replay(data, chunk=K,
                                     min_streamed=ctx.traffic["streamed"])
            slams.append(slam)
            jobs.append(j)
    if len({len(j) for j in jobs}) != 1 or not jobs[0]:
        raise RuntimeError("the streams staged different numbers of chunks")
    for ci in range(len(jobs[0])):
        flags = [(j[ci][1][1], j[ci][1][2]) for j in jobs]
        if not all((m == flags[0][0]).all() and (lf == flags[0][1]).all()
                   for m, lf in flags):
            raise RuntimeError("the streams' cadence flags differ")
    odo = rp.stack_lanes([tree_map(torch.clone, (
        s.odometry.filter_state, s.odometry.global_state,
        s.odometry.last_surf, s.odometry.last_corner)) for s in slams])
    maps = rp.stack_lanes([tree_map(torch.clone, s.mapper.state)
                           for s in slams])
    chunks = []
    for ci in range(len(jobs[0])):
        js = [j[ci] for j in jobs]
        chunks.append(dict(
            ts_host=js[0][0][0],
            xyz=torch.stack([j[0][1] for j in js]),
            n=torch.stack([j[0][2] for j in js]),
            imu=[torch.stack([j[0][3][i] for j in js]) for i in range(4)],
            ts=torch.stack([j[1][0] for j in js]),
            rp=torch.stack([j[1][3] for j in js]),
            mf=js[0][1][1], lf=js[0][1][2]))
    has_map = any(s.mapper._has_map for s in slams)
    return dict(slams=slams, odo=odo, maps=maps, chunks=chunks,
                has_map=has_map, fused=[], surf=[])


def _step(ctx, step, run, ci):
    from lins_tpu_torch.utils.tree import tree_map

    c = run["chunks"][ci]
    odo, maps = run["odo"], run["maps"]
    lanes = [c["xyz"], c["n"], *c["imu"], c["ts"], c["rp"]]
    if ctx.fault == "half":
        # the planted fault: half of the streams left out of the step
        half = c["xyz"].shape[0] // 2
        odo, maps, lanes = tree_map(lambda x: x[:half], (odo, maps, lanes))
    with ctx.tracer.span("replay.sharded_step"):
        odo, maps, (pos, quat) = step(odo, maps, *lanes, c["mf"], c["lf"],
                                      has_map=run["has_map"])
    if ctx.fault != "half":
        run["odo"], run["maps"] = odo, maps
    run["has_map"] = run["has_map"] or bool(np.any(c["mf"]))
    i0 = scan_index(c["ts_host"][0], ctx.cfg.scan_period)
    run["fused"].append((i0, pos, quat))
    last = scan_index(c["ts_host"][-1], ctx.cfg.scan_period)
    run["surf"].append((last, odo[2]["xyz"], odo[2]["valid"]))
    harness.sync(ctx.device)
    return pos.shape[0] * pos.shape[1]


def _outputs(ctx, drives, run):
    """Each stream's outputs on the host (one entry per stream)."""
    out = []
    for b, (data, slam) in enumerate(zip(drives, run["slams"])):
        ts, ps, qs = slam.trajectory_arrays()
        fused = [(scan_index(t, ctx.cfg.scan_period), p, q)
                 for t, p, q in zip(ts, ps, qs)]
        for i0, pos, quat in run["fused"]:
            if b >= len(pos):
                continue
            p, q = host(pos[b]), host(quat[b])
            fused.extend((i0 + k, p[k], q[k]) for k in range(len(p)))
        surf = [(i, host(x[b]), host(v[b])) for i, x, v in run["surf"]
                if b < len(x)]
        out.append(dict(data=data, fused=fused, odo=[], surf=surf, edges=[],
                        loops=0))
    return out


def run(ctx):
    from lins_tpu_torch.parallel import replay as rp

    speeds = ctx.traffic["speeds"]
    drives = [ctx.make_drive(b, speed) for b, speed in enumerate(speeds)]
    ctx.done_generating()
    step, _ = rp.make_sharded_slam_replay(ctx.cfg, rp.make_mesh(1, device=ctx.device))
    run_ = _bootstrap(ctx, drives)
    _step(ctx, step, run_, 0)
    runs, ci = [run_], 1

    t0 = ctx.start_window()
    produced, attempted, t_last = 0, 0, t0
    B, K = len(speeds), ctx.traffic["chunk"]
    while ctx.window_open():
        if ci == len(run_["chunks"]):
            run_ = _bootstrap(ctx, drives)
            runs.append(run_)
            n = sum(len(s.trajectory) for s in run_["slams"])
            produced += n
            attempted += n
            ci = 0
            t_last = time.perf_counter()
            continue
        if ctx.tracer.on and ctx.profiled is None:
            ctx.profiled = harness.Profiled(ctx.tracer, B * K)
            with ctx.profiled:
                produced += _step(ctx, step, run_, ci)
        else:
            produced += _step(ctx, step, run_, ci)
        attempted += B * K
        ci += 1
        t_last = time.perf_counter()
    window_s = t_last - t0
    return dict(
        metrics={"replay_scans_per_s": produced / window_s},
        attempted=attempted, produced=produced, window_s=window_s,
        collect=lambda: [o for r in runs for o in _outputs(ctx, drives, r)],
        drives=len(runs), release=runs.clear, note=f"{B} streams")
