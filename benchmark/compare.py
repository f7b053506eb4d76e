"""The comparison that decides `correct`: the numbers the reference
(benchmark/reference.py) reads from the port's outputs, each held to its
limit in benchmark/limits/<cell>.json ({"max": x} or {"min": x}).

Numbers (millimetres unless a count):
  surf_end_p50_mm    median distance to the world's surfaces of the surf
                     feature points fired in the last 2% of their sweep,
                     placed by the true pose (the front end's clouds)
  odom_step_p50_mm   median error of the odometry's scan-to-scan
                     translation (the odometry's poses)
  fused_ate_mm       the largest, over drives, RMS error of the fused
                     positions after a rigid fit (the mapper's output)
  fused_max_mm       the largest error of any fused position after that
                     fit (every answer judged)
  loops              loops the mapper accepted (a loop that never comes)
  loop_edge_max_mm   the largest translation error of an accepted loop
                     edge (the loop closures and what the solve is fed)
  loop_edge_p50_mm   the median of those errors
"""
from __future__ import annotations

import numpy as np

from benchmark import generator, reference

# fewest poses of a drive for its fit to count
MIN_FIT = 10


def numbers(outputs: list, traffic: dict) -> dict:
    """Every number the outputs give, over all drives of the run."""
    world = generator.WORLDS[traffic["drive"]["world"]]()
    walls, poles = world.as_arrays("cpu")
    late, steps, ate, worst, edges, loops = [], [], [], [], [], 0
    for out in outputs:
        data = out["data"]
        gt_p, gt_q = data["gt_pos"], data["gt_quat"]
        late.append(reference.late_surf_distances(out["surf"], gt_p, gt_q,
                                                  walls, poles).numpy())
        odo = sorted(out["odo"], key=lambda r: r[0])
        for a, b in zip(odo, odo[1:]):
            if b[0] == a[0] + 1:
                steps.append(reference.increment_errors(
                    np.stack([a[1], b[1]]), np.stack([a[2], b[2]]),
                    gt_p[[a[0], b[0]]], gt_q[[a[0], b[0]]])[0])
        fused = sorted(out["fused"], key=lambda r: r[0])
        if len(fused) >= MIN_FIT:
            idx = [i for i, _, _ in fused]
            err = reference.fitted_errors(np.stack([p for _, p, _ in fused]),
                                          gt_p[idx])
            ate.append(float(np.sqrt(np.mean(err ** 2))))
            worst.append(float(err.max()))
        if out["edges"]:
            edges.append(reference.loop_edge_errors(out["edges"],
                                                    data["pose_fn"]))
        loops += out["loops"]
    late = np.concatenate(late) if late else np.zeros(0)
    got = dict(loops=loops)
    if len(late):
        got["surf_end_p50_mm"] = float(np.median(late)) * 1e3
    if steps:
        got["odom_step_p50_mm"] = float(np.median(steps)) * 1e3
    if ate:
        got["fused_ate_mm"] = max(ate) * 1e3
        got["fused_max_mm"] = max(worst) * 1e3
    edges = np.concatenate(edges) if edges else np.zeros(0)
    if len(edges):
        got["loop_edge_max_mm"] = float(edges.max()) * 1e3
        got["loop_edge_p50_mm"] = float(np.median(edges)) * 1e3
    return got


def judge(got: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every limited number must be
    present and within its limit; a missing one fails."""
    shown, ok = {}, True
    for name, lim in limits.items():
        value = got.get(name)
        if "max" in lim:
            good = value is not None and value <= lim["max"]
            shown[name] = {"value": value, "limit": f"<= {lim['max']}"}
        else:
            good = value is not None and value >= lim["min"]
            shown[name] = {"value": value, "limit": f">= {lim['min']}"}
        ok &= bool(good)
    return ok, shown
