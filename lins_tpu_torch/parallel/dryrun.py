"""Driver entry points over the port: a one-device forward step and the
multi-device dry run (the counterparts of `__graft_entry__.py`'s `entry`
and `dryrun_multichip`).

entry(): the per-scan odometry step (front end + IMU propagation + IESKF)
on a small VLP-16 configuration, with example inputs.

dryrun_multichip(n): an n-shard mesh; the batched per-scan step and the
full SLAM replay over a batch of n streams (data parallelism over
sequences, SURVEY.md §2 P4), the edge-sharded sparse pose-graph solve
(P3), and the window map rebuilt from a keyframe store sharded along the
keyframe axis over the mesh (P3).
"""
from __future__ import annotations

import numpy as np
import torch

from lins_tpu_torch.utils.device import resolve_device
from lins_tpu_torch.utils.tree import tree_map


def _small_cfg():
    from lins_tpu_torch.config import VLP16

    return VLP16.replace(
        max_points=4096, max_sharp=64, max_less_sharp=256, max_flat=128,
        max_less_flat=512, max_outlier=256, max_imu_per_scan=8, num_iter=3)


def _scan_inputs(cfg, batch=None, seed=0, device=None):
    """A crude room (random points on the walls of a 10 m box and a floor)
    and a static IMU batch, one scan or `batch` of them."""
    rng = np.random.default_rng(seed)
    n, m = cfg.max_points, cfg.max_imu_per_scan

    def one():
        pts = np.zeros((n, 3), np.float32)
        face = rng.integers(0, 3, n)
        u = rng.uniform(-5, 5, n).astype(np.float32)
        v = rng.uniform(0, 3, n).astype(np.float32)
        pts[:, 0] = np.where(face == 0, 5.0, u)
        pts[:, 1] = np.where(face == 1, 5.0, u)
        pts[:, 2] = np.where(face == 2, -0.8, v - 0.8)
        return pts

    lead = () if batch is None else (batch,)
    xyz = (one() if batch is None
           else np.stack([one() for _ in range(batch)]))
    out = (xyz, np.full(lead, n, np.int32), np.full(lead + (m,), 0.0125),
           np.broadcast_to(np.asarray([0.0, 0.0, 9.81]), lead + (m, 3)),
           np.zeros(lead + (m, 3)), np.ones(lead + (m,), bool))
    dt = torch.float32
    return tuple(torch.as_tensor(np.array(a)).to(
        device, dt if np.asarray(a).dtype == np.float64 else None)
        for a in out)


def entry(device=None):
    """(fn, example_args): the per-scan RUNNING step on one device, fn
    returning the global position, attitude and IESKF residual."""
    from lins_tpu_torch.frontend.pipeline import process_cloud
    from lins_tpu_torch.imu import eskf
    from lins_tpu_torch.odometry import estimator as est

    dev = resolve_device(device)
    cfg = _small_cfg()

    def fn(filter_state, global_state, last_surf, last_corner, xyz, n_points,
           dts, accs, gyrs, imu_valid):
        _, _, feats = process_cloud(xyz, n_points, cfg)
        out = est.running_step_impl(filter_state, global_state, feats,
                                    last_surf, last_corner, dts, accs, gyrs,
                                    imu_valid, cfg)
        g, metrics = out[1], out[6]
        return g.rn, g.qbn, metrics["residual"]

    dt = torch.float32
    fs = eskf.initial_state(cfg, acc=[0, 0, cfg.gravity], dtype=dt,
                            device=dev)
    gs = est.identity_nominal(cfg, dt, dev)
    surf = est.dummy_feature_ref(cfg.max_less_flat, dt, dev)
    corner = est.dummy_feature_ref(cfg.max_less_sharp, dt, dev)
    return fn, (fs, gs, surf, corner) + _scan_inputs(cfg, device=dev)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """An n-shard mesh (n cards, or with device="cpu" n shards of the CPU)
    and the engine's parallel axes on it: P4, the batched per-scan step and
    the full SLAM replay over n streams; P3, the edge-sharded sparse
    pose-graph solve and the window map rebuilt from a keyframe store
    sharded over the mesh (equal to the unsharded rebuild).  Returns what
    ran and what was skipped."""
    from lins_tpu_torch.geom import so3
    from lins_tpu_torch.graph import pose_graph as pg
    from lins_tpu_torch.mapping import keyframes as kf
    from lins_tpu_torch.mapping import local_map as lmn
    from lins_tpu_torch.mapping.mapper import LinsMapper
    from lins_tpu_torch.parallel.dist_graph import make_sharded_cg_optimizer
    from lins_tpu_torch.parallel.replay import (
        batched_initial_states, batched_mapper_state, batched_scan_step,
        make_mesh, make_sharded_slam_replay)
    from lins_tpu_torch.parallel.shard_map_store import shard_store

    dev = resolve_device(device)
    cfg = _small_cfg()
    mesh = make_mesh(n_devices, device=dev)
    batch = mesh.size

    # --- P4: the batched per-scan step ------------------------------------
    states = batched_initial_states(cfg, batch, device=dev)
    scans = _scan_inputs(cfg, batch, device=dev)
    out = batched_scan_step(cfg, mesh)(*states, *scans)
    g_rn = out[1].rn
    assert g_rn.shape == (batch, 3) and bool(torch.isfinite(g_rn).all())

    # --- P4 at the full pipeline: odometry chunk + mapping cadence + loop
    # attempts + fused poses per stream --------------------------------------
    # coarser map leaves and a small store keep the n mapper states small
    mcfg = cfg.replace(map_corner_leaf=0.6, map_surf_leaf=0.8,
                       map_outlier_leaf=0.8, max_map_corner=8192,
                       max_map_surf=16384, max_keyframes=64,
                       surrounding_keyframe_search_num=16)
    K = 3
    slam_step, put = make_sharded_slam_replay(mcfg, mesh)
    odo_b = batched_initial_states(mcfg, batch, device=dev)
    map_b = batched_mapper_state(mcfg, batch, device=dev)

    def rep_k(x):          # (B, ...) -> (B, K, ...) chunk axis
        return x[:, None].expand((batch, K) + x.shape[1:]).contiguous()

    chunk = [rep_k(x) for x in _scan_inputs(mcfg, batch, device=dev)]
    ts = (0.1 * (1 + torch.arange(K, dtype=torch.float32, device=dev))
          ).expand(batch, K).contiguous()
    rp = torch.full((batch, K, 2), float("nan"), device=dev)
    mf, lf = np.asarray([True, False, True]), np.asarray([False, True, False])
    assert LinsMapper(mcfg, device=dev)._loops()
    odo_b, map_b, (pos, quat) = slam_step(odo_b, map_b, *put(chunk),
                                          put(ts), put(rp), mf, lf)
    assert pos.shape == (batch, K, 3) and bool(torch.isfinite(pos).all())
    assert bool((map_b.store.count >= 1).all())

    # --- P3: edge-sharded sparse pose-graph solve -------------------------
    nodes = 64
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=dev)
    pos_gt = torch.as_tensor(np.cumsum(rng.uniform(-1, 1, (nodes, 3)),
                                       axis=0), **f32)
    q = torch.zeros((nodes, 4), **f32)
    q[:, 0] = 1.0
    edges = pg.empty_edges(nodes + 8, device=dev)
    pairs = [(k, k + 1) for k in range(nodes - 1)] + [(0, nodes - 1)]
    for i, j in pairs:
        t_rel, q_rel = pg.relative_pose(pos_gt[i], q[i], pos_gt[j], q[j])
        edges = pg.add_edge(edges, torch.tensor(i, device=dev),
                            torch.tensor(j, device=dev), t_rel, q_rel,
                            torch.tensor(1e4, **f32),
                            torch.tensor(1e4, **f32))
    noise = rng.normal(0, 0.2, (nodes, 3))
    noise[0] = 0.0        # node 0 carries the gauge prior
    noisy = pos_gt + torch.as_tensor(noise, **f32)
    opt = make_sharded_cg_optimizer(mesh, nodes, iters=4, cg_iters=32)
    pos_s, _ = opt(noisy, so3.quat_normalize(q), torch.tensor(nodes), edges)
    err0 = float(torch.linalg.vector_norm(noisy - pos_gt))
    err1 = float(torch.linalg.vector_norm(pos_s - pos_gt))
    assert bool(torch.isfinite(pos_s).all()) and err1 < err0, (err1, err0)

    # --- P3: keyframe-axis-sharded store -> window map rebuild -----------
    kcfg = cfg.replace(max_keyframes=4 * mesh.size)
    store = kf.empty_store(kcfg, 64, 128, 32, device=dev)

    def cloud(n):
        return torch.as_tensor(rng.uniform(-5, 5, (n, 3)), **f32)

    for i in range(3 * mesh.size):
        ones = [torch.ones(n, dtype=torch.bool, device=dev)
                for n in (64, 128, 32)]
        store = kf.add_keyframe(
            store, torch.as_tensor(rng.uniform(-3, 3, 3), **f32),
            so3.quat_normalize(torch.as_tensor(rng.normal(size=4), **f32)),
            torch.tensor(float(i), **f32), cloud(64), ones[0], cloud(128),
            ones[1], cloud(32), ones[2])
    gp = lmn.grid_params(kcfg)
    lm = lmn.empty_local_map(kcfg, 8, 64, 128, 32, torch.float32, gp, dev)
    ids, ok, wslots = lmn.recent_window_ids(store, 8)
    whole = lmn.rebuild_window(lm, store, ids, ok, wslots, gp)
    lm = lmn.rebuild_window(lm, shard_store(store, mesh), ids, ok, wslots,
                            gp)
    assert int(lm.n_surf) > 0 and bool(torch.isfinite(
        lm.surf_vm.cells).all())
    assert all(bool(torch.equal(a, b)) for a, b in zip(
        _leaves(lm), _leaves(whole))), "sharded != unsharded window map"

    report = dict(
        shards=mesh.size, devices=[str(d) for d in mesh.devices],
        ran=["P4 batched per-scan step", "P4 full SLAM replay",
             "P3 edge-sharded sparse pose-graph solve",
             "P3 window map from a keyframe-sharded store"],
        skipped=[], cg_error_m=(err0, err1))
    print(f"dryrun_multichip({n_devices}): ok - {', '.join(report['ran'])} "
          f"on {mesh.size} shards")
    return report


def _leaves(tree):
    """The tensors of a state container, in field order."""
    out = []
    tree_map(out.append, tree)
    return out
