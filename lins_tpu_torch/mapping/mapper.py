"""Mapping backend driver (port of the recent-window path of
`lins_tpu/mapping/mapper.py`; reference C19-C21, the lidar_mapping_node.cpp
main loop without the ROS plumbing).

Per mapped scan (throttled to mapping_process_interval, the reference's
0.3 s gate, lidar_mapping_node.cpp:1821):
  1. warm-start pose = last map correction ∘ new odometry pose
     (transformAssociateToMap, :411-536)
  2. voxel-downsample the scan's corner/surf/outlier clouds and merge
     surf+outlier into the GN query set (downsampleCurrentScan, :1326-1349)
  3. scan-to-map GN against the cached local-map grids (:1635-1652)
  4. roll/pitch blend with the latest IMU attitude, weight 0.998/0.002
     (transformUpdate, :538-577)
  5. keyframe gate at 0.3 m (:1660-1667): store + incremental window map +
     the odometry edge of the pose graph

Branches the host knows stay on the host: which scans are mapped (the
cadence, `plan_chunk`) and whether the map is still empty (the first
mapping step ever).  Branches that depend on device values — the keyframe
gate and the compaction rebuild — are decided on the host as well: it
reads the predicate and issues only the branch taken (utils/tree.cond),
on every device, so the card computes nothing it then throws away.  A
mapping step reads the keyframe gate, the rebuild inside a keyframe add,
and the scan-to-map loop's stop and re-gather (mapping/scan2map.py).

At the 1 Hz loop cadence (`loop_attempts`) a loop-closure attempt follows
the mapping step (`_loop_step_impl`): detection, ICP and polish against the
old pass (graph/loop_closure.py); an accepted edge enters the pose graph,
and when its implied correction is large enough the graph is re-solved
(graph/pose_graph.py), every keyframe pose rewritten and the window map
rebuilt (performLoopClosure + correctPoses, :1114-1186, 1767-1795).  The
attempt's branches, align or skip and solve or not, are read and decided
on the host (an attempt with no candidate makes two reads and issues
neither); the whole-solve guard, inside a kept solve, stays a select on
the device.  Which scans attempt a loop is host cadence.  `final_solve`
re-solves over every edge at the end of a run.

Both local maps are ported: the recent window (`loop_closure_enabled`,
`lc_map_mode="recent"`) and the radius-selected map (loop closure off, the
reference's loopClosureEnableFlag=false mode, or `lc_map_mode="radius"`),
which each mapping step re-selects around the warm-start pose and rebuilds
when the selected set changes (decided on the host as well).
Above 1024 keyframe slots every solve is the sparse one
(`pose_graph.optimize_cg`), as in the reference.  `shard_store_over`
splits the keyframe store's clouds along the keyframe axis over a mesh
(parallel/shard_map_store.py); the steps run unchanged on it.

`_mapping_chunk_impl` is the chunk driver as a function of the state (the
batched replay of parallel/replay.py runs it per stream);
`LinsMapper.process_chunk` is a call of it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3
from lins_tpu_torch.graph import loop_closure as lc
from lins_tpu_torch.graph import pose_graph as pg
from lins_tpu_torch.mapping import keyframes as kf
from lins_tpu_torch.mapping import local_map as lmn
from lins_tpu_torch.mapping.keyframes import take_row
from lins_tpu_torch.mapping.scan2map import scan_to_map_grids
from lins_tpu_torch.ops.voxel import voxel_downsample
from lins_tpu_torch.ops.voxel_map import VoxDelta, VoxelMap
from lins_tpu_torch.parallel.shard_map_store import shard_store
from lins_tpu_torch.utils.device import resolve_device, resolve_dtype
from lins_tpu_torch.utils.metrics import trace_scope
from lins_tpu_torch.utils.tree import cond, tree_where


class MapperState(NamedTuple):
    store: kf.KeyframeStore
    lmap: lmn.LocalMapState
    bef_pos: torch.Tensor   # odometry pose at the last correction
    bef_quat: torch.Tensor
    aft_pos: torch.Tensor   # refined pose at the last correction
    aft_quat: torch.Tensor
    edges: pg.EdgeSet       # pose-graph factors (odometry + loop)
    n_loops: torch.Tensor   # () int32


def derive_caps(cfg: SlamConfig, corner_cap=None, surf_cap=None,
                outlier_cap=None):
    """Per-keyframe cloud capacities scaled from the sensor preset (the
    VLP-16 preset gives 1024/4096/2048)."""
    corner_cap = corner_cap or max(256, cfg.max_less_sharp // 2)
    surf_cap = surf_cap or max(1024, (cfg.max_less_flat * 2) // 3)
    outlier_cap = outlier_cap or max(256, cfg.max_outlier // 2)
    return corner_cap, surf_cap, outlier_cap


def init_mapper(cfg: SlamConfig, corner_cap=1024, surf_cap=4096,
                outlier_cap=2048, n_window=50, grid: lmn.GridParams = None,
                dtype=torch.float32, device=None) -> MapperState:
    z = torch.zeros(3, dtype=dtype, device=device)
    e = so3.quat_identity(dtype, device=device)
    gp = grid or lmn.grid_params(cfg)
    return MapperState(
        store=kf.empty_store(cfg, corner_cap, surf_cap, outlier_cap, dtype,
                             device),
        lmap=lmn.empty_local_map(cfg, n_window, corner_cap, surf_cap,
                                 outlier_cap, dtype, gp, device),
        bef_pos=z, bef_quat=e, aft_pos=z, aft_quat=e,
        edges=pg.empty_edges(cfg.max_keyframes + 128, dtype, device),
        n_loops=torch.zeros((), dtype=torch.int32, device=device))


def warm_start(state: MapperState, odo_pos, odo_quat):
    """T_warm = T_aft ∘ T_bef⁻¹ ∘ T_odo (transformAssociateToMap)."""
    dq = so3.quat_mul(state.aft_quat, so3.quat_inv(state.bef_quat))
    pos = state.aft_pos + so3.quat_rotate(dq, odo_pos - state.bef_pos)
    quat = so3.quat_normalize(so3.quat_mul(dq, odo_quat))
    return pos, quat


def imu_roll_pitch(acc, gravity: float):
    """Host-side roll/pitch from a raw accelerometer sample (the stand-in
    for the reference mapping node's AHRS-orientation IMU queue,
    lidar_mapping_node.cpp:726-735; same math as calculateRPfromGravity)."""
    acc = np.asarray(acc, float)
    sz = np.sign(acc[2]) or 1.0
    pitch = -sz * np.arcsin(np.clip(acc[0] / gravity, -1.0, 1.0))
    roll = sz * np.arcsin(np.clip(acc[1] / gravity, -1.0, 1.0))
    return np.asarray([roll, pitch])


class ScanClouds(NamedTuple):
    """One scan's clouds as the mapping step uses them (body frame)."""
    corner: torch.Tensor      # (corner_cap, 3) voxel-downsampled
    corner_ok: torch.Tensor
    surf: torch.Tensor        # (surf_cap, 3)
    surf_ok: torch.Tensor
    outlier: torch.Tensor     # (outlier_cap, 3)
    outlier_ok: torch.Tensor
    query_corner: torch.Tensor  # GN corner queries (first map_query_corner)
    query_corner_ok: torch.Tensor
    query_surf: torch.Tensor    # GN surf+outlier queries
    query_surf_ok: torch.Tensor
    query_overflow: torch.Tensor  # () bool: a query cap dropped points


def downsample_scan(corner_xyz, corner_valid, surf_xyz, surf_valid,
                    outl_xyz, outl_valid, cfg: SlamConfig, corner_cap: int,
                    surf_cap: int, outlier_cap: int, dtype) -> ScanClouds:
    """Voxel-downsample the scan's clouds at the map leaf sizes; the GN
    surf query set is surf+outlier re-filtered together
    (downsampleCurrentScan, lidar_mapping_node.cpp:1326-1349)."""
    c_ds, c_ok = voxel_downsample(corner_xyz.to(dtype), corner_valid,
                                  cfg.map_corner_leaf, corner_cap)
    s_ds, s_ok = voxel_downsample(surf_xyz.to(dtype), surf_valid,
                                  cfg.map_surf_leaf, surf_cap)
    o_ds, o_ok = voxel_downsample(outl_xyz.to(dtype), outl_valid,
                                  cfg.map_outlier_leaf, outlier_cap)
    st_ds, st_ok = voxel_downsample(
        torch.cat([s_ds, o_ds]), torch.cat([s_ok, o_ok]),
        cfg.map_surf_leaf, surf_cap + outlier_cap)
    # GN query views: voxel_downsample compacts valid entries to the
    # front, so the measured-occupancy caps (cfg.map_query_*) drop nothing
    # in practice; `query_overflow` flags the scan if they do
    qc_cap = min(cfg.map_query_corner or corner_cap, corner_cap)
    qs_cap = min(cfg.map_query_surf or (surf_cap + outlier_cap),
                 surf_cap + outlier_cap)
    return ScanClouds(c_ds, c_ok, s_ds, s_ok, o_ds, o_ok,
                      c_ds[:qc_cap], c_ok[:qc_cap], st_ds[:qs_cap],
                      st_ok[:qs_cap],
                      torch.any(c_ok[qc_cap:]) | torch.any(st_ok[qs_cap:]))


def _radius_map(cfg: SlamConfig) -> bool:
    """Whether the local map is radius-selected: always with loop closure
    off, and in loop-closure mode with lc_map_mode "radius"."""
    return not cfg.loop_closure_enabled or cfg.lc_map_mode == "radius"


def _mapping_step_impl(state: MapperState, odo_pos, odo_quat, time,
                       corner_xyz, corner_valid, surf_xyz, surf_valid,
                       outl_xyz, outl_valid, imu_rp, cfg: SlamConfig,
                       corner_cap: int, surf_cap: int, outlier_cap: int,
                       n_window: int, gp: lmn.GridParams, has_map: bool,
                       scan: int | None = None):
    """One mapping step.  `has_map` (host bool): whether any keyframe was
    stored before, false only on the first step ever.  Returns (new state,
    refined pos, quat, metrics).  Recorded as the span `mapper.step`
    (`n_refresh`, `iters`; `scan`: the scan's index in its chunk)."""
    with trace_scope("mapper.step", scan=scan) as span:
        dtype, dev = state.bef_pos.dtype, state.bef_pos.device
        odo_pos = odo_pos.to(dtype)
        odo_quat = odo_quat.to(dtype)
        t_w, q_w = warm_start(state, odo_pos, odo_quat)
        sc = downsample_scan(corner_xyz, corner_valid, surf_xyz, surf_valid,
                             outl_xyz, outl_valid, cfg, corner_cap, surf_cap,
                             outlier_cap, dtype)
        c_ds, c_ok, s_ds, s_ok, o_ds, o_ok = sc[:6]

        lmap, store = state.lmap, state.store
        radius_map = _radius_map(cfg)
        if radius_map and has_map:
            # the radius window, rebuilt only when the selected keyframe set
            # changes (extractSurroundingKeyFrames else-branch, :1248-1324)
            ids, okm = lmn.select_radius(
                store, t_w, cfg.surrounding_keyframe_search_radius, n_window)
            changed = torch.any(ids != lmap.sel) & (store.count > 0)
            wslots = torch.arange(n_window, dtype=torch.int32, device=dev)
            lmap = cond(changed, lambda: lmn.rebuild_window(
                state.lmap, store, ids, okm, wslots, gp), lmap,
                "mapper.radius_rebuild")
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        if has_map:
            t_m, q_m, iters, n_sel, n_refresh = scan_to_map_grids(
                t_w, q_w, sc.query_corner, sc.query_corner_ok, sc.query_surf,
                sc.query_surf_ok, lmap.corner_grid, lmap.surf_grid,
                lmap.n_corner, lmap.n_surf, cfg)
        else:
            t_m, q_m, iters, n_sel, n_refresh = t_w, q_w, zero, zero, zero

        # transformUpdate: blend roll/pitch with the IMU attitude, yaw
        # untouched
        rpy_m = so3.quat_to_rpy(q_m)
        imu_rp = imu_rp.to(dtype)
        rp = torch.where(torch.all(torch.isfinite(imu_rp)), imu_rp, rpy_m[:2])
        q_m = so3.rpy_to_quat(torch.stack([
            0.998 * rpy_m[0] + 0.002 * rp[0],
            0.998 * rpy_m[1] + 0.002 * rp[1],
            rpy_m[2]]))

        # keyframe gate: 0.3 m from the previous keyframe (always the first)
        last_slot = torch.remainder(torch.clamp(store.count - 1, min=0),
                                    store.capacity)
        dist = torch.linalg.vector_norm(t_m - take_row(store.pos, last_slot))

        def do_add():
            new_id = store.count
            store2 = kf.add_keyframe(store, t_m, q_m, time, c_ds, c_ok,
                                     s_ds, s_ok, o_ds, o_ok)
            lm = lmap
            if not radius_map:
                # recent-window incremental insert (evict-subtract + add); in
                # radius mode the next step's selection takes the new keyframe
                lm = lmn.push_keyframe(lm, new_id, t_m, q_m, c_ds, c_ok, s_ds,
                                       s_ok, o_ds, o_ok, gp)
                # periodic compaction: tombstone leak, cell overflow and float
                # sum drift are bounded by a full rebuild every
                # map_rebuild_interval keyframes
                need = (lm.pushes >= cfg.map_rebuild_interval) | lm.rebuild_due
                ids, okm, wslots = lmn.recent_window_ids(store2, n_window)
                lm = cond(need, lambda: lmn.rebuild_window(
                    lm, store2, ids, okm, wslots, gp), lm,
                    "mapper.window_rebuild")
            edges = state.edges
            if has_map:
                # odometry between-factor prev_kf -> new_kf with absolute ids
                # (saveKeyFramesAndFactor, lidar_mapping_node.cpp:1693-1703)
                t_rel, q_rel = pg.relative_pose(take_row(store.pos, last_slot),
                                                take_row(store.quat, last_slot),
                                                t_m, q_m)
                edges = pg.add_edge(edges, torch.clamp(new_id - 1, min=0),
                                    new_id, t_rel, q_rel,
                                    1.0 / cfg.pg_odom_rot_var,
                                    1.0 / cfg.pg_odom_pos_var)
            return store2, lm, edges

        if has_map:
            add = dist > cfg.keyframe_gate_meters
            store, lmap, edges = cond(add, do_add, (store, lmap, state.edges),
                                      "mapper.keyframe_add")
        else:
            add = torch.ones((), dtype=torch.bool, device=dev)
            store, lmap, edges = do_add()

        new_state = MapperState(store=store, lmap=lmap, bef_pos=odo_pos,
                                bef_quat=odo_quat, aft_pos=t_m, aft_quat=q_m,
                                edges=edges, n_loops=state.n_loops)
        metrics = dict(iters=iters, n_matches=n_sel, n_refresh=n_refresh,
                       keyframe_added=add,
                       warm_dist=torch.linalg.vector_norm(t_m - t_w),
                       query_overflow=sc.query_overflow)
        span.update(n_refresh=n_refresh, iters=iters)
        return new_state, t_m, q_m, metrics


def _solve_and_rewrite(state: MapperState, edges: pg.EdgeSet,
                       cfg: SlamConfig, opt_iters: int, n_window: int,
                       gp: lmn.GridParams):
    """Pose-graph solve over the live edges, every keyframe pose rewritten,
    the window map rebuilt from the corrected poses (the reference leaves
    its deque clouds stale here) and the correction moved to the current
    keyframe.  Returns (new state, whether every live pose is finite)."""
    store = state.store
    K = store.capacity
    live = kf.live_mask(store)
    ev = pg.live_view(edges, store.count, K)
    # gauge prior on the oldest live keyframe (node 0 may be evicted)
    prior_slot = torch.remainder(torch.clamp(store.count - K, min=0), K)
    solve = pg.optimize_cg if K > 1024 else pg.optimize
    pos, quat = solve(store.pos, store.quat, live, ev, opt_iters,
                      prior_slot=prior_slot, huber_delta=cfg.pg_loop_huber)
    store2 = kf.set_poses(store, pos, quat)
    if cfg.lc_map_mode == "radius":
        # the current radius selection at the corrected poses (the next
        # mapping step re-selects around the corrected pose)
        ids = state.lmap.sel
        ok, wslots = ids >= 0, torch.arange(n_window, dtype=torch.int32,
                                            device=ids.device)
    else:
        ids, ok, wslots = lmn.recent_window_ids(store2, n_window)
    lmap = lmn.rebuild_window(state.lmap, store2, ids, ok, wslots, gp)
    cur_slot = torch.remainder(torch.clamp(store.count - 1, min=0), K)
    new = state._replace(store=store2, lmap=lmap, edges=edges,
                         aft_pos=take_row(pos, cur_slot),
                         aft_quat=take_row(quat, cur_slot))
    live2 = live[:, None]
    good = (torch.all(torch.where(live2, torch.isfinite(pos), True))
            & torch.all(torch.where(live2, torch.isfinite(quat), True)))
    return new, good


def _loop_step_impl(state: MapperState, time, cfg: SlamConfig,
                    submap_cap: int, cloud_cap: int, opt_iters: int,
                    n_window: int, gp: lmn.GridParams,
                    scan: int | None = None):
    """One loop-closure attempt and, on accept, the pose-graph re-solve,
    keyframe pose rewrite and window rebuild (performLoopClosure +
    correctPoses, lidar_mapping_node.cpp:1114-1186, 1767-1795).  Returns
    (new state, info dict of device scalars).  Recorded as the span
    `loop.attempt` (`found`, `accepted`, `applied`; `scan`: the scan's
    index in its chunk)."""
    with trace_scope("loop.attempt", scan=scan) as span:
        store = state.store
        cur = torch.clamp(store.count - 1, min=0)          # absolute id
        (idx, found, accepted, t_rel, q_rel, fitness,
         corr_t) = lc.try_close_loop(store, cur, time, cfg, submap_cap,
                                     cloud_cap)
        accepted = accepted & (store.count > 2)

        # every accepted edge enters the graph; the solve and rewrite run only
        # when its implied correction reaches loop_rewrite_min_m (smaller
        # confirmations wait for the next triggered or the final solve)
        w = 1.0 / torch.clamp(fitness * cfg.pg_loop_var_scale, min=1e-6)
        edges_new = pg.add_edge(state.edges, idx, cur, t_rel, q_rel, w, w)
        state1 = state._replace(
            edges=tree_where(accepted, edges_new, state.edges),
            n_loops=state.n_loops + accepted.to(torch.int32))
        solve = accepted & (corr_t >= cfg.loop_rewrite_min_m)

        def apply():
            new, good = _solve_and_rewrite(state1, state1.edges, cfg,
                                           opt_iters, n_window, gp)
            # whole-solve guard: a non-finite live pose discards the whole
            # application, the edge included (the next attempt re-measures it)
            return tree_where(good, new, state), good

        new_state, applied = cond(solve, apply,
                                  (state1, torch.zeros_like(solve)),
                                  "loop.solve")
        info = dict(found=found, accepted=accepted, applied=applied,
                    fitness=fitness, matched=idx, corr_t=corr_t)
        span.update(found=found, accepted=accepted, applied=applied)
        return new_state, info


def _final_solve_impl(state: MapperState, cfg: SlamConfig, opt_iters: int,
                      n_window: int, gp: lmn.GridParams):
    """One solve over every accumulated edge and the rewrite, with no new
    measurement: it takes in the add-only loop edges (the reference's
    correctPoses after its last iSAM2 update, :1767-1795).  Kept only when
    every live pose is finite and the store holds more than 2 keyframes."""
    new, good = _solve_and_rewrite(state, state.edges, cfg, opt_iters,
                                   n_window, gp)
    return tree_where(good & (state.store.count > 2), new, state)


def _mapping_chunk_impl(state: MapperState, rns, qbns, ts, cxyz, cval, sxyz,
                        sval, oxyz, oval, imu_rp, map_flags, loop_flags,
                        cfg: SlamConfig, corner_cap: int, surf_cap: int,
                        outlier_cap: int, n_window: int, gp: lmn.GridParams,
                        submap_cap: int, cloud_cap: int, opt_iters: int,
                        has_map: bool):
    """The mapping cadence over a K-scan chunk of odometry outputs, as a
    function of the state: a mapping step on each scan `map_flags` marks,
    then a loop attempt on each `loop_flags` marks (host bools from
    `plan_chunk`), then every scan's fused pose with the correction current
    at that scan (process -> loop -> fuse, the streaming order).  The host
    reads only the predicates and loop flags that decide the steps' and
    attempts' branches (utils/tree.cond, utils/device.may_stop).

    rns (K,3), qbns (K,4), ts (K,): the odometry's poses and scan times;
    c/s/o xyz, val: the chunk's clouds; imu_rp (K,2).  `has_map`: whether a
    keyframe was stored before the chunk.  Returns (new state, fused pos
    (K,3), quat (K,4), the mapping steps [(i, pos, quat, metrics)], the
    loop attempts [(i, info)], has_map after the chunk)."""
    with trace_scope("mapper.chunk", K=len(map_flags)):
        dt = state.bef_pos.dtype
        pos, quat, steps, loops = [], [], [], []
        for i in range(len(map_flags)):
            rn, qbn = rns[i].to(dt), qbns[i].to(dt)
            if map_flags[i]:
                state, t_m, q_m, metrics = _mapping_step_impl(
                    state, rn, qbn, ts[i].to(dt), cxyz[i], cval[i], sxyz[i],
                    sval[i], oxyz[i], oval[i], imu_rp[i], cfg, corner_cap,
                    surf_cap, outlier_cap, n_window, gp, has_map, scan=i)
                has_map = True
                steps.append((i, t_m, q_m, metrics))
            if loop_flags[i]:
                state, info = _loop_step_impl(state, ts[i].to(dt), cfg,
                                              submap_cap, cloud_cap, opt_iters,
                                              n_window, gp, scan=i)
                loops.append((i, info))
            p, q = warm_start(state, rn, qbn)
            pos.append(p)
            quat.append(q)
        return (state, torch.stack(pos), torch.stack(quat), steps, loops,
                has_map)


def mapper_state_from_numpy(d, device=None, dtype=torch.float32):
    """The reference package's MapperState as the port's tensors.

    `d` is the reference state with numpy leaves (for example
    `jax.tree_util.tree_map(np.asarray, state)`), or the same fields as
    nested dicts: store, lmap (sel, dc, dsf, corner_vm, surf_vm, pushes),
    bef/aft pose, edges, n_loops.  Floating fields become `dtype`, integer
    fields int32, masks bool; the voxel maps keep their static sizes.  A
    state without its local map (lmap None, as checkpoints hold it) gives
    lmap None.
    """
    def get(o, k):
        return o[k] if isinstance(o, dict) else getattr(o, k)

    def tensor(x):
        a = np.array(x)        # a writable copy: JAX hands out read-only views
        if a.dtype == bool:
            return torch.as_tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=device)
        return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)

    def fields(cls, src):
        return cls(**{f: tensor(get(src, f)) for f in cls._fields})

    def vmap_(src):
        return VoxelMap(
            **{f: tensor(get(src, f)) for f in ("cells", "hwm", "vcoord",
                                                "vsum", "vcnt", "n_live",
                                                "overflow")},
            leaf=float(get(src, "leaf")), m=int(get(src, "m")),
            table=int(get(src, "table")), cap=int(get(src, "cap")),
            nb=int(get(src, "nb")))

    lm = get(d, "lmap")
    return MapperState(
        store=fields(kf.KeyframeStore, get(d, "store")),
        lmap=None if lm is None else lmn.LocalMapState(
            sel=tensor(get(lm, "sel")), dc=fields(VoxDelta, get(lm, "dc")),
            dsf=fields(VoxDelta, get(lm, "dsf")),
            corner_vm=vmap_(get(lm, "corner_vm")),
            surf_vm=vmap_(get(lm, "surf_vm")),
            pushes=tensor(get(lm, "pushes"))),
        **{k: tensor(get(d, k)) for k in ("bef_pos", "bef_quat", "aft_pos",
                                          "aft_quat")},
        edges=fields(pg.EdgeSet, get(d, "edges")),
        n_loops=tensor(get(d, "n_loops")))


def _canonical(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _fill_vector(values, dtype, device):
    """A short host vector as a device tensor made of fills: a host->device
    copy would wait for the stream."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


class LinsMapper:
    """Host driver for the mapping backend.

    device / dtype: the card and float32 unless given (the CPU tests pass
    "cpu" and float64).  `map_corner_cap` / `map_surf_cap` size the map
    hash tables, as in the reference; `submap_cap` / `cloud_cap` the loop
    closure's submap and current cloud.
    """

    def __init__(self, cfg: SlamConfig, corner_cap=None, surf_cap=None,
                 outlier_cap=None, n_window=None, map_corner_cap=None,
                 map_surf_cap=None, submap_cap=None, cloud_cap=None,
                 dtype=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.caps = derive_caps(cfg, corner_cap, surf_cap, outlier_cap)
        corner, surf = self.caps[:2]
        # as the reference scales them: VLP-16 and HDL-64 give 16384 / 8192
        self.submap_cap = submap_cap or min(16384, 4 * (corner + surf))
        self.cloud_cap = cloud_cap or min(8192, 2 * (corner + surf))
        self.n_window = n_window or cfg.surrounding_keyframe_search_num
        gp = lmn.grid_params(cfg)
        if map_corner_cap:
            gp = gp._replace(corner_table=max(1024, map_corner_cap // 4))
        if map_surf_cap:
            gp = gp._replace(surf_table=max(2048, map_surf_cap // 4))
        self.gp = gp
        self.state = init_mapper(cfg, *self.caps, self.n_window, gp,
                                 self.dtype, self.device)
        self._has_map = False
        self.last_time = -np.inf
        self.last_loop_time = -np.inf
        self.metrics = []
        self.trajectory = []
        self.loop_info = []
        self._shard_mesh = None

    def shard_store_over(self, mesh, axis: str = "seq"):
        """Split the keyframe store's clouds along the keyframe axis over
        `mesh` (a `parallel.multihost.Mesh` whose first device is the
        mapper's) and keep them there: the store is re-pinned after every
        call that changes the state, as in the reference.  The window,
        loop and checkpoint gathers read across the shards
        (parallel/shard_map_store.py); sharded and unsharded runs give the
        same trajectory."""
        if _canonical(mesh.devices[0]) != _canonical(self.device):
            raise ValueError(f"shard_store_over: the mesh's first device "
                             f"{mesh.devices[0]} is not the mapper's "
                             f"{self.device}")
        self._shard_mesh = (mesh, axis)
        self._repin()

    def _repin(self):
        if self._shard_mesh is None:
            return
        mesh, axis = self._shard_mesh
        self.state = self.state._replace(
            store=shard_store(self.state.store, mesh, axis))

    def warmup(self, cloud_dtype=None, chunk: int | None = None):
        """Kept for API parity with the reference package, whose warmup
        compiles its programs ahead of time; `LinsOdometry.warmup` builds
        every kernel of the port, the selection kernel included."""

    def _step(self, odo_pos, odo_quat, time, corner_xyz, corner_valid,
              surf_xyz, surf_valid, outl_xyz, outl_valid, imu_rp):
        c1, c2, c3 = self.caps
        self.state, t_m, q_m, metrics = _mapping_step_impl(
            self.state, odo_pos, odo_quat, time, corner_xyz, corner_valid,
            surf_xyz, surf_valid, outl_xyz, outl_valid, imu_rp, self.cfg,
            c1, c2, c3, self.n_window, self.gp, self._has_map)
        self._has_map = True
        self.metrics.append(metrics)
        return t_m, q_m

    def process(self, time: float, odo_pos, odo_quat,
                corner_xyz, corner_valid, surf_xyz, surf_valid,
                outl_xyz=None, outl_valid=None, imu_rp=None):
        """Feed one odometry result + its scan clouds (body frame).

        time: host float (cadence gating).  imu_rp: optional (roll, pitch)
        from the raw IMU at scan time (imu_roll_pitch); NaN or None
        disables the blend.  Returns (pos, quat) of the refined pose, or
        None when throttled.
        """
        if time - self.last_time < self.cfg.mapping_process_interval:
            return None
        self.last_time = time
        dt, dev = self.dtype, self.device
        if outl_xyz is None:
            outl_xyz = torch.zeros((self.cfg.max_outlier, 3), dtype=dt,
                                   device=dev)
            outl_valid = torch.zeros(self.cfg.max_outlier, dtype=torch.bool,
                                     device=dev)
        rp = _fill_vector([math.nan] * 2 if imu_rp is None else imu_rp, dt,
                          dev)
        t_m, q_m = self._step(torch.as_tensor(odo_pos, dtype=dt, device=dev),
                              torch.as_tensor(odo_quat, dtype=dt, device=dev),
                              torch.full((), time, dtype=dt, device=dev),
                              corner_xyz, corner_valid, surf_xyz, surf_valid,
                              outl_xyz, outl_valid, rp)
        self.trajectory.append((time, t_m, q_m))
        self._repin()
        return t_m, q_m

    def _loops(self) -> bool:
        return self.cfg.loop_closure_enabled and self.cfg.loop_attempts

    def plan_chunk(self, ts_host):
        """Host-side cadence gating for a chunk of scan times: which scans
        get a mapping step and which a loop attempt.  Advances the same
        bookkeeping as `process` and `maybe_close_loop`, so streaming and
        chunked runs see the same cadences.  Returns (map_flags,
        loop_flags) as host bool arrays."""
        mf = np.zeros(len(ts_host), bool)
        lf = np.zeros(len(ts_host), bool)
        for i, t in enumerate(ts_host):
            t = float(t)
            if t - self.last_time >= self.cfg.mapping_process_interval:
                mf[i] = True
                self.last_time = t
            if self._loops() and t - self.last_loop_time >= 1.0:
                lf[i] = True
                self.last_loop_time = t
        return mf, lf

    def _loop_step(self, time_dev):
        self.state, info = _loop_step_impl(
            self.state, time_dev, self.cfg, self.submap_cap, self.cloud_cap,
            8, self.n_window, self.gp)
        self.loop_info.append(info)
        return info

    def process_chunk(self, ts_host, rns, qbns, clouds, ts_dev, map_flags,
                      loop_flags, imu_rp_dev=None):
        """Mapping and loop closure at their cadences over a K-scan chunk of
        odometry outputs: a mapping step on each scan `map_flags` marks and
        a loop attempt on each `loop_flags` marks (both from plan_chunk),
        then every scan's fused pose with the correction current at that
        scan (process -> loop -> fuse, the streaming order).  The host
        reads only the flags that decide the branches and stops
        (`_mapping_chunk_impl`).  Returns the fused (pos (K,3), quat (K,4))
        blocks.

        ts_dev: (K,) scan times on the device; clouds: the odometry's
        `last_chunk_clouds`; imu_rp_dev: optional (K, 2) roll/pitch.
        """
        K = len(ts_host)
        if imu_rp_dev is None:
            imu_rp_dev = torch.full((K, 2), math.nan, dtype=self.dtype,
                                    device=self.device)
        (self.state, pos, quat, steps, loops,
         self._has_map) = _mapping_chunk_impl(
            self.state, rns, qbns, ts_dev, clouds["cxyz"], clouds["cval"],
            clouds["sxyz"], clouds["sval"], clouds["oxyz"], clouds["oval"],
            imu_rp_dev, map_flags, loop_flags, self.cfg, *self.caps,
            self.n_window, self.gp, self.submap_cap, self.cloud_cap, 8,
            self._has_map)
        for i, t_m, q_m, metrics in steps:
            self.metrics.append(metrics)
            self.trajectory.append((float(ts_host[i]), t_m, q_m))
        self.loop_info.extend(info for _, info in loops)
        self._repin()
        return pos, quat

    def maybe_close_loop(self, time: float):
        """Attempt a loop closure at ~1 Hz (the loopClosureThread cadence,
        lidar_mapping_node.cpp:1033-1041).  Returns the info dict (device
        scalars: found, accepted, applied, fitness, matched, corr_t) or
        None when loop attempts are off or the cadence skips."""
        if not self._loops() or time - self.last_loop_time < 1.0:
            return None
        self.last_loop_time = time
        info = self._loop_step(torch.full((), time, dtype=self.dtype,
                                          device=self.device))
        self._repin()
        return info

    def final_solve(self):
        """Pose-graph solve and rewrite over all accumulated edges
        (_final_solve_impl); call once at the end of a run, before reading
        the keyframe trajectory or the map.  Does nothing with loop closure
        off, where the graph is never solved."""
        if not self.cfg.loop_closure_enabled:
            return
        self.state = _final_solve_impl(self.state, self.cfg, 8,
                                       self.n_window, self.gp)
        self._repin()

    def rebuild_local_map(self):
        """Rebuild the derived local-map caches (voxel maps + eviction
        deltas) from the keyframe store: after `load_state` (checkpoints do
        not hold them) or an external store edit.  A radius-selected map
        defers to the next mapping step's selection: the fresh selection of
        -1s differs from any non-empty one, which forces the rebuild
        there."""
        fresh = lmn.empty_local_map(self.cfg, self.n_window, *self.caps,
                                    self.dtype, self.gp, self.device)
        if not _radius_map(self.cfg):
            ids, ok, wslots = lmn.recent_window_ids(self.state.store,
                                                    self.n_window)
            fresh = lmn.rebuild_window(fresh, self.state.store, ids, ok,
                                       wslots, self.gp)
        self.state = self.state._replace(lmap=fresh)

    def correction(self):
        """Latest (bef, aft) odometry->map correction for pose fusion."""
        return (self.state.bef_pos, self.state.bef_quat,
                self.state.aft_pos, self.state.aft_quat)

    def load_numpy_state(self, d, last_time: float | None = None):
        """Take over a mapper state given with numpy leaves
        (`mapper_state_from_numpy`), e.g. the reference package's or a
        checkpoint's; the cadence restarts at `last_time` when given.  A
        state without its local map gets it rebuilt from the store
        (`rebuild_local_map`)."""
        self.state = mapper_state_from_numpy(d, self.device, self.dtype)
        self._repin()
        if self.state.lmap is None:
            self.rebuild_local_map()
        self._has_map = int(self.state.store.count) > 0
        if last_time is not None:
            self.last_time = last_time
        return self
