"""Incremental local-map maintenance (port of
`lins_tpu/mapping/local_map.py`; reference C19, extractSurroundingKeyFrames,
lidar_mapping_node.cpp:1201-1324).

The reference re-concatenates and re-voxel-filters its 50-keyframe window
every mapping step.  Here the map is incremental (ops/voxel_map.py): a
keyframe insert voxelizes only its own world-frame points and adds them,
the ring slot it evicts is subtracted from its stored `VoxDelta`, and a
full compaction rebuild runs every `map_rebuild_interval` keyframes or on
cell overflow.  Two window modes, as in the reference:
  * recent window (loop-closure mode, :1205-1235): the last W keyframes,
    ring row = keyframe id mod W;
  * radius (loop closure off, or `lc_map_mode="radius"`, :1248-1324): the
    W nearest live keyframes within surrounding_keyframe_search_radius of
    the current pose (`select_radius`), rebuilt whenever the selected id
    set changes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3
from lins_tpu_torch.mapping import keyframes as kf
from lins_tpu_torch.mapping.keyframes import put_row, take_row, take_rows
from lins_tpu_torch.ops.grid_nn import HashGrid
from lins_tpu_torch.ops.voxel_map import (VoxDelta, VoxelMap, apply_delta,
                                          build_voxel_map, empty_voxel_map,
                                          scan_delta)
from lins_tpu_torch.utils.tree import tree_map


class GridParams(NamedTuple):
    """Static geometry of the two map hash grids, derived from the config
    (the reference's rules, explained in its local_map.py): cap = m^3
    rounded up to a multiple of 8, so a cell holds every voxel centroid it
    can contain; supercells (nb=8, cell = leaf*m >= 2.3 m) where m^3 fits,
    else the 27-cell block with cell >= 1.15 m."""

    corner_leaf: float
    corner_m: int
    corner_table: int
    corner_cap: int
    corner_nb: int
    surf_leaf: float
    surf_m: int
    surf_table: int
    surf_cap: int
    surf_nb: int


def _derive_grid(leaf: float):
    m8 = max(1, math.ceil(round(2.3 / leaf, 6)))
    if m8 ** 3 <= 224:
        return m8, max(8, ((m8 ** 3 + 7) // 8) * 8), 8
    m27 = max(1, math.ceil(round(1.15 / leaf, 6)))
    return m27, max(8, ((m27 ** 3 + 7) // 8) * 8), 27


def grid_params(cfg: SlamConfig) -> GridParams:
    m_c, cap_c, nb_c = _derive_grid(cfg.map_corner_leaf)
    m_s, cap_s, nb_s = _derive_grid(cfg.map_surf_leaf)
    return GridParams(
        corner_leaf=cfg.map_corner_leaf, corner_m=m_c,
        corner_table=max(2048, cfg.max_map_corner // 4), corner_cap=cap_c,
        corner_nb=nb_c,
        surf_leaf=cfg.map_surf_leaf, surf_m=m_s,
        surf_table=max(4096, cfg.max_map_surf // 4), surf_cap=cap_s,
        surf_nb=nb_s)


class LocalMapState(NamedTuple):
    sel: torch.Tensor       # (W,) int32 keyframe ids in the window, -1 empty
    dc: VoxDelta            # (W, Cc) per-slot corner deltas (world frame)
    dsf: VoxDelta           # (W, Cs+Co) per-slot surf+outlier deltas
    corner_vm: VoxelMap
    surf_vm: VoxelMap
    pushes: torch.Tensor    # () int32: inserts since the last full rebuild

    @property
    def corner_grid(self) -> HashGrid:
        return self.corner_vm.as_grid()

    @property
    def surf_grid(self) -> HashGrid:
        return self.surf_vm.as_grid()

    @property
    def n_corner(self) -> torch.Tensor:
        return self.corner_vm.n_live

    @property
    def n_surf(self) -> torch.Tensor:
        return self.surf_vm.n_live

    @property
    def rebuild_due(self) -> torch.Tensor:
        """True when an allocation overflowed a cell since the last
        build (the mapper then rebuilds)."""
        return self.corner_vm.overflow | self.surf_vm.overflow


def _empty_delta(W: int, n: int, dtype, device) -> VoxDelta:
    def z(*shape, dt=torch.int32):
        return torch.zeros((W,) + shape, dtype=dt, device=device)

    return VoxDelta(bucket=z(n), vox=z(n, 3), psum=z(n, 3, dt=dtype),
                    cnt=z(n), ok=z(n, dt=torch.bool))


def empty_local_map(cfg: SlamConfig, n_window: int, corner_cap: int,
                    surf_cap: int, outlier_cap: int, dtype=torch.float32,
                    gp: GridParams = None, device=None) -> LocalMapState:
    gp = gp or grid_params(cfg)
    W = n_window
    return LocalMapState(
        sel=torch.full((W,), -1, dtype=torch.int32, device=device),
        dc=_empty_delta(W, corner_cap, dtype, device),
        dsf=_empty_delta(W, surf_cap + outlier_cap, dtype, device),
        corner_vm=empty_voxel_map(gp.corner_leaf, gp.corner_m,
                                  gp.corner_table, gp.corner_cap,
                                  gp.corner_nb, dtype, device),
        surf_vm=empty_voxel_map(gp.surf_leaf, gp.surf_m, gp.surf_table,
                                gp.surf_cap, gp.surf_nb, dtype, device),
        pushes=torch.zeros((), dtype=torch.int32, device=device))


def _to_world(cloud, valid, p, q, keep=True):
    """Body-frame clouds (..., N, 3) at poses p (..., 3), q (..., 4)."""
    return (so3.quat_rotate(q[..., None, :], cloud) + p[..., None, :],
            valid & keep)


def push_keyframe(lm: LocalMapState, kf_id, pos, quat,
                  corner, cval, surf, sval, outl, oval,
                  gp: GridParams) -> LocalMapState:
    """Insert one keyframe's clouds incrementally: the ring row kf_id % W
    evicts the keyframe leaving the window (the deque push/pop of
    lidar_mapping_node.cpp:1226-1235), whose stored delta is subtracted,
    and the new keyframe's delta is added."""
    W = lm.sel.shape[0]
    slot = torch.remainder(kf_id, W)
    dtype = lm.corner_vm.cells.dtype
    cw, cv = _to_world(corner.to(dtype), cval, pos, quat)
    sw, sv = _to_world(surf.to(dtype), sval, pos, quat)
    ow, ov = _to_world(outl.to(dtype), oval, pos, quat)
    dc_new = scan_delta(cw, cv, gp.corner_leaf, gp.corner_m, gp.corner_table)
    ds_new = scan_delta(torch.cat([sw, ow]), torch.cat([sv, ov]),
                        gp.surf_leaf, gp.surf_m, gp.surf_table)

    evict = take_row(lm.sel, slot) >= 0

    def row(d):
        return tree_map(lambda a: take_row(a, slot), d)

    cvm = apply_delta(lm.corner_vm, row(lm.dc), -1, enable=evict)
    svm = apply_delta(lm.surf_vm, row(lm.dsf), -1, enable=evict)
    cvm = apply_delta(cvm, dc_new, +1)
    svm = apply_delta(svm, ds_new, +1)

    def put(d, new):
        return tree_map(lambda a, b: put_row(a, slot, b), d, new)

    return lm._replace(sel=put_row(lm.sel, slot, kf_id),
                       dc=put(lm.dc, dc_new), dsf=put(lm.dsf, ds_new),
                       corner_vm=cvm, surf_vm=svm, pushes=lm.pushes + 1)


def rebuild_window(lm: LocalMapState, store: kf.KeyframeStore,
                   ids, ok, window_slots, gp: GridParams) -> LocalMapState:
    """Full compaction rebuild: re-transform a window selection from the
    body-frame store, voxel-filter the union into fresh VoxelMaps (one sort
    per channel) and recompute every slot's eviction delta.  ids (W,)
    absolute keyframe ids, ok (W,) live mask, window_slots (W,) the ring row
    of each id (id % W)."""
    dtype = lm.corner_vm.cells.dtype
    kslots = kf.slot_of(store, torch.clamp(ids, min=0)).to(torch.int64)
    p, q = store.pos[kslots], store.quat[kslots]
    keep = ok[:, None]

    def world(cloud, valid):
        # the clouds may be sharded over a mesh: read through take_rows
        return _to_world(take_rows(cloud, kslots), take_rows(valid, kslots),
                         p, q, keep)

    cw, cv = world(store.corner, store.corner_valid)
    sw, sv = world(store.surf, store.surf_valid)
    ow, ov = world(store.outlier, store.outlier_valid)
    cw = cw.to(dtype)
    s_all = torch.cat([sw, ow], dim=1).to(dtype)
    v_all = torch.cat([sv, ov], dim=1)

    dc = scan_delta(cw, cv, gp.corner_leaf, gp.corner_m, gp.corner_table)
    dsf = scan_delta(s_all, v_all, gp.surf_leaf, gp.surf_m, gp.surf_table)
    cvm = build_voxel_map(cw.reshape(-1, 3), cv.reshape(-1), gp.corner_leaf,
                          gp.corner_m, gp.corner_table, gp.corner_cap,
                          gp.corner_nb)
    svm = build_voxel_map(s_all.reshape(-1, 3), v_all.reshape(-1),
                          gp.surf_leaf, gp.surf_m, gp.surf_table,
                          gp.surf_cap, gp.surf_nb)
    ws = window_slots.to(torch.int64)

    def put(d, new):
        return tree_map(lambda a, b: a.index_copy(0, ws, b), d, new)

    return lm._replace(
        sel=lm.sel.index_copy(0, ws, torch.where(ok, ids, -1).to(
            torch.int32)),
        dc=put(lm.dc, dc), dsf=put(lm.dsf, dsf), corner_vm=cvm,
        surf_vm=svm, pushes=torch.zeros_like(lm.pushes))


def recent_window_ids(store: kf.KeyframeStore, n_window: int):
    """(ids, ok, window_slots) of the last n_window keyframes, rows keyed
    id % W (recent-window mode)."""
    ids = (store.count - n_window
           + torch.arange(n_window, dtype=torch.int32,
                          device=store.count.device))
    oldest = torch.clamp(store.count - store.capacity, min=0)
    ok = (ids >= 0) & (ids >= oldest) & (ids < store.count)
    return ids, ok, torch.remainder(ids, n_window).to(torch.int32)


def select_radius(store: kf.KeyframeStore, cur_pos, radius: float,
                  n_window: int):
    """The (up to) n_window nearest live keyframes within `radius` of the
    current position (radius mode, lidar_mapping_node.cpp:1248-1260),
    sorted by id so that two selections compare elementwise.

    Equal distances keep the lower slot, as `lax.top_k` does in the
    reference (every dead slot is at infinity, and keyframes can be
    equidistant): a stable sort on the distance, whose order among equal
    keys is the slot order.  Returns (ids (W,) with -1 for empty, ok (W,)).
    """
    diff = store.pos - cur_pos[None, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=1))
    d = torch.where(kf.live_mask(store), d, torch.full_like(d, math.inf))
    d_sorted, slots = torch.sort(d, stable=True)
    d_sorted, slots = d_sorted[:n_window], slots[:n_window]
    ok = d_sorted < radius
    ids = torch.where(ok, store.kf_id[slots], -1)
    pad = n_window - ids.shape[0]
    if pad > 0:
        ids = torch.cat([ids, ids.new_full((pad,), -1)])
    ids = torch.sort(ids).values
    return ids, ids >= 0
