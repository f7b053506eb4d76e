"""Keyframe store (port of the main-path part of
`lins_tpu/mapping/keyframes.py`; reference C19, lidar_mapping_node.cpp:
113-131) as a fixed-capacity ring of tensors.

  * `count` is the monotonic number of keyframes ever added; a keyframe's
    absolute id is the value of `count` at its insertion.
  * id `k` lives in slot `k % K` (K = max_keyframes); once count > K the
    oldest keyframe is overwritten, ids in [count-K, count) are live.
  * `kf_id[slot]` records which absolute id occupies a slot (-1 empty).

Per keyframe the store holds the scan's voxel-downsampled corner / surf /
outlier clouds in the body frame (lidar_mapping_node.cpp:1753-1764).
Writes take the slot as a device scalar, so adding a keyframe reads
nothing back to the host.  The cloud fields may be split over a mesh
(`parallel/shard_map_store.py`): every read and write of their rows goes
through `take_rows` / `take_row` / `put_row`, which take plain and sharded
fields alike.  `gather_window` and `assemble_local_map` are the one-shot
window assembly (the oracle of the incremental map in local_map.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3
from lins_tpu_torch.ops.voxel import voxel_downsample
from lins_tpu_torch.parallel.shard_map_store import ShardedRows


class KeyframeStore(NamedTuple):
    pos: torch.Tensor          # (K, 3) keyframe positions (world)
    quat: torch.Tensor         # (K, 4) wxyz
    time: torch.Tensor         # (K,)
    kf_id: torch.Tensor        # (K,) int32 absolute id in this slot, -1 empty
    corner: torch.Tensor       # (K, Cc, 3) body-frame corner cloud
    corner_valid: torch.Tensor  # (K, Cc)
    surf: torch.Tensor         # (K, Cs, 3) body-frame surf cloud
    surf_valid: torch.Tensor   # (K, Cs)
    outlier: torch.Tensor      # (K, Co, 3) body-frame outlier cloud
    outlier_valid: torch.Tensor  # (K, Co)
    count: torch.Tensor        # () int32, monotonic

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def empty_store(cfg: SlamConfig, corner_cap: int = 1024, surf_cap: int = 4096,
                outlier_cap: int = 2048, dtype=torch.float32,
                device=None) -> KeyframeStore:
    K = cfg.max_keyframes

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    quat = torch.cat([torch.ones((K, 1), dtype=dtype, device=device),
                      z(K, 3)], dim=1)
    return KeyframeStore(
        pos=z(K, 3), quat=quat, time=z(K),
        kf_id=torch.full((K,), -1, dtype=torch.int32, device=device),
        corner=z(K, corner_cap, 3), corner_valid=z(K, corner_cap,
                                                   dt=torch.bool),
        surf=z(K, surf_cap, 3), surf_valid=z(K, surf_cap, dt=torch.bool),
        outlier=z(K, outlier_cap, 3),
        outlier_valid=z(K, outlier_cap, dt=torch.bool),
        count=z(dt=torch.int32))


def _fill_row(a: torch.Tensor, i: torch.Tensor, row) -> torch.Tensor:
    """`row` as a whole row of `a` on a's device: a Python number becomes a
    fill, a row shorter than a's rows keeps the rest of a's row `i`."""
    if isinstance(row, torch.Tensor):
        row = row.to(a.device, a.dtype)
        if row.dim() and a.dim() > 1 and row.shape[0] < a.shape[1]:
            row = torch.cat([row, take_row(a, i)[row.shape[0]:]])
        return row.expand(a.shape[1:])
    return torch.full(a.shape[1:], row, dtype=a.dtype, device=a.device)


def put_row(a, i: torch.Tensor, row):
    """a with row `i` (a 0-dim device index) replaced by `row`, with no
    host read of `i`.  A Python number becomes a fill, not a host->device
    copy (which would wait for the stream).  A row shorter than a's rows
    fills their leading entries and keeps the rest, as the reference
    package's `lax.dynamic_update_slice` does: a configuration whose
    feature sets are narrower than the store's caps (`--feature-scale
    0.1`, the dry run's small config) writes such clouds.  A sharded field
    is copied once a shard: the new row where the shard owns slot `i`, its
    own current row elsewhere."""
    i = i.reshape(1).to(torch.int64)
    if not isinstance(a, ShardedRows):
        return a.index_copy(0, i, _fill_row(a, i, row)[None])
    owner, local = a.locate(i)
    parts = []
    for s, p in a.local():
        li = local.to(p.device)
        cur = take_row(p, li)
        own = (owner == s).reshape(()).to(p.device)
        new = torch.where(own, _fill_row(p, li, row), cur)
        parts.append(p.index_copy(0, li, new[None]))
    return ShardedRows(parts, a.mesh)


def take_rows(a, slots: torch.Tensor) -> torch.Tensor:
    """a[slots] for a 1-D device tensor of slots, with no host read: a plain
    field's rows, or a sharded field's rows combined on the mesh's first
    device (a select on the owner; across processes one `all_reduce` of the
    owner-masked rows)."""
    slots = slots.to(torch.int64)
    if not isinstance(a, ShardedRows):
        return torch.index_select(a, 0, slots)
    dev0, group = a.mesh.devices[0], a.mesh.group
    owner, local = a.locate(slots.to(dev0))
    owner = owner.reshape(owner.shape + (1,) * (len(a.shape) - 1))
    out = None
    for s, p in a.local():
        rows = torch.index_select(p, 0, local.to(p.device)).to(dev0)
        own = owner == s
        if out is None:
            # in one process every slot has a local owner, so the first
            # shard's rows are only placeholders for the others' selects
            out = rows if group is None else torch.where(
                own, rows, torch.zeros_like(rows))
        else:
            out = torch.where(own, rows, out)
    if group is not None:
        wire = out.to(torch.uint8) if out.dtype == torch.bool else out
        dist.all_reduce(wire, group=group)
        out = wire.to(out.dtype)
    return out


def take_row(a, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a 0-dim device index, with no host read of `i`."""
    return take_rows(a, i.reshape(1))[0]


def add_keyframe(store: KeyframeStore, pos, quat, time,
                 corner, corner_valid, surf, surf_valid,
                 outlier=None, outlier_valid=None) -> KeyframeStore:
    """Append one keyframe at slot `count % K` (ring eviction)."""
    i = torch.remainder(store.count, store.capacity)
    if outlier is None:
        dev = store.count.device
        outlier = torch.zeros(store.outlier.shape[1:],
                              dtype=store.outlier.dtype, device=dev)
        outlier_valid = torch.zeros(store.outlier_valid.shape[1:],
                                    dtype=torch.bool, device=dev)
    return store._replace(
        pos=put_row(store.pos, i, pos), quat=put_row(store.quat, i, quat),
        time=put_row(store.time, i, time),
        kf_id=put_row(store.kf_id, i, store.count),
        corner=put_row(store.corner, i, corner),
        corner_valid=put_row(store.corner_valid, i, corner_valid),
        surf=put_row(store.surf, i, surf),
        surf_valid=put_row(store.surf_valid, i, surf_valid),
        outlier=put_row(store.outlier, i, outlier),
        outlier_valid=put_row(store.outlier_valid, i, outlier_valid),
        count=store.count + 1)


def set_poses(store: KeyframeStore, pos, quat) -> KeyframeStore:
    """Overwrite all keyframe poses (after a pose-graph correction,
    correctPoses, lidar_mapping_node.cpp:1767-1795)."""
    return store._replace(pos=pos.to(store.pos.dtype),
                          quat=quat.to(store.quat.dtype))


def live_mask(store: KeyframeStore) -> torch.Tensor:
    """(K,) bool: slots holding a live (non-evicted) keyframe."""
    return store.kf_id >= 0


def slot_of(store: KeyframeStore, kf_id) -> torch.Tensor:
    return torch.remainder(kf_id, store.capacity).to(torch.int32)


def gather_window(store: KeyframeStore, center: torch.Tensor,
                  n_window: int):
    """Ring slots of the `n_window` keyframe ids ending at id `center`
    (inclusive): the recent-keyframe local map of the reference's
    loop-closure mode (lidar_mapping_node.cpp:1205-1235).  Returns (slots,
    ok, ids); ok masks ids before 0 or already evicted."""
    K = store.capacity
    ids = (center - (n_window - 1)
           + torch.arange(n_window, dtype=torch.int32,
                          device=store.count.device))
    oldest = torch.clamp(store.count - K, min=0)
    ok = (ids >= 0) & (ids >= oldest) & (ids <= center) & (ids < store.count)
    slots = torch.remainder(torch.clamp(ids, min=0), K).to(torch.int32)
    return slots, ok, ids


def assemble_local_map(store: KeyframeStore, center, n_window: int = 50,
                       corner_cap: int = 32768, surf_cap: int = 65536,
                       corner_leaf: float = 0.2, surf_leaf: float = 0.4,
                       with_outlier: bool = False):
    """Local map around keyframe id `center`: each window keyframe's clouds
    in the world, concatenated and voxel-filtered (extractSurroundingKey
    Frames + downsample, :1201-1324).  The mapper keeps this map
    incrementally (mapping/local_map.py); this one-shot assembly is the
    oracle (tests, the sharded store's gathers).  Returns (corner_map,
    corner_ok, surf_map, surf_ok)."""
    slots, ok, _ = gather_window(store, center, n_window)
    p = take_rows(store.pos, slots)[:, None, :]
    q = take_rows(store.quat, slots)[:, None, :]
    keep = ok[:, None]

    def to_world(cloud, valid):
        return (so3.quat_rotate(q, take_rows(cloud, slots)) + p,
                take_rows(valid, slots) & keep)

    cw, cv = to_world(store.corner, store.corner_valid)
    sw, sv = to_world(store.surf, store.surf_valid)
    sw, sv = sw.reshape(-1, 3), sv.reshape(-1)
    if with_outlier:
        # the reference merges the outlier channel into the surf map in both
        # local-map modes (lidar_mapping_node.cpp:1220, 1238, 1306-1313)
        ow, ov = to_world(store.outlier, store.outlier_valid)
        sw = torch.cat([sw, ow.reshape(-1, 3)])
        sv = torch.cat([sv, ov.reshape(-1)])
    corner_map, corner_ok = voxel_downsample(
        cw.reshape(-1, 3), cv.reshape(-1), corner_leaf, corner_cap)
    surf_map, surf_ok = voxel_downsample(sw, sv, surf_leaf, surf_cap)
    return corner_map, corner_ok, surf_map, surf_ok
