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
nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lins_tpu_torch.config import SlamConfig


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


def put_row(a: torch.Tensor, i: torch.Tensor, row) -> torch.Tensor:
    """a with row `i` (a 0-dim device index) replaced by `row`, with no
    host read of `i`.  A Python number becomes a fill, not a host->device
    copy (which would wait for the stream).  A row shorter than a's rows
    fills their leading entries and keeps the rest, as the reference
    package's `lax.dynamic_update_slice` does: a configuration whose
    feature sets are narrower than the store's caps (`--feature-scale
    0.1`, the dry run's small config) writes such clouds."""
    if isinstance(row, torch.Tensor):
        row = row.to(a.dtype)
        if row.dim() and a.dim() > 1 and row.shape[0] < a.shape[1]:
            row = torch.cat([row, take_row(a, i)[row.shape[0]:]])
    else:
        row = torch.full(a.shape[1:], row, dtype=a.dtype, device=a.device)
    return a.index_copy(0, i.reshape(1).to(torch.int64),
                        row.expand(a.shape[1:])[None])


def take_row(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a 0-dim device index, with no host read of `i`."""
    return torch.index_select(a, 0, i.reshape(1).to(torch.int64))[0]


def add_keyframe(store: KeyframeStore, pos, quat, time,
                 corner, corner_valid, surf, surf_valid,
                 outlier=None, outlier_valid=None) -> KeyframeStore:
    """Append one keyframe at slot `count % K` (ring eviction)."""
    i = torch.remainder(store.count, store.capacity)
    if outlier is None:
        outlier = torch.zeros_like(store.outlier[0])
        outlier_valid = torch.zeros_like(store.outlier_valid[0])
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
