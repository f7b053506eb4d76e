"""Incremental voxel-hash map: per-keyframe delta insert/evict over the
local-map NN grids (port of `lins_tpu/ops/voxel_map.py`).

Each grid cell slot holds a voxel's running (sum, count) over all window
points inside it:
  * insert keyframe = voxelize only its own world-frame points (one small
    sort) into a `VoxDelta`, find-or-allocate each voxel's slot and add its
    (sum, count);
  * evict keyframe  = subtract its stored `VoxDelta`; a voxel whose count
    reaches zero becomes a tombstone parked at SENTINEL, its identity kept
    so a revisit revives it in place;
  * centroid        = sum / count.
A full compaction rebuild (`build_voxel_map`) bounds tombstone leak, cell
overflow and the drift of the running sums, which are added and
subtracted in the working dtype.  The run sums of a scan's delta and of a
build are float64 prefix sums (`voxel.run_sums`), a recorded departure
from the reference, whose sums are in the points' dtype.  Voxel identity
is the exact integer voxel coordinate triple, in the sorts and in the
per-slot identity store.

The reference's multi-key `lax.sort` is stable, so the stable sorts here
give the same row order; scatters with `mode="drop"` write into a buffer
one row longer than the table, whose last row takes the dropped updates.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from lins_tpu_torch.frontend.projection import div_const
from lins_tpu_torch.ops.grid_nn import HashGrid, _bucket_of
from lins_tpu_torch.ops.voxel import (IMAX, IMIN, lex_order, pair_key,
                                      reverse_cummin, run_sums)

# far-away parking spot for dead/never-used slots: distances to it are
# ~1e18 (finite in float32), above the 1e17 tombstone cutoff of the NN
SENTINEL = 1.0e9
# identity of a never-used slot (no physical voxel coordinate)
VFREE = IMIN


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    cells: torch.Tensor   # (table, 3, cap) centroids; dead slots = SENTINEL
    hwm: torch.Tensor     # (table,) int32 per-bucket high-water mark
    vcoord: torch.Tensor  # (table, 3, cap) int32 voxel coords, VFREE unused
    vsum: torch.Tensor    # (table, 3, cap) running point sums
    vcnt: torch.Tensor    # (table, cap) int32 running point counts (0=dead)
    n_live: torch.Tensor  # () int32 live-voxel count
    overflow: torch.Tensor  # () bool: some allocation dropped since build
    leaf: float
    m: int
    table: int
    cap: int
    nb: int = 27

    def as_grid(self) -> HashGrid:
        """HashGrid view for gather_candidates: `cnt` is the high-water
        mark (slots below it are live voxels or SENTINEL tombstones, which
        lose every distance comparison)."""
        return HashGrid(cells=self.cells, cnt=self.hwm,
                        cell=float(self.leaf * self.m), table=self.table,
                        cap=self.cap, nb=self.nb)


class VoxDelta(NamedTuple):
    """One scan's voxelized contribution, sorted by (bucket, lid): run-start
    rows (`ok`) carry the per-voxel point sum and count.  Leading batch
    axes are allowed (the window's per-slot deltas are (W, N))."""
    bucket: torch.Tensor  # (N,) int32 cell bucket (table = invalid)
    vox: torch.Tensor     # (N, 3) int32 exact voxel coords
    psum: torch.Tensor    # (N, 3) point-coordinate sum over the voxel run
    cnt: torch.Tensor     # (N,) int32 points in the voxel run
    ok: torch.Tensor      # (N,) bool: valid voxel-run start


def empty_voxel_map(leaf: float, m: int, table: int, cap: int,
                    nb: int = 27, dtype=torch.float32,
                    device=None) -> VoxelMap:
    return VoxelMap(
        cells=torch.full((table, 3, cap), SENTINEL, dtype=dtype,
                         device=device),
        hwm=torch.zeros(table, dtype=torch.int32, device=device),
        vcoord=torch.full((table, 3, cap), VFREE, dtype=torch.int32,
                          device=device),
        vsum=torch.zeros((table, 3, cap), dtype=dtype, device=device),
        vcnt=torch.zeros((table, cap), dtype=torch.int32, device=device),
        n_live=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        leaf=float(leaf), m=int(m), table=int(table), cap=int(cap),
        nb=int(nb))


def _set_dropping(base: torch.Tensor, index, value) -> torch.Tensor:
    """`base.at[index].set(value, mode="drop")` where a first index equal
    to base.shape[0] drops the update: written into a copy one row longer,
    whose last row is cut off."""
    buf = torch.cat([base, base[:1]])
    buf[index] = value
    return buf[:-1]


def _runs(pts, valid, leaf, m, table):
    """Shared voxelization front half, over (..., N, 3): bucket/lid
    composite key and exact voxel coordinates, stably sorted along N.
    Returns (key_s, vox_s (..., N, 3), sentinel, run starts, run point
    sums (..., N, 3), run point counts, run centroids (..., N, 3)), the
    last three read at run starts.  The sums are differences of float64
    prefix sums (`voxel.run_sums`; a recorded departure, the reference
    takes them in the points' dtype), rounded once to the points' dtype,
    as are the centroids."""
    N = pts.shape[-2]
    dev = pts.device
    m3 = m * m * m
    vox = torch.floor(div_const(pts, leaf)).to(torch.int32)
    cellv = torch.div(vox, m, rounding_mode="floor")
    bucket = _bucket_of(cellv, table)
    lv = vox - cellv * m
    lid = (lv[..., 0] * m + lv[..., 1]) * m + lv[..., 2]
    sentinel = table * m3
    key = torch.where(valid, bucket * m3 + lid, sentinel).to(torch.int32)
    wv = torch.where(valid[..., None], vox, IMAX)
    order = lex_order([pair_key(key, wv[..., 0]),
                       pair_key(wv[..., 1], wv[..., 2])])
    key_s = torch.gather(key, -1, order)
    o3 = order[..., None].expand(order.shape + (3,))
    vox_s = torch.gather(wv, -2, o3)
    pts_s = torch.gather(pts, -2, o3)

    vmask = key_s < sentinel
    lead = key_s.shape[:-1]
    true1 = torch.ones(lead + (1,), dtype=torch.bool, device=dev)
    vstart = torch.cat([true1, (key_s[..., 1:] != key_s[..., :-1])
                        | torch.any(vox_s[..., 1:, :] != vox_s[..., :-1, :],
                                    dim=-1)], dim=-1) & vmask
    nxt = torch.cat([vstart[..., 1:], true1], dim=-1)
    ar = torch.arange(N, device=dev).expand(lead + (N,))
    next_pos = reverse_cummin(torch.where(nxt, ar + 1, N), -1)

    sums, cnt, cent = run_sums(pts_s, vmask, next_pos)
    sums = sums.to(pts.dtype, memory_format=torch.contiguous_format)
    return key_s, vox_s, sentinel, vstart, sums, cnt, cent


def scan_delta(pts: torch.Tensor, valid: torch.Tensor, leaf: float, m: int,
               table: int) -> VoxDelta:
    """Voxelize a masked (..., N, 3) world-frame cloud into per-voxel (sum,
    cnt) runs: one sort of N rows per leading index."""
    key_s, vox_s, _, vstart, sums, cnt, _ = _runs(pts, valid, leaf, m,
                                                  table)
    return VoxDelta(
        bucket=torch.div(key_s, m * m * m, rounding_mode="floor"),
        vox=vox_s, psum=sums, cnt=cnt, ok=vstart)


def _rank_in_bucket_run(bucket, flags):
    """Rank of each flagged row among the flagged rows of its bucket's run
    (rows sorted by bucket)."""
    dev = bucket.device
    bstart = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        bucket[1:] != bucket[:-1]])
    f = flags.to(torch.int64)
    ex = torch.cumsum(f, 0) - f
    base = torch.cummax(torch.where(bstart, ex, -1), 0).values
    return ex - base


def apply_delta(vm: VoxelMap, d: VoxDelta, sign: int,
                enable=True) -> VoxelMap:
    """Scatter one scan's VoxDelta into the map.

    sign=+1 inserts (find-or-allocate each voxel's slot, add sums/counts,
    revive tombstones in place); sign=-1 evicts (find, subtract; a count
    reaching zero tombstones the slot).  `enable` (bool or 0-dim bool
    tensor) masks the whole application.
    """
    assert sign in (+1, -1)
    cap, table = vm.cap, vm.table
    ok = d.ok & enable

    bkt = torch.clamp(d.bucket, max=table - 1).to(torch.int64)
    rows = vm.vcoord[bkt]                                   # (N, 3, cap)
    match = torch.all(rows == d.vox[:, :, None], dim=1) & ok[:, None]
    found = torch.any(match, dim=1)
    slot_m = torch.argmax(match.to(torch.uint8), dim=1)     # first match

    if sign > 0:
        # allocate fresh slots above the bucket's high-water mark; delta rows
        # are bucket-sorted, so rank new voxels within each bucket's run
        is_new = ok & ~found
        slot_a = vm.hwm[bkt].to(torch.int64) + _rank_in_bucket_run(
            d.bucket, is_new)
        alloc = is_new & (slot_a < cap)
        overflow = vm.overflow | torch.any(is_new & (slot_a >= cap))
    else:
        # an entry absent from the map (cap-dropped at insert) is skipped
        slot_a = torch.zeros_like(slot_m)
        alloc = torch.zeros_like(found)
        overflow = vm.overflow

    use = found | alloc
    slot = torch.where(use, torch.where(found, slot_m, slot_a), 0)
    b_sc = torch.where(use, bkt, table)

    old_cnt = torch.where(found, vm.vcnt[bkt, slot_m], 0)
    old_sum = torch.where(found[:, None], vm.vsum[bkt, :, slot_m], 0.0)
    new_cnt = old_cnt + sign * d.cnt
    new_sum = old_sum + sign * d.psum
    live = new_cnt > 0
    cent = torch.where(
        live[:, None],
        new_sum / torch.clamp(new_cnt, min=1)[:, None].to(new_sum.dtype),
        SENTINEL)

    vcnt = _set_dropping(vm.vcnt, (b_sc, slot),
                         torch.clamp(new_cnt, min=0).to(torch.int32))
    vsum = _set_dropping(vm.vsum, (b_sc, slice(None), slot), new_sum)
    cells = _set_dropping(vm.cells, (b_sc, slice(None), slot), cent)
    b_al = torch.where(alloc, bkt, table)
    vcoord = _set_dropping(vm.vcoord, (b_al, slice(None), slot), d.vox)
    hwm = torch.cat([vm.hwm, vm.hwm[:1]])
    hwm = hwm.index_add(0, b_al, torch.ones_like(b_al, dtype=torch.int32))
    hwm = hwm[:-1]

    born = torch.sum(alloc.to(torch.int32))
    revived = torch.sum((found & (old_cnt <= 0) & live).to(torch.int32))
    died = torch.sum((found & (old_cnt > 0) & ~live).to(torch.int32))
    return dataclasses.replace(
        vm, cells=cells, hwm=hwm, vcoord=vcoord, vsum=vsum, vcnt=vcnt,
        n_live=(vm.n_live + born + revived - died).to(torch.int32),
        overflow=overflow)


def build_voxel_map(pts: torch.Tensor, valid: torch.Tensor, leaf: float,
                    m: int, table: int, cap: int, nb: int = 27) -> VoxelMap:
    """Full compaction build: voxel-filter a masked (R, 3) point union and
    fill every VoxelMap field from one sort (slots = rank of the voxel run
    within its cell bucket's run)."""
    dtype, dev = pts.dtype, pts.device
    key_s, vox_s, sentinel, vstart, sums, cnt_run, cents = _runs(
        pts, valid, leaf, m, table)
    bkt_s = torch.div(key_s, m * m * m, rounding_mode="floor")
    slot = _rank_in_bucket_run(bkt_s, vstart)
    keep = vstart & (slot < cap)
    overflow = torch.any(vstart & (slot >= cap))
    b_sc = torch.where(keep, torch.clamp(bkt_s, max=table - 1).to(
        torch.int64), table)
    slot = torch.where(keep, slot, 0)

    cells = _set_dropping(
        torch.full((table, 3, cap), SENTINEL, dtype=dtype, device=dev),
        (b_sc, slice(None), slot), cents)
    vsum = _set_dropping(torch.zeros((table, 3, cap), dtype=dtype,
                                     device=dev),
                         (b_sc, slice(None), slot), sums)
    vcoord = _set_dropping(
        torch.full((table, 3, cap), VFREE, dtype=torch.int32, device=dev),
        (b_sc, slice(None), slot), vox_s)
    vcnt = _set_dropping(torch.zeros((table, cap), dtype=torch.int32,
                                     device=dev), (b_sc, slot), cnt_run)
    hwm = torch.zeros(table + 1, dtype=torch.int32, device=dev).index_add(
        0, b_sc, torch.ones_like(b_sc, dtype=torch.int32))[:-1]
    return VoxelMap(cells=cells, hwm=hwm, vcoord=vcoord, vsum=vsum,
                    vcnt=vcnt,
                    n_live=torch.sum(keep.to(torch.int32)).to(torch.int32),
                    overflow=overflow,
                    leaf=float(leaf), m=int(m), table=int(table),
                    cap=int(cap), nb=int(nb))
