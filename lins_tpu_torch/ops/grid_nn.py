"""Voxel-hash grid k-NN of the scan-to-map backend (port of the main-path
part of `lins_tpu/ops/grid_nn.py`; it replaces the mapping KD-trees,
lidar_mapping_node.cpp:1355-1357, 1465).

Scan-to-map accepts a correspondence only when the 5th neighbour lies
within 1 m, so map points are binned into voxel cells and each query
gathers candidates from its neighbourhood block only (27 cells, or 8
supercells), which covers every point within 1 m.  `gather_candidates`
prunes each block to its nearest C points once per mapping step (kernel K3,
`ops/select.py`, which reads the block from the grid in place); every
Gauss-Newton trip re-ranks that small cache at the current pose
(`knn_from_candidates`).  Candidates are stored densely per
bucket as (table, 3, cap) rows.

Off the mapper's path, as in the reference: `build_grid_voxelized` (the
voxel filter and the binning fused into one sort), `grid_knn` (the k
nearest in the 27-cell block, no cache) and `gather_block` (the whole
block, no pruning).
"""
from __future__ import annotations

import dataclasses

import torch

from lins_tpu_torch.frontend.projection import div_const
from lins_tpu_torch.ops import select as _select
from lins_tpu_torch.ops.voxel import IMIN, hash3


@dataclasses.dataclass(frozen=True)
class HashGrid:
    cells: torch.Tensor   # (table, 3, cap) bucket-major candidate points
    cnt: torch.Tensor     # (table,) int32 valid points per bucket (<= cap)
    cell: float
    table: int
    cap: int
    # neighbourhood arity: 27 = the ±1-cell block around floor(q/cell)
    # (covers radius `cell`); 8 = supercells, the 2x2x2 block around
    # floor(q/cell - 1/2) (covers radius >= cell/2)
    nb: int = 27


def _bucket_of(cid: torch.Tensor, table: int) -> torch.Tensor:
    """Hash integer cell coords (..., 3) to an int32 bucket id in
    [0, table): |hash3| in int32 (so |INT_MIN| stays INT_MIN) floor-mod
    table, as the reference computes it."""
    h = hash3(cid).to(torch.int64)
    a = torch.where(h == IMIN, h, torch.abs(h))
    return torch.remainder(a, table).to(torch.int32)


def build_grid(pts: torch.Tensor, valid: torch.Tensor, cell: float,
               table: int = 16384, cap: int = 32) -> HashGrid:
    """Bin a masked (R, 3) point set into hashed voxel-cell buckets.

    Points are stably sorted by bucket id, given a slot (rank within their
    bucket's run) and scattered into a dense (table, 3, cap) store; slots
    beyond `cap` are dropped and not counted.
    """
    R = pts.shape[0]
    dev = pts.device
    cid = torch.floor(div_const(pts, cell)).to(torch.int32)
    b = torch.where(valid, _bucket_of(cid, table), table)
    order = torch.sort(b, stable=True).indices
    b_s = b[order].to(torch.int64)
    ps = pts[order]

    # slot = rank within the bucket's run of the sorted array
    ar = torch.arange(R, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          b_s[1:] != b_s[:-1]])
    run_start = torch.cummax(torch.where(is_start, ar, -1), 0).values
    slot = ar - run_start

    keep = (b_s < table) & (slot < cap)
    dump = table * 3 * cap          # a buffer one longer takes dropped rows
    buf = torch.zeros(dump + 1, dtype=pts.dtype, device=dev)
    for i in range(3):
        flat = torch.where(keep, b_s * 3 * cap + i * cap + slot, dump)
        buf[flat] = ps[:, i]
    cnt = torch.zeros(table + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, torch.where(keep, b_s, table), keep.to(torch.int32))
    return HashGrid(cells=buf[:-1].reshape(table, 3, cap), cnt=cnt[:-1],
                    cell=float(cell), table=int(table), cap=int(cap))


def build_grid_voxelized(pts: torch.Tensor, valid: torch.Tensor,
                         leaf: float, m: int, table: int = 16384,
                         cap: int = 32, nb: int = 27):
    """Voxel-filter a masked (R, 3) point set and bin the centroids into
    the hash grid, fused into one sort (the reference's alternative to
    `voxel_downsample` + `build_grid`; PCL VoxelGrid at
    lidar_mapping_node.cpp:283-291, KD-tree build :1355).

    Rows are sorted by (bucket·m³ + voxel-in-cell id, then the exact voxel
    coordinates), as the voxel map's build sorts them (`ops/voxel_map.
    _runs`); each voxel run's centroid is its run mean, and its rank among
    the voxel runs of its bucket is its slot in the (table, 3, cap) store
    (slots from cap on are dropped and not counted).  The cell edge is
    leaf·m, so voxels never straddle cells; m must make leaf·m >= 1 m
    (nb=27) or >= 2 m (nb=8 supercells) for the 1 m gate's coverage.

    Departure from the reference, as in every builder of the port: the
    run sums are float64 prefix sums (`voxel.run_sums`), the centroids
    rounded once to the points' dtype.  Returns (HashGrid, n_voxels),
    n_voxels the voxel count (0-dim int32)."""
    from lins_tpu_torch.ops.voxel_map import _rank_in_bucket_run, _runs

    dev = pts.device
    key_s, _, _, vstart, _, _, cent = _runs(pts, valid, leaf, m, table)
    bkt_s = torch.div(key_s, m * m * m, rounding_mode="floor").to(
        torch.int64)
    slot = _rank_in_bucket_run(bkt_s, vstart)
    keep = vstart & (slot < cap)
    dump = table * 3 * cap          # a buffer one longer takes dropped rows
    buf = torch.zeros(dump + 1, dtype=pts.dtype, device=dev)
    for i in range(3):
        buf[torch.where(keep, bkt_s * 3 * cap + i * cap + slot, dump)] = (
            cent[:, i])
    cnt = torch.zeros(table + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, torch.where(keep, bkt_s, table), keep.to(torch.int32))
    grid = HashGrid(cells=buf[:-1].reshape(table, 3, cap), cnt=cnt[:-1],
                    cell=float(leaf * m), table=int(table), cap=int(cap),
                    nb=int(nb))
    return grid, torch.sum(vstart, dtype=torch.int32)


def _offsets(lo: int, hi: int, device) -> torch.Tensor:
    """The neighbour-cell offsets in [lo, hi)^3 as (n^3, 3) int32 in the
    reference's (meshgrid "ij") order: 27 around the cell, or the 8 of a
    supercell block.  Made on the device: a host->device copy would wait
    for the stream."""
    r = torch.arange(lo, hi, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def _neighborhood(query: torch.Tensor, grid: HashGrid):
    """Neighbour-cell integer coords (Q, nb, 3) + per-query guaranteed
    coverage radius (Q,) for the grid's neighbourhood mode."""
    c = grid.cell
    dev = query.device
    if grid.nb == 27:
        base = torch.floor(div_const(query, c)).to(torch.int32)
        offs = _offsets(-1, 2, dev)
        # the block spans [c(b-1), c(b+2)) per axis: >= c from q in
        # [cb, cb+c) to either edge
        cover = torch.full(query.shape[:1], c, dtype=query.dtype,
                           device=dev)
    else:
        base = torch.floor(div_const(query, c) - 0.5).to(torch.int32)
        offs = _offsets(0, 2, dev)
        lo = base.to(query.dtype) * c
        cover = torch.amin(torch.minimum(query - lo, lo + 2 * c - query),
                           dim=1)
    return base[:, None, :] + offs[None], cover


def gather_candidates(query: torch.Tensor, q_valid: torch.Tensor,
                      grid: HashGrid, C: int, use_pallas: bool = False):
    """One-shot candidate gather + prune to a compact (Q, C, 3) cache.

    Each query's neighbour buckets `bb` (Q, nb) are hashed here; K3
    (`ops/select.select_candidates`; its plain version on the CPU) reads
    their points from the grid in place, masks duplicate buckets, slots
    above a bucket's count and tombstones, and keeps the nearest C.
    `use_pallas` (the config's `use_pallas_select`) only picks the prune
    bound d2C, as the reference's two paths define it: the first DROPPED
    distance (kernel path) or the C-th KEPT one (sort path).  Both are sound
    for the re-gather test of the Gauss-Newton loop (scan2map.stale).

    Returns (cand (Q,C,3), cand_ok (Q,C), d2C (Q,), cover (Q,)).
    """
    nbc, cover = _neighborhood(query, grid)
    bb = _bucket_of(nbc, grid.table)                           # (Q, nb)
    out, cand_ok, _, d2C = _select.select_candidates(
        query, q_valid, bb, grid.cells, grid.cnt, C, first_dropped=use_pallas)
    return out, cand_ok, d2C, cover


def knn_from_candidates(p_w: torch.Tensor, q_valid: torch.Tensor,
                        cand: torch.Tensor, cand_ok: torch.Tensor,
                        k: int = 5):
    """k nearest of each query's cached candidate set at the current pose,
    by k passes of row minimum and the first (lowest-index) hit, as the
    reference selects them.  Returns (nn (Q,k,3), d2 (Q,k)); exhausted
    slots get +inf distance and the query point itself as nn."""
    diff = cand - p_w[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    # d2 < 1e17 excludes tombstone slots parked at the voxel map's SENTINEL
    d2 = torch.where(cand_ok & q_valid[:, None] & (d2 < 1.0e17), d2,
                     torch.inf)
    sels, ds = [], []
    for _ in range(k):
        m = torch.amin(d2, dim=1)
        hit = (d2 <= m[:, None]) & torch.isfinite(d2)
        first = hit & (torch.cumsum(hit.to(torch.int32), dim=1) == 1)
        sels.append(first.to(cand.dtype))
        ds.append(m)
        d2 = torch.where(first, torch.inf, d2)
    nn = torch.einsum("qkc,qci->qki", torch.stack(sels, dim=1), cand)
    d2k = torch.stack(ds, dim=1)
    nn = torch.where(torch.isfinite(d2k)[:, :, None], nn, p_w[:, None, :])
    return nn, d2k


def gather_block(query: torch.Tensor, q_valid: torch.Tensor, grid: HashGrid):
    """Every grid point of each query's neighbourhood block, with no
    pruning (the reference's "no pruning" experiment; off the mapper's
    path): cand (Q, nb·cap, 3) in cell-major order n·cap + s, ok (Q,
    nb·cap) (slots below the bucket's count, of buckets no earlier
    neighbour cell hashed to, of valid queries), cover (Q,)."""
    nbc, cover = _neighborhood(query, grid)
    cand, ok = _select.gather_block(_bucket_of(nbc, grid.table), grid.cells,
                                    grid.cnt)
    Q, n_off = nbc.shape[:2]
    ok = ok & q_valid[:, None, None]
    return (cand.transpose(2, 3).reshape(Q, n_off * grid.cap, 3),
            ok.reshape(Q, n_off * grid.cap), cover)


def grid_knn(query: torch.Tensor, q_valid: torch.Tensor, grid: HashGrid,
             k: int = 5):
    """k nearest grid points of each query within the 27 cells around
    floor(q / cell), whatever the grid's `nb`, as the reference computes
    them.  Duplicate buckets count once; tombstones (d2 >= 1e17) and
    invalid queries are at +inf.  Ties keep the lower cell-major index n·cap
    + s (a stable sort, as `lax.top_k` orders them).  Returns (nn (Q, k,
    3), d2 (Q, k)); slots beyond the in-range candidates get +inf and the
    query point itself as nn."""
    Q = query.shape[0]
    base = torch.floor(div_const(query, grid.cell)).to(torch.int32)
    bb = _bucket_of(base[:, None, :] + _offsets(-1, 2, query.device)[None],
                    grid.table)
    cand, ok = _select.gather_block(bb, grid.cells, grid.cnt)
    d2 = _select.masked_d2(query, q_valid, cand, ok)           # (Q, 27·cap)
    d2 = torch.where(d2 < _select._FAR2, d2, torch.inf)
    sel = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    d2k = torch.gather(d2, 1, sel)
    nn = torch.take_along_dim(cand.transpose(2, 3).reshape(Q, -1, 3),
                              sel[:, :, None], dim=1)
    nn = torch.where(torch.isfinite(d2k)[:, :, None], nn, query[:, None, :])
    return nn, d2k
