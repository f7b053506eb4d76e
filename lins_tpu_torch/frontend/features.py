"""Per-ring compaction, sweep timing, curvature and LOAM feature extraction
(port of `lins_tpu/frontend/features.py`; reference StateEstimator.hpp:619-827).

Both picking modes of the reference package: "fast" (its default,
curvature local extrema in ±5-point windows with per-sector caps) and
"exact" (the reference's sequential greedy picking with its ±5-point
suppression, then a centroid per voxel of each ring's less-flat points).
Each ring is a row of an (L, S) tensor, so every per-ring step runs over
all rings at once; the exact mode's greedy picks are fixed trips over the
rows with their carries frozen where a row has nothing left to pick, so
nothing is read back to the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.frontend.projection import div_const
from lins_tpu_torch.frontend.types import FeatureCloud, ScanFeatures, SegmentedScan
from lins_tpu_torch.geom import so3


# ---------------------------------------------------------------------------
# Per-ring compaction (cloud_info equivalent)
# ---------------------------------------------------------------------------

def compact_rings(xyz_img, rng_img, seg_valid, ground, start, diff,
                  cfg: SlamConfig) -> SegmentedScan:
    """Compact selected cells of each ring to the front of a (L,S) layout,
    apply the lidar->vehicle extrinsic yaw (StateEstimator.hpp:1104-1114) and
    compute each point's sweep fraction (rel_time)."""
    L, S = cfg.line_num, cfg.scan_num
    dev, dt = xyz_img.device, xyz_img.dtype
    cols = torch.arange(S, dtype=torch.int32, device=dev).expand(L, S)

    # stable per-ring compaction: each selected cell goes to its prefix-sum
    # slot; unselected cells all land in the dropped overflow slot S (the
    # only duplicate target, so the scatter's order never matters)
    pos = torch.cumsum(seg_valid.to(torch.int32), dim=1) - 1
    tgt = torch.where(seg_valid, pos, S)
    rows = torch.arange(L, device=dev)[:, None]
    packed = torch.cat([
        xyz_img, rng_img[..., None], cols.to(dt)[..., None],
        ground.to(dt)[..., None]], dim=-1)
    out = torch.zeros((L * (S + 1), 6), dtype=dt, device=dev)
    out = out.index_copy(0, (rows * (S + 1) + tgt).reshape(-1),
                         packed.reshape(-1, 6)).reshape(L, S + 1, 6)
    xyz_c = out[:, :S, 0:3]
    rng_c = out[:, :S, 3]
    col_c = out[:, :S, 4].to(torch.int32)
    grd_c = out[:, :S, 5] > 0.5
    count = torch.sum(seg_valid.to(torch.int32), dim=1)
    valid_c = torch.arange(S, device=dev)[None, :] < count[:, None]

    # extrinsic yaw rotation (rotatePoint): lidar frame -> vehicle frame
    yaw = torch.full((), so3.deg2rad(cfg.imu_lidar_extrinsic_angle),
                     dtype=dt, device=dev)
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = c * xyz_c[..., 0] - s * xyz_c[..., 1]
    y = s * xyz_c[..., 0] + c * xyz_c[..., 1]
    xyz_v = torch.stack([x, y, xyz_c[..., 2]], dim=-1)

    # sweep fraction from azimuth (replaces the halfPassed loop)
    ori = -torch.atan2(xyz_v[..., 1], xyz_v[..., 0])
    rel = torch.remainder(ori - start, 2.0 * math.pi) / torch.clamp(
        diff, min=1e-6)
    rel = torch.clamp(rel, 0.0, 1.0)

    return SegmentedScan(
        xyz=torch.where(valid_c[..., None], xyz_v, 0.0),
        rng=torch.where(valid_c, rng_c, 0.0),
        col=col_c, ground=grd_c & valid_c, valid=valid_c, count=count,
        rel_time=torch.where(valid_c, rel, 0.0),
        start_orientation=start, orientation_diff=diff,
    )


# ---------------------------------------------------------------------------
# Curvature + occlusion masking (all rings, shifts along the ring axis)
# ---------------------------------------------------------------------------

def _shift(a, k, fill):
    """Shift along the last axis right by k (k>0) or left (k<0), filling
    with `fill`."""
    if k == 0:
        return a
    pad = torch.full(a.shape[:-1] + (abs(k),), fill, dtype=a.dtype,
                     device=a.device)
    if k > 0:
        return torch.cat([pad, a[..., :-k]], dim=-1)
    return torch.cat([a[..., -k:], pad], dim=-1)


def curvature_ring(rng, count):
    """LOAM curvature (StateEstimator.hpp:656-678) over compacted rings
    rng (L,S), count (L,)."""
    S = rng.shape[-1]
    acc = -10.0 * rng
    for k in range(1, 6):
        acc = acc + _shift(rng, k, 0.0) + _shift(rng, -k, 0.0)
    curv = acc * acc
    idx = torch.arange(S, device=rng.device)
    ok = (idx >= 5) & (idx <= count[..., None] - 6)
    return torch.where(ok, curv, 0.0), ok


def occlusion_ring(rng, col, count):
    """Occluded / parallel-beam suppression (StateEstimator.hpp:680-713)."""
    S = rng.shape[-1]
    idx = torch.arange(S, device=rng.device)
    in_rng = (idx >= 5) & (idx <= count[..., None] - 7)

    nxt = _shift(rng, -1, math.inf)            # r[i+1]
    col_next = _shift(col, -1, 10 ** 6)
    col_close = torch.abs(col_next - col) < 10

    occ_a = in_rng & col_close & (rng - nxt > 0.3)   # suppress i-5..i
    occ_b = in_rng & col_close & (nxt - rng > 0.3)   # suppress i+1..i+6

    picked = torch.zeros_like(in_rng)
    for k in range(0, 6):           # picked[j] |= occ_a[j+k], k=0..5
        picked = picked | _shift(occ_a, -k, False)
    for k in range(1, 7):           # picked[j] |= occ_b[j-k], k=1..6
        picked = picked | _shift(occ_b, k, False)

    prev = _shift(rng, 1, math.inf)
    diff1 = torch.abs(prev - rng)
    diff2 = torch.abs(nxt - rng)
    parallel = in_rng & (diff1 > 0.02 * rng) & (diff2 > 0.02 * rng)
    return picked | parallel


# ---------------------------------------------------------------------------
# Fast extraction: local-extrema picking
# ---------------------------------------------------------------------------

def _window_extreme(x, radius, mode):
    """Per-position max/min of x over a ±radius window along axis 1 (wraps)."""
    out = x
    for k in range(1, radius + 1):
        a = torch.roll(x, k, dims=1)
        b = torch.roll(x, -k, dims=1)
        if mode == "max":
            out = torch.maximum(out, torch.maximum(a, b))
        else:
            out = torch.minimum(out, torch.minimum(a, b))
    return out


def extract_features_fast(seg: SegmentedScan, cfg: SlamConfig):
    """Vectorized feature picking: curvature local extrema in ±5 windows,
    per-sector caps (2 sharp / 20 less-sharp / 4 flat) in column order.
    Returns (label (L,S) int32: 2 sharp, 1 less-sharp, -1 flat, 0 other;
    less_flat mask)."""
    L, S = seg.rng.shape
    dev = seg.rng.device
    counts = seg.count
    idx = torch.arange(S, device=dev)[None, :]

    curv, curv_ok = curvature_ring(seg.rng, counts)
    occl = occlusion_ring(seg.rng, seg.col, counts)

    s_idx = 5
    e_idx = (counts - 6)[:, None]
    in_range = (idx >= s_idx) & (idx <= e_idx) & curv_ok & seg.valid

    # sector ids over the compacted per-ring layout (floor division)
    span = torch.clamp(e_idx - s_idx + 1, min=1)
    sector_id_f = torch.clamp((idx - s_idx) * 6 // torch.clamp(span, min=1),
                              0, 5)

    # --- corners ---
    cand_c = in_range & ~occl & (curv > cfg.edge_threshold) & ~seg.ground
    cmax = _window_extreme(torch.where(cand_c, curv, -1.0), 5, "max")
    pick_c = cand_c & (curv >= cmax)
    # break ties in a window: keep the first of any tied pair
    tie = pick_c & torch.roll(pick_c, 1, dims=1) & (
        torch.abs(curv - torch.roll(curv, 1, dims=1)) < 1e-12)
    pick_c = pick_c & ~tie

    # less-sharp cap (20) per sector, column order — all sectors on one axis
    nsec = cfg.sections_total
    sec = sector_id_f[:, None, :] == torch.arange(nsec, device=dev)[None, :,
                                                                     None]
    curv6 = curv[:, None, :]
    m = pick_c[:, None, :] & sec
    m20 = m & (torch.cumsum(m, dim=-1) <= cfg.edge_less_feature_num)
    less_sharp = torch.any(m20, dim=1)
    # top-2 by curvature within each sector
    cv = torch.where(m20, curv6, -1.0)
    mx1 = torch.amax(cv, dim=-1, keepdim=True)
    m1 = (cv >= mx1) & m20
    m1 = m1 & (torch.cumsum(m1, dim=-1) == 1)
    cv2 = torch.where(m20 & ~m1, curv6, -1.0)
    mx2 = torch.amax(cv2, dim=-1, keepdim=True)
    m2 = (cv2 >= mx2) & m20 & ~m1
    m2 = m2 & (torch.cumsum(m2, dim=-1) == 1)
    sharp = torch.any((m1 & (mx1 > 0)) | (m2 & (mx2 > 0)), dim=1)

    # --- flats: spaced low-curvature ground points, 4 per sector ---
    cand_f = in_range & ~occl & (curv < cfg.surf_threshold) & seg.ground
    mf = cand_f[:, None, :] & sec
    rank = torch.cumsum(mf, dim=-1) - 1
    spaced = mf & (rank % 6 == 0)
    spaced = spaced & (torch.cumsum(spaced, dim=-1) <= cfg.surf_feature_num)
    flat = torch.any(spaced, dim=1)

    lab = torch.where(sharp, 2, torch.where(less_sharp, 1,
                                            torch.where(flat, -1, 0)))
    lab = lab.to(torch.int32)
    less_flat_mask = in_range & (lab <= 0)
    return lab, less_flat_mask


# ---------------------------------------------------------------------------
# Greedy sector picking (the "exact" mode: the reference's semantics)
# ---------------------------------------------------------------------------

def _suppress(picked, ind, gap_ok, do):
    """Mark `ind` and its ±5 neighbours picked on each row where `do`,
    stopping at a column gap > 10 (StateEstimator.hpp:763-777); gap_ok[i]
    == (|col[i] - col[i-1]| <= 10).  picked, gap_ok (L,S); ind, do (L,).

    Dense over the row: position ind + l (0 < l <= 5) is marked when every
    gap_ok[ind+1 .. ind+l] holds, ind - l when every gap_ok[ind-l+1 .. ind]
    does.  No scatter, so the reference's clipped duplicate writes at a
    ring's ends have nothing to race."""
    S = picked.shape[-1]
    offs = torch.arange(1, 6, device=picked.device)
    fwd = gap_ok.gather(1, torch.clamp(ind[:, None] + offs, max=S - 1))
    bwd = gap_ok.gather(1, torch.clamp(ind[:, None] - offs + 1, min=0))
    runs = torch.cat([torch.flip(torch.cumprod(bwd.to(torch.int32), dim=1),
                                 [1]),
                      torch.ones_like(fwd[:, :1], dtype=torch.int32),
                      torch.cumprod(fwd.to(torch.int32), dim=1)], dim=1)
    runs = (runs > 0) & do[:, None]
    d = torch.arange(S, device=picked.device) - ind[:, None]
    near = runs.gather(1, torch.clamp(d + 5, 0, 10)) & (torch.abs(d) <= 5)
    return picked | near


def extract_rings(seg: SegmentedScan, cfg: SlamConfig):
    """Feature labels of every compacted ring by the reference's greedy
    picking (extractFeatures, StateEstimator.hpp:719-827): per ring, 6
    sectors in turn, each up to `edge_less_feature_num` greedy corner picks
    (the first `edge_feature_num` sharp) then `surf_feature_num` flat picks,
    every pick suppressing its ±5 neighbours across sector boundaries.
    Ties go to the first index (`torch.argmax` / `argmin`, as
    `jnp.argmax` / `argmin`).  Returns (label (L,S) int32: 2 sharp, 1
    less-sharp, -1 flat, 0 other; less_flat mask)."""
    L, S = seg.rng.shape
    dev = seg.rng.device
    count = seg.count
    curv, curv_ok = curvature_ring(seg.rng, count)
    picked = occlusion_ring(seg.rng, seg.col, count)
    gap_ok = torch.abs(seg.col - _shift(seg.col, 1, 10 ** 6)) <= 10
    idx = torch.arange(S, device=dev)
    e_idx = count - 6
    label = torch.zeros((L, S), dtype=torch.int32, device=dev)
    corner_ok = curv_ok & seg.valid & (curv > cfg.edge_threshold) & ~seg.ground
    flat_ok = curv_ok & seg.valid & (curv < cfg.surf_threshold) & seg.ground

    def pick(cand, best, fill, value):
        """One greedy pick on every row: the best unpicked candidate, if
        any and the sector is not empty, gets `value` and suppresses its
        neighbours."""
        nonlocal picked, label
        cand = cand & ~picked
        do = torch.any(cand, dim=1) & nonempty
        ind = best(torch.where(cand, curv, fill), dim=1)
        label = torch.where((idx == ind[:, None]) & do[:, None],
                            value[:, None], label)
        picked = _suppress(picked, ind, gap_ok, do)
        return do.to(torch.int32)

    flat = torch.full((L,), -1, dtype=torch.int32, device=dev)
    for j in range(6):         # the reference's 6 sectors a ring
        sp = torch.div(5 * (6 - j) + e_idx * j, 6, rounding_mode="floor")
        ep = torch.div(5 * (5 - j) + e_idx * (j + 1), 6,
                       rounding_mode="floor") - 1
        sector = (idx >= sp[:, None]) & (idx <= ep[:, None])
        nonempty = sp < ep
        n = torch.zeros(L, dtype=torch.int32, device=dev)
        for _ in range(cfg.edge_less_feature_num):
            value = torch.where(n < cfg.edge_feature_num, 2, 1).to(torch.int32)
            n = n + pick(sector & corner_ok, torch.argmax, -math.inf, value)
        for _ in range(cfg.surf_feature_num):
            pick(sector & flat_ok, torch.argmin, math.inf, flat)
    sector_all = (idx >= 5) & (idx <= e_idx[:, None]) & seg.valid
    return label, sector_all & (label <= 0)


def extract_ring(ring: dict, cfg: SlamConfig):
    """Feature labels for one compacted ring: `extract_rings` over a scan
    of that one ring.  ring: dict with rng (S,), col (S,), ground (S,),
    valid (S,), count (); returns (label (S,) int32: 2 sharp, 1
    less-sharp, -1 flat, 0 other; less_flat mask (S,))."""
    count = torch.as_tensor(ring["count"], dtype=torch.int32,
                            device=ring["rng"].device).reshape(1)
    seg = SegmentedScan(
        xyz=None, rng=ring["rng"][None], col=ring["col"][None],
        ground=ring["ground"][None], valid=ring["valid"][None], count=count,
        rel_time=None, start_orientation=None, orientation_diff=None)
    label, less_flat = extract_rings(seg, cfg)
    return label[0], less_flat[0]


# ---------------------------------------------------------------------------
# Voxel thinning
# ---------------------------------------------------------------------------

def voxel_mask_hash(xyz, mask, leaf, table: int = 1 << 14):
    """O(n) sort-free voxel thinning: keep the first masked point of each
    occupied voxel via a scatter-min hash table (first point per voxel;
    rare hash collisions drop points rather than corrupt them).

    The reference package hashes in int32 and lets `v * 73856093` wrap.
    Only the low log2(table) bits are kept, and those bits of a product,
    xor and and are the same whether it wrapped or not, so the hash is
    taken in int64 (no overflow) and equals the int32 one exactly.
    Returns a thinned boolean mask of xyz's leading shape.
    """
    shape = mask.shape
    x = xyz.reshape(-1, 3)
    m = mask.reshape(-1)
    n = x.shape[0]
    v = torch.floor(div_const(x, leaf)).to(torch.int32).to(torch.int64)
    h = ((v[:, 0] * 73856093) ^ (v[:, 1] * 19349663)
         ^ (v[:, 2] * 83492791)) & (table - 1)
    idx = torch.arange(n, device=x.device)
    key = torch.where(m, idx, n)
    tbl = torch.full((table,), n, dtype=torch.int64, device=x.device)
    tbl = tbl.scatter_reduce(0, h, key, "amin")
    keep = m & (tbl[h] == idx)
    return keep.reshape(shape)


def _voxel_hash32(xyz, leaf):
    """The reference package's int32 voxel hash of each point: cell =
    floor(xyz / leaf) (`div_const`, as XLA folds the division), mixed by
    three primes in int32 with wraparound.  Formed in int64 (exact) and
    wrapped to int32: the low 32 bits of products and xors do not depend
    on the wider type."""
    v = torch.floor(div_const(xyz, leaf)).to(torch.int32).to(torch.int64)
    h = ((v[..., 0] * 73856093) ^ (v[..., 1] * 19349663)
         ^ (v[..., 2] * 83492791))
    return (torch.remainder(h + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def voxel_downsample_ring(xyz, rel, mask, leaf):
    """Centroid per voxel of each ring's masked points, all rings at once:
    xyz (L,S,3), rel (L,S), mask (L,S).  Each row is sorted (stably) by
    the int32 voxel hash, unmasked points last; each run of equal hashes
    gives its centroid and mean sweep time at the run's first slot.
    Returns (xyz (L,S,3), rel (L,S), mask (L,S)) in the sorted order, as the
    reference package's `voxel_downsample_ring` does per ring.

    The run sums come from prefix-sum differences, as in the reference,
    but in float64 whatever the dtype (`ops/voxel.run_sums`, a recorded
    departure): in float32 a prefix over a ring of points 30 m out reaches
    about 5e4 m and each difference loses millimetres (PERF.md §4)."""
    from lins_tpu_torch.ops.voxel import run_sums

    L, S = mask.shape
    dev = xyz.device
    h = torch.where(mask, _voxel_hash32(xyz, leaf),
                    torch.iinfo(torch.int32).max)
    hs, order = torch.sort(h, dim=1, stable=True)
    xs = torch.gather(xyz, 1, order[..., None].expand(L, S, 3))
    rs = torch.gather(rel, 1, order)
    ms = torch.gather(mask, 1, order)

    first = torch.ones((L, 1), dtype=torch.bool, device=dev)
    start = torch.cat([first, hs[:, 1:] != hs[:, :-1]], dim=1) & ms

    # the end of the run at i: the first run start after i (or S), by a
    # reverse cumulative minimum
    next_start = torch.cat([start[:, 1:], first], dim=1)
    pos = torch.where(next_start, torch.arange(1, S + 1, device=dev), S)
    next_pos = torch.flip(torch.cummin(torch.flip(pos, [1]), dim=1)[0], [1])
    # the sweep time rides as a fourth column of the same sums (the cat
    # takes the wider dtype, and each mean is rounded once to its own)
    mean = run_sums(torch.cat([xs, rs[..., None]], -1), ms, next_pos)[2]
    cent, cent_rel = mean[..., :3].to(xyz.dtype), mean[..., 3].to(rel.dtype)
    return (torch.where(start[..., None], cent, 0.0),
            torch.where(start, cent_rel, 0.0), start)


# ---------------------------------------------------------------------------
# Flat compaction of (L,S) masked sets into padded FeatureClouds
# ---------------------------------------------------------------------------

def _compact_scatter_packed(seg: SegmentedScan, label, lf_mask, outlier_xyz,
                            outlier_mask, cfg: SlamConfig, lf_xyz=None,
                            lf_rel=None) -> ScanFeatures:
    """All five feature-set compactions as scatters into one packed
    buffer.  The sets that share a scatter are disjoint: sharp (label 2) +
    flat (-1), less_sharp (>= 1) + less_flat (<= 0, voxel-thinned), and the
    outliers (their own source grid).  When the less-flat points have a
    source of their own (`lf_xyz`, `lf_rel`: the exact mode's centroids),
    less-flat and less-sharp each get a scatter of their own instead.
    Every masked cell past its set's cap, and every unmasked cell, targets
    the one dropped overflow slot, so the kept slots each have a single
    writer."""
    L, S = label.shape
    n = L * S
    dev, dtype = seg.xyz.device, seg.xyz.dtype
    rings = torch.arange(L, device=dev)[:, None].expand(L, S).reshape(-1)
    rings = rings.to(dtype)[:, None]
    xyz = seg.xyz.reshape(-1, 3)
    rel = seg.rel_time.reshape(-1)

    caps = (cfg.max_sharp, cfg.max_flat, cfg.max_less_flat, cfg.max_outlier,
            cfg.max_less_sharp)
    base = np.cumsum((0,) + caps)          # static slot offsets
    total = int(base[-1])

    masks = torch.stack([(label == 2).reshape(-1),
                         (label == -1).reshape(-1),
                         lf_mask.reshape(-1),
                         outlier_mask.reshape(-1),
                         (label >= 1).reshape(-1)])
    ranks = torch.cumsum(masks.to(torch.int32), dim=1) - 1

    def tgt(i):
        r = ranks[i]
        return torch.where(masks[i] & (r < caps[i]), int(base[i]) + r,
                           total).long()

    packed = torch.cat([xyz, rel[:, None], rings], dim=-1)
    buf = torch.zeros((total + 1, 5), dtype=dtype, device=dev)
    packed_o = torch.cat(
        [outlier_xyz.reshape(-1, 3), torch.zeros((n, 1), dtype=dtype,
                                                 device=dev), rings], dim=-1)
    buf[torch.minimum(tgt(0), tgt(1))] = packed
    buf[tgt(3)] = packed_o
    if lf_xyz is None:
        buf[torch.minimum(tgt(4), tgt(2))] = packed
    else:
        buf[tgt(4)] = packed
        buf[tgt(2)] = torch.cat([lf_xyz.reshape(-1, 3),
                                 lf_rel.reshape(-1)[:, None], rings], dim=-1)

    def cloud(i):
        sl = slice(int(base[i]), int(base[i + 1]))
        count = torch.clamp(ranks[i, -1] + 1, max=caps[i])
        return FeatureCloud(xyz=buf[sl, 0:3], rel_time=buf[sl, 3],
                            ring=buf[sl, 4].to(torch.int32),
                            valid=torch.arange(caps[i], device=dev) < count)

    return ScanFeatures(sharp=cloud(0), less_sharp=cloud(4), flat=cloud(1),
                        less_flat=cloud(2), outlier=cloud(3))


def extract_features(seg: SegmentedScan, outlier_xyz, outlier_mask,
                     cfg: SlamConfig) -> ScanFeatures:
    """All feature sets for a segmented scan, in `cfg.feature_mode`:
    "fast" (local extrema, the first point of each voxel) or "exact" (the
    reference's greedy picking, the centroid of each voxel a ring)."""
    if cfg.feature_mode == "fast":
        label, less_flat_mask = extract_features_fast(seg, cfg)
        lf_mask = voxel_mask_hash(seg.xyz, less_flat_mask, cfg.surf_leaf_size)
        return _compact_scatter_packed(seg, label, lf_mask, outlier_xyz,
                                       outlier_mask, cfg)
    label, less_flat_mask = extract_rings(seg, cfg)
    lf_xyz, lf_rel, lf_mask = voxel_downsample_ring(
        seg.xyz, seg.rel_time, less_flat_mask, cfg.surf_leaf_size)
    return _compact_scatter_packed(seg, label, lf_mask, outlier_xyz,
                                   outlier_mask, cfg, lf_xyz, lf_rel)
