"""Per-ring compaction, sweep timing, curvature and LOAM feature extraction
(port of `lins_tpu/frontend/features.py`; reference StateEstimator.hpp:619-827).

The port has the "fast" picking mode, the reference package's default:
curvature local extrema in ±5-point windows with per-sector caps.  The
"exact" mode (the reference's sequential greedy suppression) raises
NotImplementedError.  Each ring is a row of an (L, S) tensor, so every
per-ring step runs over all rings at once.
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


# ---------------------------------------------------------------------------
# Flat compaction of (L,S) masked sets into padded FeatureClouds
# ---------------------------------------------------------------------------

def _compact_scatter_packed(seg: SegmentedScan, label, lf_mask, outlier_xyz,
                            outlier_mask, cfg: SlamConfig) -> ScanFeatures:
    """All five feature-set compactions as three scatters into one packed
    buffer.  The sets that share a scatter are disjoint: sharp (label 2) +
    flat (-1), less_sharp (>= 1) + less_flat (<= 0, voxel-thinned), and the
    outliers (their own source grid).  Every masked cell past its set's
    cap, and every unmasked cell, targets the one dropped overflow slot, so
    the kept slots each have a single writer."""
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
    buf[torch.minimum(tgt(4), tgt(2))] = packed

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
    """All feature sets for a segmented scan."""
    if cfg.feature_mode != "fast":
        raise NotImplementedError(
            f"feature_mode={cfg.feature_mode!r}: the port has the 'fast' "
            f"mode only; 'exact' is the port's next slice")
    label, less_flat_mask = extract_features_fast(seg, cfg)
    lf_mask = voxel_mask_hash(seg.xyz, less_flat_mask, cfg.surf_leaf_size)
    return _compact_scatter_packed(seg, label, lf_mask, outlier_xyz,
                                   outlier_mask, cfg)
