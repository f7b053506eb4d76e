"""Scan-to-scan feature correspondence + residual/Jacobian construction
(port of `lins_tpu/odometry/association.py`; reference
StateEstimator.hpp:829-1063).

The KD-tree 1-NN plus ring-constrained support search of the reference is
an exact masked argmin over a (Q, R) distance matrix, as in the reference
package:

  surf   : tripod1 = global NN;  tripod2 = NN on the same ring;
           tripod3 = NN on a different ring within ±2 rings
  corner : tripod1 = global NN;  tripod2 = NN on a different ring within ±2

All support distances gate at nearest_feature_search_sq_dist.  Ties in an
argmin go to the lowest index, as `jnp.argmin` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lins_tpu_torch.geom import so3


class Matches(NamedTuple):
    """Per-query stacked measurement rows (padded, masked)."""

    point: torch.Tensor   # (Q,3) original (untransformed) new-scan point
    coeff: torch.Tensor   # (Q,3) s * residual direction
    resid: torch.Tensor   # (Q,)  s * point-to-feature distance
    valid: torch.Tensor   # (Q,)  bool


def transform_to_start(pts, rel_time, rn, qbn):
    """Per-point constant-velocity de-skew into the scan start frame
    (transformToStart, StateEstimator.hpp:1066-1080)."""
    phi = so3.log_quat(qbn)
    q_s = so3.exp_axis(rel_time[:, None] * phi[None, :])
    return so3.quat_rotate(q_s, pts) + rel_time[:, None] * rn[None, :]


def transform_to_end(pts, rel_time, rn, qbn):
    """De-skew into the scan end frame (transformToEnd,
    StateEstimator.hpp:1083-1101)."""
    p1 = transform_to_start(pts, rel_time, rn, qbn)
    return so3.quat_rotate_inv(qbn[None, :], p1 - rn[None, :])


def _pairwise_sq_dist(a, b):
    """(Q,3),(R,3) -> (Q,R) squared distances via one matrix product.

    The product must run in full float32: with |p|^2 ~ 10^3 m^2, TF32's
    10-bit mantissa puts metres^2 of noise on d^2 and picks wrong nearest
    neighbours (the reference package needs Precision.HIGHEST on the TPU for
    the same reason).  The drivers turn TF32 off (utils/device.py)."""
    aa = torch.sum(a * a, dim=-1, keepdim=True)
    bb = torch.sum(b * b, dim=-1)
    ab = a @ b.T
    return torch.clamp(aa + bb[None, :] - 2.0 * ab, min=0.0)


def _masked_argmin(d, mask):
    d_m = torch.where(mask, d, torch.inf)
    idx = torch.argmin(d_m, dim=-1)
    val = torch.gather(d_m, 1, idx[:, None])[:, 0]
    return idx, val


def _weight(iter_count: int, w, cfg):
    """s = w from the icp_freq-th iteration on, else 1.  The iteration
    count is a host int: the loops count their trips on the host
    (odometry/ieskf.py)."""
    return w if iter_count >= cfg.icp_freq else torch.ones_like(w)


def find_surf_matches(q_pts, q_rel, q_valid, r_pts, r_ring, r_valid,
                      rn, qbn, iter_count, cfg) -> Matches:
    """Point-to-plane matches of new flat features against last less-flat set
    (findCorrespondingSurfFeatures, StateEstimator.hpp:829-953)."""
    max_d2 = cfg.nearest_feature_search_sq_dist
    p_start = transform_to_start(q_pts, q_rel, rn, qbn)

    d2 = _pairwise_sq_dist(p_start, r_pts)
    i1, d1 = _masked_argmin(d2, r_valid[None, :])
    ring1 = r_ring[i1]
    near = d1 < max_d2

    same_ring = (r_ring[None, :] == ring1[:, None]) & r_valid[None, :]
    cols = torch.arange(r_pts.shape[0], device=r_pts.device)
    same_ring = same_ring & (cols[None, :] != i1[:, None])
    i2, d2_min = _masked_argmin(d2, same_ring)

    other_ring = ((r_ring[None, :] != ring1[:, None])
                  & (torch.abs(r_ring[None, :] - ring1[:, None]) <= 2)
                  & r_valid[None, :])
    i3, d3_min = _masked_argmin(d2, other_ring)

    matched = q_valid & near & (d2_min < max_d2) & (d3_min < max_d2)

    P0, P1, P2, P3 = p_start, r_pts[i1], r_pts[i2], r_pts[i3]
    M = torch.linalg.cross(P1 - P2, P1 - P3, dim=-1)
    m = torch.linalg.vector_norm(M, dim=-1)
    m_safe = torch.clamp(m, min=1e-12)
    res = torch.sum((P0 - P1) * M, dim=-1) / m_safe
    jac = M / m_safe[:, None]

    w = 1.0 - 1.8 * torch.abs(res) / torch.sqrt(torch.sqrt(torch.clamp(
        torch.linalg.vector_norm(P0, dim=-1), min=1e-12)))
    s = _weight(iter_count, w, cfg)

    ok = matched & (s > 0.1) & (res != 0.0) & (m > 1e-12)
    return Matches(point=q_pts, coeff=s[:, None] * jac, resid=s * res,
                   valid=ok)


def find_corner_matches(q_pts, q_rel, q_valid, r_pts, r_ring, r_valid,
                        rn, qbn, iter_count, cfg) -> Matches:
    """Point-to-line matches of new sharp features against last less-sharp
    set (findCorrespondingCornerFeatures, StateEstimator.hpp:955-1063)."""
    max_d2 = cfg.nearest_feature_search_sq_dist
    p_start = transform_to_start(q_pts, q_rel, rn, qbn)

    d2 = _pairwise_sq_dist(p_start, r_pts)
    i1, d1 = _masked_argmin(d2, r_valid[None, :])
    ring1 = r_ring[i1]
    near = d1 < max_d2

    other_ring = ((r_ring[None, :] != ring1[:, None])
                  & (torch.abs(r_ring[None, :] - ring1[:, None]) <= 2)
                  & r_valid[None, :])
    i2, d2_min = _masked_argmin(d2, other_ring)

    matched = q_valid & near & (d2_min < max_d2)

    P0, P1, P2 = p_start, r_pts[i1], r_pts[i2]
    Pc = torch.linalg.cross(P0 - P1, P0 - P2, dim=-1)
    r = torch.linalg.vector_norm(Pc, dim=-1)
    d12 = torch.linalg.vector_norm(P1 - P2, dim=-1)
    denom = torch.clamp(d12 * r, min=1e-12)
    res = r / torch.clamp(d12, min=1e-12)
    # jac = Pᵀ [P2-P1]x / (d12 r)   (StateEstimator.hpp:1044-1045)
    jac = torch.einsum("ni,nij->nj", Pc, so3.skew(P2 - P1)) / denom[:, None]

    w = 1.0 - 1.8 * torch.abs(res)
    s = _weight(iter_count, w, cfg)

    ok = matched & (s > 0.1) & (res != 0.0) & (r > 1e-12)
    return Matches(point=q_pts, coeff=s[:, None] * jac, resid=s * res,
                   valid=ok)


def stack_matches(surf: Matches, corner: Matches) -> Matches:
    return Matches(*(torch.cat([a, b]) for a, b in zip(surf, corner)))
