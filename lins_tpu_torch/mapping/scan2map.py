"""Scan-to-map Gauss-Newton refinement (port of
`lins_tpu/mapping/scan2map.py`; reference C20, lidar_mapping_node.cpp:
1351-1652).

Per Gauss-Newton trip:
  corner: 5-NN in the corner map -> 3x3 PCA -> point-to-line residual when
          the cluster is linear (λ1 > 3 λ2)
  surf:   5-NN in the surf map -> plane fit -> point-to-plane residual when
          the fit is tight (all |d| <= 0.2)
  stack -> 6x6 normal equations -> solve with the LOAM degeneracy
          projection (eigenvalue threshold 100)
Pose is (t, q) with an axis-angle right perturbation.

The candidate gather (grid_nn.gather_candidates, kernel K3) runs once per
mapping step; every trip re-ranks the cached (Q, C, 3) candidates at the
current pose (knn_from_candidates).  Two per-query bounds (neighbourhood
coverage and the prune distance d2C) say when the pose has moved far enough
that the cache could miss a point inside the 1 m acceptance ball; then the
trip gathers again, so accepted correspondences equal brute force.

The reference's while_loop (up to `scan2map_iters` trips, stopping on
convergence) stops here as it does: the host reads `active` before each
trip after the first (utils/device.may_stop), on every device, and its
re-gather `lax.cond` is decided on the host as well (utils/tree.cond): 2
K3 launches for the initial gather and 2 for each re-gather the bounds
force, two host reads a trip after the first.  The carry is still frozen
on the device where `active` is false, so the loop made to run every trip
gives the same result bit for bit (`iters` counts the active trips).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3
from lins_tpu_torch.odometry.gn_icp import spectral_projector
from lins_tpu_torch.ops.grid_nn import (build_grid, gather_candidates,
                                        knn_from_candidates)
from lins_tpu_torch.ops.lin3 import eigh_sym3x3, solve_sym3x3
from lins_tpu_torch.utils.device import may_stop
from lins_tpu_torch.utils.metrics import host_read, trace_scope
from lins_tpu_torch.utils.tree import cond


class _Gather(NamedTuple):
    pc: torch.Tensor       # corner query world positions at gather time
    ps: torch.Tensor       # surf query world positions at gather time
    cc: torch.Tensor       # (Qc, C, 3) corner candidates
    cc_ok: torch.Tensor
    cc_d2C: torch.Tensor   # (Qc,) prune bound
    cc_cov: torch.Tensor   # (Qc,) coverage radius of the gathered block
    sc: torch.Tensor
    sc_ok: torch.Tensor
    sc_d2C: torch.Tensor
    sc_cov: torch.Tensor


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _outer_sum(x):
    """(..., k, 3) -> (..., 3, 3) sum of outer products."""
    return torch.sum(x[..., :, :, None] * x[..., :, None, :], dim=-3)


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def corner_residuals(p_w, nn, d2, q_valid):
    """Point-to-line residuals vs 5-NN PCA lines
    (cornerOptimization, lidar_mapping_node.cpp:1351-1458)."""
    near = d2[:, 4] < 1.0
    c = torch.mean(nn, dim=1)                   # centroid
    A = _outer_sum(nn - c[:, None, :]) / 5.0
    w, V = eigh_sym3x3(A)                       # ascending, closed form
    linear = w[:, 2] > 3.0 * w[:, 1]
    v = V[:, :, 2]                              # principal direction

    cr = _cross(p_w - c, v)
    res = _norm(cr)
    # gradient of the distance wrt p_w: (cr x v)/|cr|, unit, in-plane
    grad = _cross(cr, v) / torch.clamp(res, min=1e-12)[:, None]
    grad = grad / torch.clamp(_norm(grad), min=1e-12)[:, None]

    s = 1.0 - 0.9 * torch.abs(res)
    ok = q_valid & near & linear & (s > 0.1) & (res > 1e-9)
    return grad * s[:, None], s * res, ok


def surf_residuals(p_w, nn, d2, q_valid):
    """Point-to-plane residuals vs 5-NN plane fits
    (surfOptimization, lidar_mapping_node.cpp:1460-1521).

    The port departs from the JAX package here on purpose: the plane's 3x3
    normal equations are solved in float64 whatever the dtype, where the
    reference solves them in its working dtype.  In float64 both agree; in
    float32 the card keeps the matches the reference's float32 arithmetic
    drops, so a float32 card run is compared with a float32 reference run
    that computes this step differently."""
    near = d2[:, 4] < 1.0
    # solve A n = -1 (plane n·x + 1 = 0) via normal equations, in float64
    # whatever the dtype: squaring world coordinates makes the system too
    # ill-conditioned for float32, which then fails the fit test below on
    # 5% (VLP-16) to 12% (HDL-64) more neighbourhoods than float64 does
    nn64 = nn.to(torch.float64)
    eye = torch.eye(3, dtype=torch.float64, device=p_w.device)
    n = solve_sym3x3(_outer_sum(nn64) + 1e-9 * eye,
                     -torch.sum(nn64, dim=1)).to(p_w.dtype)
    norm_safe = torch.clamp(_norm(n), min=1e-12)
    pa = n / norm_safe[:, None]
    pd = 1.0 / norm_safe

    fit = torch.abs(_dot(nn, pa[:, None, :]) + pd[:, None])
    plane_ok = torch.all(fit <= 0.2, dim=1)

    pd2 = _dot(p_w, pa) + pd
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(
        torch.sqrt(torch.clamp(_norm(p_w), min=1e-12)))
    ok = q_valid & near & plane_ok & (s > 0.1)
    return pa * s[:, None], s * pd2, ok


def _gn_normal_eqs(q_pts, coeff, res, ok, q):
    """Stack [J_rot | J_t] rows into 6x6 normal equations: J_rot =
    -coeffᵀ R [p]x (right perturbation), J_t = coeff (LMOptimization,
    lidar_mapping_node.cpp:1523-1633 re-derived)."""
    R = so3.quat_to_mat(q)
    coeff = torch.where(ok[:, None], coeff, 0.0)
    res = torch.where(ok, res, 0.0)
    # Rp[n,i,k] = sum_j R[i,j] skew(p_n)[j,k]
    Rp = torch.sum(R[None, :, :, None] * so3.skew(q_pts)[:, None, :, :],
                   dim=2)
    J_rot = -torch.sum(coeff[:, :, None] * Rp, dim=1)
    J = torch.cat([J_rot, coeff], dim=-1)
    JtJ = torch.sum(J[:, :, None] * J[:, None, :], dim=0)
    Jtr = torch.sum(J * (-res)[:, None], dim=0)
    return JtJ, Jtr, torch.sum(ok)


def scan_to_map_grids(t0, q0, corner_pts, corner_valid, surf_pts, surf_valid,
                      corner_grid, surf_grid, n_corner_map, n_surf_map,
                      cfg: SlamConfig):
    """Full GN refinement loop (scan2MapOptimization,
    lidar_mapping_node.cpp:1635-1652) against prebuilt map hash grids.
    Returns (t, q, iters, n_matches, n_refresh) — n_refresh the number of
    in-loop re-gathers the staleness bounds forced.  Recorded as the span
    `mapper.scan_to_map` (`trips` issued, `live` = `iters`, `reads` the
    host reads of its stop and `read_ns` their wait), each trip's
    re-gather as `mapper.regather`."""
    with trace_scope("mapper.scan_to_map") as span:
        dtype, dev = t0.dtype, t0.device
        enough_map = (n_corner_map > 10) & (n_surf_map > 100)
        use_pallas = cfg.use_pallas_select
        C = cfg.s2m_cand
        Qc = corner_pts.shape[0]
        valid_all = torch.cat([corner_valid, surf_valid])

        def world(t, q):
            return (so3.quat_rotate(q[None, :], corner_pts) + t[None, :],
                    so3.quat_rotate(q[None, :], surf_pts) + t[None, :])

        def gather_all(t, q):
            pc, ps = world(t, q)
            cc, cc_ok, cc_d2C, cc_cov = gather_candidates(
                pc, corner_valid, corner_grid, C, use_pallas)
            sc, sc_ok, sc_d2C, sc_cov = gather_candidates(
                ps, surf_valid, surf_grid, C, use_pallas)
            return _Gather(pc, ps, cc, cc_ok, cc_d2C, cc_cov,
                           sc, sc_ok, sc_d2C, sc_cov)

        def rerank_both(pc, ps, G):
            """One 5-NN re-rank over the concatenated corner+surf caches."""
            nn, d2 = knn_from_candidates(torch.cat([pc, ps]), valid_all,
                                         torch.cat([G.cc, G.sc]),
                                         torch.cat([G.cc_ok, G.sc_ok]))
            return nn[:Qc], d2[:Qc], nn[Qc:], d2[Qc:]

        def stale(p_now, p_gat, valid, d2_5, d2C, cov):
            """True iff some query's cached top-5 may differ from brute force:
            a point outside the cache was >= min(cover, sqrt(d2C)) from the
            query at gather time, so the cache is exact for accepted matches
            while min(r5, 1) + (distance moved) <= that."""
            d = _norm(p_now - p_gat)
            safe = torch.minimum(cov, torch.sqrt(d2C))
            r5 = torch.clamp(torch.sqrt(d2_5), max=1.0)
            return torch.any(valid & (r5 + d > safe))

        t, q = t0, q0
        G = gather_all(t0, q0)
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        iters, n_sel_out, n_refresh = zero, zero, zero
        active = torch.ones((), dtype=torch.bool, device=dev)
        proj = eye6
        span.update(reads=0, read_ns=0)
        for it in range(cfg.scan2map_iters):
            if it:
                with host_read(span):
                    stop = may_stop(active)
                if stop:
                    break
            span["trips"] = it + 1
            pc, ps = world(t, q)
            nn_c, d2_c, nn_s, d2_s = rerank_both(pc, ps, G)
            need = (stale(pc, G.pc, corner_valid, d2_c[:, 4], G.cc_d2C,
                          G.cc_cov)
                    | stale(ps, G.ps, surf_valid, d2_s[:, 4], G.sc_d2C,
                            G.sc_cov))

            def refresh(t=t, q=q, pc=pc, ps=ps):
                G2 = gather_all(t, q)
                return (G2, *rerank_both(pc, ps, G2))

            # the cache of a frozen (converged) trip feeds nothing that is kept
            refreshed = need & active
            G, nn_c, d2_c, nn_s, d2_s = cond(refreshed, refresh,
                                             (G, nn_c, d2_c, nn_s, d2_s),
                                             "mapper.regather")
            cc, rc, okc = corner_residuals(pc, nn_c, d2_c, corner_valid)
            cs, rs, oks = surf_residuals(ps, nn_s, d2_s, surf_valid)
            H1, b1, n1 = _gn_normal_eqs(corner_pts, cc, rc, okc, q)
            H2, b2, n2 = _gn_normal_eqs(surf_pts, cs, rs, oks, q)
            H, b = H1 + H2, b1 + b2
            n_sel = (n1 + n2).to(torch.int32)
            enough = n_sel >= 50   # LMOptimization:1531-1533

            x = torch.linalg.solve_ex(H + 1e-9 * eye6, b)[0]
            if it == 0:
                # degeneracy projection from the first trip's H
                proj = spectral_projector(H, 100.0)
            x = torch.sum(proj * x[None, :], dim=1)

            q_new = so3.quat_normalize(so3.quat_mul(q, so3.exp_axis(x[0:3])))
            t_new = t + x[3:6]
            do = active & enough & enough_map
            delta_r = _norm(so3.rad2deg(x[0:3]))
            delta_t = _norm(100.0 * x[3:6])
            conv = do & (delta_r < 0.05) & (delta_t < 0.05)

            t = torch.where(do, t_new, t)
            q = torch.where(do, q_new, q)
            n_refresh = n_refresh + refreshed.to(torch.int32)
            n_sel_out = torch.where(active, n_sel, n_sel_out)
            iters = iters + active.to(torch.int32)
            active = active & ~conv
        span["live"] = iters
        return t, q, iters, n_sel_out, n_refresh


def scan_to_map(t0, q0, corner_pts, corner_valid, surf_pts, surf_valid,
                corner_map, corner_map_valid, surf_map, surf_map_valid,
                cfg: SlamConfig):
    """scan_to_map_grids with the grids built in-line from point maps (the
    one-shot path: tests, ad-hoc alignment)."""
    corner_grid = build_grid(corner_map, corner_map_valid, cell=1.2,
                             table=8192, cap=224)
    surf_grid = build_grid(surf_map, surf_map_valid, cell=1.2, table=16384,
                           cap=224)
    return scan_to_map_grids(
        t0, q0, corner_pts, corner_valid, surf_pts, surf_valid,
        corner_grid, surf_grid, torch.sum(corner_map_valid),
        torch.sum(surf_map_valid), cfg)
