"""Scan-to-scan Gauss-Newton ICP (port of `lins_tpu/odometry/gn_icp.py`;
reference StateEstimator.hpp:1163-1320).

Used for the second-scan bootstrap and as the IESKF divergence fallback.
6-DOF [rot(rpy), pos] GN over the stacked point-to-line/plane rows, with the
LOAM degeneracy projection (directions of JᵀJ with eigenvalue < 10 nulled)
and the reference's convergence thresholds (0.1 deg / 0.1 cm).  The loop
stops as the reference's does: the host reads `active` before each trip
after the first, on every device, as the IESKF does (odometry/ieskf.py);
the carry stays frozen on the device where `active` is false.
"""
from __future__ import annotations

import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3
from lins_tpu_torch.ops import assoc
from lins_tpu_torch.utils.metrics import trace_scope

# Newton steps of the matrix sign iteration in `spectral_projector`: each
# halves an eigenvalue's distance from ±1 while it is far from it, then
# converges quadratically, so 64 steps settle |λ - thresh| anywhere in
# [1e-12, 1e12].
_SIGN_STEPS = 64


def read_active(active: torch.Tensor) -> bool:
    """`active` on the host: one copy, which waits for the trip that set
    it."""
    return bool(active)


def spectral_projector(A, thresh: float):
    """V diag(w >= thresh) Vᵀ for a symmetric A = V diag(w) Vᵀ.

    The reference package takes it from `eigh`; `torch.linalg.eigh` reads
    its status on the host, so this takes the matrix sign of A - thresh·I by
    the Newton iteration X <- (X + X⁻¹)/2 instead, which stays on the device.
    The two agree to rounding wherever no eigenvalue sits at the threshold.
    """
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    X = A - thresh * eye
    for _ in range(_SIGN_STEPS):
        X = 0.5 * (X + torch.linalg.inv_ex(X)[0])
        X = 0.5 * (X + X.T)
    return 0.5 * (eye + X)


def gn_step(rn, qbn, JtJ, Jtb, iter_count: int, proj):
    """One GN iteration from the trip's normal equations (JtJ, Jtb), J6's
    rows [J_rot, coeff] and b = -0.05·s·res as K4 and K5 form them
    ("gn" rows).  Returns (rn, qbn, converged, proj)."""
    eye6 = torch.eye(6, dtype=JtJ.dtype, device=JtJ.device)
    x = torch.linalg.solve_ex(JtJ + 1e-12 * eye6, Jtb)[0]

    # degeneracy projection, built on the first iteration
    # (StateEstimator.hpp:1266-1302)
    if iter_count == 0:
        proj = spectral_projector(JtJ, 10.0)
    x = proj @ x

    dq = so3.rpy_to_quat(x[0:3])
    qbn_new = so3.quat_normalize(so3.quat_mul(qbn, dq))
    rn_new = rn + x[3:6]

    delta_r = torch.linalg.vector_norm(so3.rad2deg(x[0:3]))
    delta_t = torch.linalg.vector_norm(100.0 * x[3:6])
    converged = (delta_r < 0.1) & (delta_t < 0.1)
    return rn_new, qbn_new, converged, proj


def estimate_transform(rn0, qbn0, new_flat, new_sharp, last_surf, last_corner,
                       cfg: SlamConfig, refs=None):
    """Full GN ICP loop (estimateTransform, StateEstimator.hpp:1163-1196).

    Iterates association + GN step up to num_iter times; skips the solve when
    matches are insufficient (<10 surf or <5 corner), like the reference.
    Each trip's (JtJ, Jtb) and match counts come from K4 and K5
    (`ops/assoc.scan_normal_equations`, "gn" rows).  `refs`: the reference
    sets as `ops/assoc.reference_sets` made them, when the caller has.
    Returns (rn, qbn, iters).  Recorded as the span `odometry.gn_icp`:
    `trips` issued, `live` = `iters`, `reads` the host reads.
    """
    with trace_scope("odometry.gn_icp") as span:
        dtype, dev = rn0.dtype, rn0.device
        flat, sharp = assoc.queries(new_flat, dtype), assoc.queries(new_sharp,
                                                                     dtype)
        if refs is None:
            refs = assoc.reference_sets(last_surf, last_corner, dtype)
        rn, qbn = rn0, qbn0
        proj = torch.eye(6, dtype=dtype, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        span["trips"] = span["reads"] = 0

        for it in range(cfg.num_iter):
            if it:
                span["reads"] += 1
                if not read_active(active):
                    break
            span["trips"] = it + 1
            (JtJ_s, Jtb_s, _, n_s), (JtJ_c, Jtb_c, _, n_c) = (
                assoc.scan_normal_equations(flat, sharp, *refs, rn, qbn, it,
                                            cfg, "gn"))
            enough = (n_s >= 10) & (n_c >= 5)
            rn_n, qbn_n, conv_n, proj_n = gn_step(
                rn, qbn, JtJ_s + JtJ_c, Jtb_s + Jtb_c, it, proj)
            step = active & enough
            rn = torch.where(step, rn_n, rn)
            qbn = torch.where(step, qbn_n, qbn)
            proj = torch.where(step, proj_n, proj)
            iters = iters + active.to(torch.int32)
            active = active & ~(conv_n & enough)
        span["live"] = iters
        return rn, qbn, iters
