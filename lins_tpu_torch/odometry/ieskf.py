"""Iterated error-state Kalman filter update (port of
`lins_tpu/odometry/ieskf.py`; reference StateEstimator.hpp:465-600).

Information form, as in the reference package: since only the att/pos
columns of H are nonzero and R = σ²I,

    K (r + Hδ) = (P⁻¹ + HᵀH/σ²)⁻¹ Hᵀ(r + Hδ)/σ²

so every per-iteration solve is 18×18.  The reference's `while_loop` (up to
num_iter iterations, stopping on convergence ‖Δ‖ ≤ 1e-2 or divergence)
stops here as it does: the host reads the trip's flags before each later
trip, on every device, and issues no trip once the filter has converged or
diverged.  A read costs a round trip of tens of µs on the card, a trip
milliseconds of host issue.  The carry is still frozen on the device where
`active` is false, so a loop made to run all num_iter trips (as the tests
force it) gives the same result, bit for bit.  `iters` counts the active
trips.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.imu import eskf
from lins_tpu_torch.ops import assoc
from lins_tpu_torch.utils.metrics import trace_scope
from lins_tpu_torch.utils.tree import tree_where


class IESKFResult(NamedTuple):
    state: eskf.FilterState     # updated filter state (post covariance update)
    diverged: torch.Tensor      # bool — caller should run the GN fallback
    iters: torch.Tensor         # iterations executed
    n_surf: torch.Tensor        # matched surf rows (last iteration)
    n_corner: torch.Tensor      # matched corner rows (last iteration)
    residual_norm: torch.Tensor
    diverged_read: bool         # `diverged` as the loop's last read gave it


def read_flags(active: torch.Tensor, div: torch.Tensor) -> tuple[bool, bool]:
    """(active, diverged) on the host: one copy of both flags, which waits
    for the trip that set them."""
    return tuple(torch.stack((active, div)).tolist())


def _embed6(J66):
    """Embed a 6x6 [att,pos] block into the 18x18 error-state layout."""
    H = J66.new_zeros((eskf.DIM, eskf.DIM))
    H[eskf.ATT, eskf.ATT] = J66[0:3, 0:3]
    H[eskf.ATT, eskf.POS] = J66[0:3, 3:6]
    H[eskf.POS, eskf.ATT] = J66[3:6, 0:3]
    H[eskf.POS, eskf.POS] = J66[3:6, 3:6]
    return H


def _embed6v(v6):
    v = v6.new_zeros((eskf.DIM,))
    v[eskf.ATT] = v6[0:3]
    v[eskf.POS] = v6[3:6]
    return v


def _spd_inverse(A, jitter_scale):
    """Cholesky inverse with relative jitter (P can be near-singular right
    after the robocentric reset when init stds are zero).  A failed
    factorisation gives NaNs, as in the reference package, and no host
    read (cholesky_ex does not check its status)."""
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    jitter = jitter_scale * (torch.trace(A) / n) + 1e-16
    L, info = torch.linalg.cholesky_ex(A + jitter * eye)
    L = torch.where(info == 0, L, torch.nan)
    return torch.cholesky_solve(eye, L)


def update(filter_state: eskf.FilterState,
           new_flat, new_sharp, last_surf, last_corner,
           cfg: SlamConfig, refs=None) -> IESKFResult:
    """Run the iterated update against the previous scan's feature sets.

    new_flat/new_sharp: FeatureClouds of the current scan (query sets).
    last_surf/last_corner: dicts with xyz (R,3), ring (R,), valid (R,) — the
    previous scan's less-flat / less-sharp sets in its end frame.  `refs`:
    the two as `ops/assoc.reference_sets` made them, when the caller has.

    Each trip's normal equations come from K4 and K5
    (`ops/assoc.scan_normal_equations`, "ieskf" rows): JtJ and Jtr are the
    sums of the surf and corner blocks and the residual norm is
    sqrt(Σr²_surf + Σr²_corner), as `_blocks_xla` of the reference package
    forms them.  Before each trip after the first, and once after the
    last if none stopped the loop, the host reads `active` and `diverged`
    together (`read_flags`), so the caller decides the fallback with no
    read of its own.  Recorded as the span `odometry.ieskf`: `trips`
    issued, `live` = `iters`, `reads` the host reads.
    """
    with trace_scope("odometry.ieskf") as span:
        dtype, dev = filter_state.rn.dtype, filter_state.rn.device
        flat, sharp = assoc.queries(new_flat, dtype), assoc.queries(new_sharp,
                                                                     dtype)
        if refs is None:
            refs = assoc.reference_sets(last_surf, last_corner, dtype)
        Pk = filter_state.P
        # a product with 1/σ², as XLA folds the reference's division by σ²
        inv_sigma2 = 1.0 / cfg.lidar_std ** 2
        jit_scale = 1e-9 if dtype == torch.float64 else 1e-6
        P_inv = _spd_inverse(Pk, jit_scale)
        nominal0 = filter_state

        def scalar(v, dt):
            return torch.full((), v, dtype=dt, device=dev)

        lin = nominal0
        res_prev = scalar(1e6, dtype)
        HtH_s = torch.zeros((eskf.DIM, eskf.DIM), dtype=dtype, device=dev)
        A_inv = torch.zeros_like(HtH_s)
        div = scalar(False, torch.bool)
        iters = scalar(0, torch.int32)
        ns = nc = scalar(0, torch.int32)
        res_norm_out = scalar(0.0, dtype)
        active = scalar(True, torch.bool)
        span["trips"] = span["reads"] = 0

        for it in range(cfg.num_iter):
            if it:
                span["reads"] += 1
                going, diverged = read_flags(active, div)
                if not going:
                    break
            span["trips"] = it + 1
            (JtJ_s, Jtr_s, rsq_s, ns_new), (JtJ_c, Jtr_c, rsq_c, nc_new) = (
                assoc.scan_normal_equations(flat, sharp, *refs, lin.rn, lin.qbn,
                                            it, cfg, "ieskf"))
            JtJ, Jtr = JtJ_s + JtJ_c, Jtr_s + Jtr_c
            res_norm = torch.sqrt(rsq_s + rsq_c)
            HtH_s_new = _embed6(JtJ) * inv_sigma2
            Htr_s = _embed6v(Jtr) * inv_sigma2

            A = P_inv + HtH_s_new
            A_inv_new = _spd_inverse(A, jit_scale * 1e-3)

            delta = eskf.box_minus(nominal0, lin)
            upd = -(A_inv_new @ (Htr_s + HtH_s_new @ delta)) + delta

            has_nan = torch.any(torch.isnan(upd))
            div_new = has_nan | (res_norm > res_prev * 10.0)
            upd = torch.nan_to_num(upd)
            # on divergence the reference breaks *before* applying the update
            lin_new = tree_where(div_new, lin, eskf.box_plus(lin, upd))
            conv_new = torch.linalg.vector_norm(upd) <= 1e-2

            # a diverged iteration keeps the previous blocks; a frozen trip
            # (converged or diverged before it) changes nothing
            keep = div_new | ~active
            HtH_s = torch.where(keep, HtH_s, HtH_s_new)
            A_inv = torch.where(keep, A_inv, A_inv_new)
            res_prev = torch.where(keep, res_prev, res_norm)
            lin = tree_where(active, lin_new, lin)
            div = div | (active & div_new)
            ns = torch.where(active, ns_new, ns)
            nc = torch.where(active, nc_new, nc)
            res_norm_out = torch.where(active, res_norm, res_norm_out)
            iters = iters + active.to(torch.int32)
            active = active & ~conv_new & ~div_new
        else:
            span["reads"] += 1
            diverged = read_flags(active, div)[1]
        span["live"] = iters

        # Joseph-form covariance update once at the end
        # (StateEstimator.hpp:595-598)
        KH = A_inv @ HtH_s
        IKH = torch.eye(eskf.DIM, dtype=dtype, device=dev) - KH
        KRK = A_inv @ HtH_s @ A_inv.T
        P_new = IKH @ Pk @ IKH.T + KRK
        P_new = 0.5 * (P_new + P_new.T)

        updated = lin._replace(P=P_new, time=filter_state.time,
                               acc_last=filter_state.acc_last,
                               gyr_last=filter_state.gyr_last)
        # diverged: caller substitutes the GN fallback pose; keep Pk unchanged
        out_state = tree_where(div, filter_state, updated)
        return IESKFResult(state=out_state, diverged=div, iters=iters,
                           n_surf=ns, n_corner=nc, residual_norm=res_norm_out,
                           diverged_read=diverged)
