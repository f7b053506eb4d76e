"""Error-state Kalman filter state + IMU propagation (port of
`lins_tpu/imu/eskf.py`; reference GlobalState/StatePredictor,
KalmanFilter.hpp:35-380).

The 18-dim error state layout matches the reference:
[pos 0:3, vel 3:6, att 6:9, ba 9:12, bw 12:15, grav 15:18].
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3
from lins_tpu_torch.utils.tree import tree_where

POS = slice(0, 3)
VEL = slice(3, 6)
ATT = slice(6, 9)
ACC = slice(9, 12)
GYR = slice(12, 15)
GRA = slice(15, 18)
DIM = 18
NOISE_DIM = 12


class FilterState(NamedTuple):
    """Nominal state + covariance + last IMU sample (StatePredictor members)."""

    rn: torch.Tensor    # (3,) position, n-frame
    vn: torch.Tensor    # (3,) velocity, n-frame
    qbn: torch.Tensor   # (4,) wxyz rotation b->n
    ba: torch.Tensor    # (3,) accel bias
    bw: torch.Tensor    # (3,) gyro bias
    gn: torch.Tensor    # (3,) gravity, n-frame
    P: torch.Tensor     # (18,18) error covariance
    time: torch.Tensor  # scalar
    acc_last: torch.Tensor  # (3,)
    gyr_last: torch.Tensor  # (3,)


def box_plus(s: FilterState, dx: torch.Tensor) -> FilterState:
    """State ⊞ error vector (KalmanFilter.hpp:71-81)."""
    dq = so3.exp_axis(dx[ATT])
    return s._replace(
        rn=s.rn + dx[POS], vn=s.vn + dx[VEL],
        qbn=so3.quat_normalize(so3.quat_mul(s.qbn, dq)),
        ba=s.ba + dx[ACC], bw=s.bw + dx[GYR], gn=s.gn + dx[GRA])


def box_minus(s: FilterState, s0: FilterState) -> torch.Tensor:
    """State ⊟ state (KalmanFilter.hpp:84-94)."""
    da = so3.log_quat(so3.quat_mul(so3.quat_inv(s0.qbn), s.qbn))
    return torch.cat([
        s.rn - s0.rn, s.vn - s0.vn, da, s.ba - s0.ba, s.bw - s0.bw,
        s.gn - s0.gn])


def _diag_sq(values, dtype, device):
    # device fills, not a host-built tensor: reset_relative runs every scan,
    # and a host->device copy waits for the stream
    return torch.stack([torch.full((), float(v) ** 2, dtype=dtype,
                                   device=device) for v in values])


def init_covariance(cfg: SlamConfig, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """P0 from config stds (KalmanFilter.hpp:247-283, type 0)."""
    att = tuple(math.radians(x) for x in cfg.init_att_std)
    diag = torch.cat([
        _diag_sq(cfg.init_pos_std, dtype, device),
        _diag_sq(cfg.init_vel_std, dtype, device),
        _diag_sq(att, dtype, device),
        _diag_sq(cfg.init_acc_std, dtype, device),
        _diag_sq(cfg.init_gyr_std, dtype, device),
        torch.full((3,), 0.01, dtype=dtype, device=device),
    ])
    return torch.diag(diag)


def process_noise(cfg: SlamConfig, dtype=torch.float64,
                  device=None) -> torch.Tensor:
    """Continuous noise diag [acc_n, gyr_n, acc_w, gyr_w]
    (KalmanFilter.hpp:307-311)."""
    return torch.diag(torch.cat([
        torch.full((3,), cfg.acc_noise, dtype=dtype, device=device),
        torch.full((3,), cfg.gyr_noise, dtype=dtype, device=device),
        torch.full((3,), cfg.acc_walk, dtype=dtype, device=device),
        torch.full((3,), cfg.gyr_walk, dtype=dtype, device=device),
    ]))


def _vec(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def initial_state(cfg: SlamConfig, time=0.0, rn=None, vn=None, qbn=None,
                  ba=None, bw=None, acc=None, gyr=None,
                  dtype=torch.float64, device=None) -> FilterState:
    """StatePredictor::initialization (KalmanFilter.hpp:211-222)."""
    z3 = torch.zeros(3, dtype=dtype, device=device)
    return FilterState(
        rn=z3 if rn is None else _vec(rn, dtype, device),
        vn=z3 if vn is None else _vec(vn, dtype, device),
        qbn=(so3.quat_identity(dtype, device=device) if qbn is None
             else _vec(qbn, dtype, device)),
        ba=z3 if ba is None else _vec(ba, dtype, device),
        bw=z3 if bw is None else _vec(bw, dtype, device),
        gn=torch.stack([z3[0], z3[0], z3[0] - cfg.gravity]),
        P=init_covariance(cfg, dtype, device),
        time=_vec(time, dtype, device),
        acc_last=z3 if acc is None else _vec(acc, dtype, device),
        gyr_last=z3 if gyr is None else _vec(gyr, dtype, device),
    )


def predict_step(s: FilterState, dt, acc, gyr, Q: torch.Tensor) -> FilterState:
    """One IMU sample: midpoint state integration + covariance propagation
    (StatePredictor::predict, KalmanFilter.hpp:125-186)."""
    dtype, dev = s.rn.dtype, s.rn.device
    un_acc_0 = so3.quat_rotate(s.qbn, s.acc_last - s.ba) + s.gn
    un_gyr = 0.5 * (s.gyr_last + gyr) - s.bw
    q_new = so3.quat_normalize(so3.quat_mul(s.qbn, so3.exp_axis(un_gyr * dt)))
    un_acc_1 = so3.quat_rotate(q_new, acc - s.ba) + s.gn
    un_acc = 0.5 * (un_acc_0 + un_acc_1)

    rn = s.rn + dt * s.vn + 0.5 * dt * dt * un_acc
    vn = s.vn + dt * un_acc

    R_new = so3.quat_to_mat(q_new)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    Ft = torch.zeros((DIM, DIM), dtype=dtype, device=dev)
    Ft[POS, VEL] = I3
    Ft[VEL, ATT] = -R_new @ so3.skew(acc - s.ba)
    Ft[VEL, ACC] = -R_new
    Ft[VEL, GRA] = I3
    Ft[ATT, ATT] = -so3.skew(gyr - s.bw)
    Ft[ATT, GYR] = -I3

    Gt = torch.zeros((DIM, NOISE_DIM), dtype=dtype, device=dev)
    Gt[VEL, 0:3] = -R_new
    Gt[ATT, 3:6] = -I3
    Gt[ACC, 6:9] = I3
    Gt[GYR, 9:12] = I3
    Gt = Gt * dt

    I = torch.eye(DIM, dtype=dtype, device=dev)
    F = I + Ft * dt + 0.5 * (Ft @ Ft) * dt * dt
    P = F @ s.P @ F.T + Gt @ Q @ Gt.T
    P = 0.5 * (P + P.T)
    return s._replace(rn=rn, vn=vn, qbn=q_new, P=P, time=s.time + dt,
                      acc_last=acc, gyr_last=gyr)


def propagate_sequential(s: FilterState, dts, accs, gyrs, valid,
                         cfg: SlamConfig) -> FilterState:
    """The reference's own recursion: `predict_step` sample by sample, an
    invalid sample a no-op (the parity form; the path runs `propagate`)."""
    Q = process_noise(cfg, s.rn.dtype, s.rn.device)
    for k in range(dts.shape[0]):
        s = tree_where(valid[k], predict_step(s, dts[k], accs[k], gyrs[k], Q),
                       s)
    return s


def _prefix_quat_product(q):
    """Inclusive prefix products q0 ⊗ q1 ⊗ ... ⊗ qi along axis 0
    (Hillis-Steele: log2(K) batched steps)."""
    K = q.shape[0]
    d = 1
    while d < K:
        q = torch.cat([q[:d], so3.quat_mul(q[:-d], q[d:])])
        d *= 2
    return q


def _compose_affine(F, Qk):
    """Compose the affine covariance maps P -> F_k P F_kᵀ + Q_k, k = 0..K-1
    (applied in order) into one (A, B) by pairwise tree reduction:
    (A2,B2)∘(A1,B1) = (A2 A1, A2 B1 A2ᵀ + B2)."""
    A, B = F, Qk
    while A.shape[0] > 1:
        if A.shape[0] % 2:
            eye = torch.eye(DIM, dtype=A.dtype, device=A.device)[None]
            A = torch.cat([A, eye])
            B = torch.cat([B, torch.zeros_like(B[:1])])
        A1, A2 = A[0::2], A[1::2]
        B1, B2 = B[0::2], B[1::2]
        A = A2 @ A1
        B = A2 @ B1 @ A2.transpose(-1, -2) + B2
    return A[0], B[0]


def propagate(s: FilterState, dts, accs, gyrs, valid, cfg: SlamConfig):
    """Propagate through a padded IMU batch (invalid slots are no-ops).

    The nominal state is integrated in parallel: the orientation trajectory
    is a prefix quaternion product, velocity and position prefix sums.  The
    covariance recursion P -> F P Fᵀ + Q is affine and associative under
    composition, so the K per-step maps collapse by a log2(K)-level tree of
    batched 18x18 products.  Equivalent to the reference recursion
    (KalmanFilter.hpp:125-186) up to dropping the per-step symmetrization
    (applied once at the end), as in the reference package.
    """
    dtype, dev = s.rn.dtype, s.rn.device
    Q = process_noise(cfg, dtype, dev)
    K = dts.shape[0]
    vcol = valid[:, None]

    dts_m = torch.where(valid, dts, 0.0)
    gyr_prev = torch.cat([s.gyr_last[None, :], gyrs[:-1]])
    un_gyr = 0.5 * (gyr_prev + gyrs) - s.bw[None, :]
    dq = so3.exp_axis(un_gyr * dts_m[:, None])
    dq = torch.where(vcol, dq, so3.quat_identity(dtype, device=dev)[None, :])
    q_traj = _prefix_quat_product(torch.cat([s.qbn[None], dq]))[1:]
    q_traj = so3.quat_normalize(q_traj)

    q_prev = torch.cat([s.qbn[None], q_traj[:-1]])
    acc_prev = torch.cat([s.acc_last[None, :], accs[:-1]])
    un_acc0 = so3.quat_rotate(q_prev, acc_prev - s.ba[None, :]) + s.gn[None, :]
    un_acc1 = so3.quat_rotate(q_traj, accs - s.ba[None, :]) + s.gn[None, :]
    un_acc = 0.5 * (un_acc0 + un_acc1)
    un_acc = torch.where(vcol, un_acc, 0.0)

    dv = dts_m[:, None] * un_acc
    vn_traj = s.vn[None, :] + torch.cumsum(dv, dim=0)
    vn_prev = torch.cat([s.vn[None], vn_traj[:-1]])
    dr = dts_m[:, None] * vn_prev + 0.5 * (dts_m ** 2)[:, None] * un_acc
    rn_final = s.rn + torch.sum(dr, dim=0)

    # last *valid* measurement becomes acc_last/gyr_last
    any_valid = torch.any(valid)
    last_i = torch.where(
        any_valid, K - 1 - torch.argmax(torch.flip(valid, [0]).to(torch.int8)),
        0).reshape(1)
    s_out = s._replace(
        rn=rn_final, vn=vn_traj[-1],
        qbn=torch.where(any_valid, q_traj[-1], s.qbn),
        time=s.time + torch.sum(dts_m),
        acc_last=torch.where(any_valid, torch.index_select(accs, 0, last_i)[0],
                             s.acc_last),
        gyr_last=torch.where(any_valid, torch.index_select(gyrs, 0, last_i)[0],
                             s.gyr_last))

    # batched F_k, Q_k from the per-step linearization points
    I3 = torch.eye(3, dtype=dtype, device=dev)
    R_new = so3.quat_to_mat(q_traj)
    dt3 = dts[:, None, None]
    Ft = torch.zeros((K, DIM, DIM), dtype=dtype, device=dev)
    Ft[:, POS, VEL] = I3
    Ft[:, VEL, ATT] = -R_new @ so3.skew(accs - s.ba[None, :])
    Ft[:, VEL, ACC] = -R_new
    Ft[:, VEL, GRA] = I3
    Ft[:, ATT, ATT] = -so3.skew(gyrs - s.bw[None, :])
    Ft[:, ATT, GYR] = -I3
    Gt = torch.zeros((K, DIM, NOISE_DIM), dtype=dtype, device=dev)
    Gt[:, VEL, 0:3] = -R_new
    Gt[:, ATT, 3:6] = -I3
    Gt[:, ACC, 6:9] = I3
    Gt[:, GYR, 9:12] = I3
    Gt = Gt * dt3
    I = torch.eye(DIM, dtype=dtype, device=dev)
    F = I + Ft * dt3 + 0.5 * (Ft @ Ft) * dt3 * dt3
    Qk = Gt @ Q @ Gt.transpose(-1, -2)
    ok3 = valid[:, None, None]
    F = torch.where(ok3, F, I)
    Qk = torch.where(ok3, Qk, 0.0)

    A_f, B_f = _compose_affine(F, Qk)
    P = A_f @ s.P @ A_f.T + B_f
    P = 0.5 * (P + P.T)
    return s_out._replace(P=P)


def reset_relative(s: FilterState, cfg: SlamConfig) -> FilterState:
    """StatePredictor::reset(1) — the robocentric re-anchoring after each
    scan (KalmanFilter.hpp:320-353): rotate velocity/gravity covariance into
    the new body frame, re-zero relative pose, renormalize gravity to |g|."""
    dtype, dev = s.rn.dtype, s.rn.device
    R = so3.quat_to_mat(s.qbn)
    att_std = tuple(math.radians(x) for x in cfg.init_att_std)

    vel_cov = R.T @ s.P[VEL, VEL] @ R
    gra_cov = R.T @ s.P[GRA, GRA] @ R

    P = torch.zeros((DIM, DIM), dtype=dtype, device=dev)
    P[POS, POS] = torch.diag(_diag_sq(cfg.init_pos_std, dtype, dev))
    P[VEL, VEL] = vel_cov
    P[ATT, ATT] = torch.diag(_diag_sq(att_std, dtype, dev))
    P[ACC, ACC] = s.P[ACC, ACC]
    P[GYR, GYR] = s.P[GYR, GYR]
    P[GRA, GRA] = gra_cov

    vn = so3.quat_rotate_inv(s.qbn, s.vn)
    gn = so3.quat_rotate_inv(s.qbn, s.gn)
    gn = gn * cfg.gravity / torch.clamp(torch.linalg.vector_norm(gn),
                                        min=1e-9)
    return s._replace(rn=torch.zeros(3, dtype=dtype, device=dev), vn=vn,
                      qbn=so3.quat_identity(dtype, device=dev), gn=gn, P=P)


def calculate_rp_from_gravity(f_b: torch.Tensor, gravity: float):
    """Roll/pitch from a body-frame specific-force/gravity vector
    (StateEstimator.hpp:602-605)."""
    sign_z = torch.sign(f_b[2])
    sign_z = torch.where(sign_z == 0, 1.0, sign_z)
    pitch = -sign_z * torch.arcsin(torch.clamp(f_b[0] / gravity, -1.0, 1.0))
    roll = sign_z * torch.arcsin(torch.clamp(f_b[1] / gravity, -1.0, 1.0))
    return roll, pitch
