"""VINS-Mono style IMU preintegration (port of
`lins_tpu/imu/preintegration.py`; reference integrationBase.h:32-216).

Used during the two-scan bootstrap: the relative-motion prior for the
initial ICP.  Keeps the 15x15 bias jacobian ([p v att ba bg] layout).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lins_tpu_torch.geom import so3
from lins_tpu_torch.utils.tree import tree_where


class Preintegration(NamedTuple):
    delta_p: torch.Tensor   # (3,)
    delta_q: torch.Tensor   # (4,) wxyz
    delta_v: torch.Tensor   # (3,)
    sum_dt: torch.Tensor    # scalar
    jacobian: torch.Tensor  # (15,15) d(delta)/d(bias) chain
    acc_0: torch.Tensor     # (3,) last accel sample
    gyr_0: torch.Tensor     # (3,) last gyro sample
    ba: torch.Tensor        # (3,) linearization point
    bw: torch.Tensor        # (3,)


def init_preintegration(acc0, gyr0, ba, bw, dtype=torch.float64,
                        device=None) -> Preintegration:
    def vec(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return Preintegration(
        delta_p=torch.zeros(3, dtype=dtype, device=device),
        delta_q=so3.quat_identity(dtype, device=device),
        delta_v=torch.zeros(3, dtype=dtype, device=device),
        sum_dt=torch.zeros((), dtype=dtype, device=device),
        jacobian=torch.eye(15, dtype=dtype, device=device),
        acc_0=vec(acc0), gyr_0=vec(gyr0), ba=vec(ba), bw=vec(bw))


def midpoint_step(pre: Preintegration, dt, acc1, gyr1) -> Preintegration:
    """One midpoint step (integrationBase.h:61-158), jacobian included."""
    dtype, dev = pre.delta_p.dtype, pre.delta_p.device
    un_acc_0 = so3.quat_rotate(pre.delta_q, pre.acc_0 - pre.ba)
    un_gyr = 0.5 * (pre.gyr_0 + gyr1) - pre.bw
    dq = so3.quat_normalize(so3.quat_mul(pre.delta_q,
                                         so3.delta_q(un_gyr * dt)))
    un_acc_1 = so3.quat_rotate(dq, acc1 - pre.ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    delta_p = pre.delta_p + pre.delta_v * dt + 0.5 * un_acc * dt * dt
    delta_v = pre.delta_v + un_acc * dt

    # bias jacobian (integrationBase.h:83-139): rows/cols [p v att ba bg]
    R0 = so3.quat_to_mat(pre.delta_q)
    R1 = so3.quat_to_mat(dq)
    Rw = so3.skew(un_gyr)
    Ra0 = so3.skew(pre.acc_0 - pre.ba)
    Ra1 = so3.skew(acc1 - pre.ba)
    I3 = torch.eye(3, dtype=dtype, device=dev)

    P, V, A, BA, BG = (slice(0, 3), slice(3, 6), slice(6, 9),
                       slice(9, 12), slice(12, 15))
    F = torch.zeros((15, 15), dtype=dtype, device=dev)
    F[P, P] = I3
    F[P, A] = (-0.25 * R0 @ Ra0 * dt * dt
               - 0.25 * R1 @ Ra1 @ (I3 - Rw * dt) * dt * dt)
    F[P, V] = I3 * dt
    F[P, BA] = -0.25 * (R0 + R1) * dt * dt
    F[P, BG] = 0.25 * R1 @ Ra1 * dt * dt * dt
    F[A, A] = I3 - Rw * dt
    F[A, BG] = -I3 * dt
    F[V, A] = (-0.5 * R0 @ Ra0 * dt
               - 0.5 * R1 @ Ra1 @ (I3 - Rw * dt) * dt)
    F[V, V] = I3
    F[V, BA] = -0.5 * (R0 + R1) * dt
    F[V, BG] = 0.5 * R1 @ Ra1 * dt * dt
    F[BA, BA] = I3
    F[BG, BG] = I3

    return pre._replace(
        delta_p=delta_p, delta_q=dq, delta_v=delta_v,
        sum_dt=pre.sum_dt + dt, jacobian=F @ pre.jacobian,
        acc_0=acc1, gyr_0=gyr1)


def preintegrate(pre: Preintegration, dts, accs, gyrs,
                 valid) -> Preintegration:
    """Integrate a padded IMU batch (invalid slots are no-ops)."""
    for k in range(dts.shape[0]):
        new = midpoint_step(pre, dts[k], accs[k], gyrs[k])
        pre = tree_where(valid[k], new, pre)
    return pre


def solve_gyro_bias(pre: Preintegration, q_meas: torch.Tensor) -> torch.Tensor:
    """Gyro-bias least-squares correction from one preintegrated interval
    against a measured relative rotation (solveGyroscopeBias,
    StateEstimator.hpp:1422-1445)."""
    A_blk = pre.jacobian[6:9, 12:15]
    resid = so3.quat_mul(so3.quat_inv(pre.delta_q), q_meas)
    b = 2.0 * resid[1:4]
    A = A_blk.T @ A_blk
    rhs = A_blk.T @ b
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A + 1e-12 * eye, rhs)
