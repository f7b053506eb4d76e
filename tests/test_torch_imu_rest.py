"""Port parity for the rest of the IMU (lins_tpu/imu/eskf.py:106, 146 and
preintegration.py:100), lins_tpu_torch against lins_tpu in float64 on the
CPU:

  * `predict_step` on the hand-computed midpoint case of
    tests/test_imu.py:88-105 and on random states, every field within
    1e-12;
  * `propagate_sequential` on an analytic trajectory's IMU with padding,
    within 1e-12 of the reference's, and within 1e-9 of the port's own
    two-phase `propagate`;
  * `solve_gyro_bias` on tests/test_imu.py:154-166's biased IMU, within
    1e-12 of the reference's, and the bias recovered.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import VLP16
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.imu import eskf as jeskf
from lins_tpu.imu import preintegration as jpre
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.geom import so3 as tso3
from lins_tpu_torch.imu import eskf as teskf
from lins_tpu_torch.imu import preintegration as tpre

torch.set_num_threads(1)

JCFG = VLP16
TCFG = SlamConfig.from_dict(JCFG.to_dict())
TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _states(kw):
    """The same initial filter state in both packages."""
    return (jeskf.initial_state(JCFG, **kw),
            teskf.initial_state(TCFG, **kw, device="cpu"))


def _assert_state(got, want, tol=TOL):
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=tol, err_msg=f)


def test_predict_step_hand_case():
    kw = dict(vn=[1.0, 0, 0], acc=[0.2, 0, 9.81], gyr=[0, 0, 0.1])
    js, ts = _states(kw)
    dt, acc, gyr = 0.01, [0.3, 0.0, 9.81], [0.0, 0.0, 0.2]
    want = jeskf.predict_step(js, dt, jnp.asarray(acc), jnp.asarray(gyr),
                              jeskf.process_noise(JCFG))
    got = teskf.predict_step(ts, dt, _t(acc), _t(gyr),
                             teskf.process_noise(TCFG))
    _assert_state(got, want)
    # the hand-computed midpoint step (KalmanFilter.hpp:136-146)
    un_acc_0 = np.asarray([0.2, 0, 0.0])
    q_new = tso3.quat_mul(ts.qbn, tso3.exp_axis(_t([0, 0, 0.15]) * dt))
    un_acc_1 = tso3.quat_rotate(q_new, _t(acc)).numpy() + [0, 0, -9.81]
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    np.testing.assert_allclose(got.rn.numpy(),
                               [dt, 0, 0] + 0.5 * dt * dt * un_acc,
                               atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_step_random(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    kw = dict(rn=rng.normal(size=3), vn=rng.normal(size=3),
              qbn=q / np.linalg.norm(q), ba=rng.normal(size=3) * 0.05,
              bw=rng.normal(size=3) * 0.01, acc=rng.normal(size=3) + [0, 0,
                                                                     9.81],
              gyr=rng.normal(size=3) * 0.3)
    js, ts = _states(kw)
    P = rng.normal(size=(18, 18)) * 0.01
    P = P @ P.T
    js, ts = js._replace(P=jnp.asarray(P)), ts._replace(P=_t(P))
    acc, gyr = rng.normal(size=3) + [0, 0, 9.81], rng.normal(size=3) * 0.3
    want = jeskf.predict_step(js, 0.0025, jnp.asarray(acc), jnp.asarray(gyr),
                              jeskf.process_noise(JCFG))
    got = teskf.predict_step(ts, 0.0025, _t(acc), _t(gyr),
                             teskf.process_noise(TCFG))
    _assert_state(got, want)


def _imu(t1, **kw):
    pose_fn = jsyn.make_trajectory("gentle", speed=1.0)
    times, acc, gyr = jsyn.generate_imu(pose_fn, 0.0, t1, 400.0, **kw)
    return pose_fn, np.asarray(times), np.asarray(acc), np.asarray(gyr)


def test_propagate_sequential():
    """The reference's per-sample recursion over an analytic trajectory's
    IMU, the last 8 samples padding (no-ops)."""
    pose_fn, times, acc, gyr = _imu(0.25)
    p0, q0 = (np.array(x) for x in pose_fn(0.0))
    kw = dict(rn=p0, vn=[1.0, 0.2, 0.0], qbn=q0, acc=acc[0], gyr=gyr[0])
    js, ts = _states(kw)
    dts = np.diff(times)
    valid = np.ones(len(dts), bool)
    valid[-8:] = False
    args = (dts, acc[1:], gyr[1:])
    want = jeskf.propagate_sequential(js, *(jnp.asarray(a) for a in args),
                                      jnp.asarray(valid), JCFG)
    got = teskf.propagate_sequential(ts, *(_t(a) for a in args),
                                     torch.as_tensor(valid), TCFG)
    _assert_state(got, want)
    two_phase = teskf.propagate(ts, *(_t(a) for a in args),
                                torch.as_tensor(valid), TCFG)
    _assert_state(got, two_phase, tol=1e-9)
    assert float(torch.linalg.vector_norm(got.rn - ts.rn)) > 0.1


def test_solve_gyro_bias():
    """A biased gyro over 0.5 s against the true relative rotation: the
    port's correction equals the reference's and recovers the bias."""
    true_bw = np.asarray([0.01, -0.02, 0.015])
    pose_fn, times, acc, gyr = _imu(0.5, bw=true_bw)
    dts = np.diff(times)
    ones = np.ones(len(dts), bool)
    jp = jpre.preintegrate(
        jpre.init_preintegration(acc[0], gyr[0], [0, 0, 0], [0, 0, 0]),
        jnp.asarray(dts), jnp.asarray(acc[1:]), jnp.asarray(gyr[1:]),
        jnp.asarray(ones))
    tp = tpre.Preintegration(*(_t(np.asarray(x)) for x in jp))
    _, q0 = pose_fn(0.0)
    _, q1 = pose_fn(float(times[-1]))
    q_true = np.asarray(jsyn.so3.quat_mul(jsyn.so3.quat_inv(q0), q1))
    want = np.asarray(jpre.solve_gyro_bias(jp, jnp.asarray(q_true)))
    got = tpre.solve_gyro_bias(tp, _t(q_true)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, true_bw, atol=2e-3)
