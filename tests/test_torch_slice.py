"""Port parity for the whole first slice: odometry replay at VLP-16 size
(max_points=28800, use_pallas=True) in float64 on the CPU, lins_tpu_torch
against lins_tpu, 8 scans: 2 bootstrap, 2 streamed through add_scan, a
chunk of 4 through add_scan_chunk.  Positions within 1e-6 m, quaternions
within 1e-7, per-scan iters / n_surf / n_corner / diverged equal.  Replay
and the synthetic generator are in test_torch_replay.py."""
import numpy as np
import pytest
import torch

from lins_tpu.config import VLP16
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.mapping.mapper import imu_roll_pitch as j_imu_roll_pitch
from lins_tpu.odometry import LinsOdometry as JOdometry
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.mapping import mapper
from lins_tpu_torch.odometry import LinsOdometry as TOdometry
from lins_tpu_torch.slam import LinsSlam, imu_roll_pitch

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

JCFG = VLP16.replace(max_points=28800, use_pallas=True)
TCFG = SlamConfig.from_dict(JCFG.to_dict())
N_SCANS = 8


@pytest.fixture(scope="module")
def data():
    return jsyn.generate_sequence(JCFG, n_scans=N_SCANS, kind="gentle",
                                  speed=1.5)


def _drive(odo, data):
    """2 bootstrap scans and 2 streamed scans through add_scan, then the
    last 4 as one chunk."""
    imu_i = 0
    for k in range(N_SCANS):
        t_scan = data["scan_times"][k] + JCFG.scan_period
        while (imu_i < len(data["imu_times"])
               and data["imu_times"][imu_i] <= t_scan + 1e-9):
            odo.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                        data["imu_gyr"][imu_i])
            imu_i += 1
        if k < 4:
            odo.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
    ks = range(4, N_SCANS)
    odo.add_scan_chunk(
        np.asarray([data["scan_times"][k] + JCFG.scan_period for k in ks]),
        np.stack([data["scans_xyz"][k] for k in ks]),
        np.asarray([data["scans_n"][k] for k in ks]))
    return odo


@pytest.fixture(scope="module")
def runs(data):
    jodo = _drive(JOdometry(JCFG), data)
    todo = _drive(TOdometry(TCFG, dtype=torch.float64, device="cpu"), data)
    return jodo, todo


def test_trajectory(runs):
    jodo, todo = runs
    jt, jp, jq = jodo.trajectory_arrays()
    tt, tp, tq = todo.trajectory_arrays()
    assert len(tp) == N_SCANS - 1
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-7)
    assert np.linalg.norm(tp[-1] - tp[0]) > 0.5     # it moved


@pytest.mark.parametrize("key", ["iters", "n_surf", "n_corner", "diverged",
                                 "enough"])
def test_per_scan_metrics(runs, key):
    jodo, todo = runs
    assert len(todo.metrics) == len(jodo.metrics) == N_SCANS - 2
    want = [int(np.asarray(m[key])) for m in jodo.metrics]
    got = [int(m[key]) for m in todo.metrics]
    assert got == want


def test_final_filter_state(runs):
    jodo, todo = runs
    for f in jodo.filter_state._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(todo.filter_state, f)),
            np.asarray(getattr(jodo.filter_state, f)), rtol=0, atol=1e-6,
            err_msg=f)
    for key in ("xyz", "valid", "ring"):
        np.testing.assert_allclose(
            np.asarray(todo.last_surf[key]), np.asarray(jodo.last_surf[key]),
            rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("change,match", [
    ({}, "loop-closure attempts"),
    (dict(loop_closure_enabled=False), "radius"),
    (dict(lc_map_mode="radius"), "radius")])
def test_slam_loop_closure_waits_for_slice_3(change, match):
    """VLP16's defaults fire loop-closure attempts, which the port runs
    since slice 3; without loop closure (or with lc_map_mode="radius") the
    map is radius-selected, which the port runs too (no loop attempts with
    loop closure off)."""
    cfg = TCFG.replace(**change)
    slam = LinsSlam(cfg, device="cpu")
    assert slam.mapper._loops() == cfg.loop_closure_enabled, match
    assert mapper._radius_map(cfg) == (match == "radius")


def test_imu_roll_pitch_matches_reference():
    rng = np.random.default_rng(11)
    for acc in list(rng.normal(size=(8, 3)) * 3) + [np.asarray([0.1, 0.2,
                                                                0.0])]:
        np.testing.assert_array_equal(imu_roll_pitch(acc, 9.81),
                                      j_imu_roll_pitch(acc, 9.81))
