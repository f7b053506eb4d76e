"""Port parity for the third slice end to end: the mapping backend with
loop closure and the pose graph over the TINY revisiting replay of
tests/test_slam_integration.py (the circuit that closes loops), in float64
on the CPU, lins_tpu_torch against lins_tpu.

Both mappers take the same inputs: the port's odometry poses and feature
clouds of every scan (the odometry's own parity is
tests/test_torch_slice.py's), each with its IMU roll/pitch.  The reference
maps the first scans alone (their mapping steps are held to the reference
in tests/test_torch_mapping.py); a few scans before the first loop
candidate both packages take over its state, and from there they run the
same scans: the reference streaming (`process`, `maybe_close_loop`, then
the fused pose), the port streaming and chunked (`plan_chunk` +
`process_chunk`, the replay driver).  Checked: every loop attempt's found
/ accepted / applied / matched id equal, the loop count and the edge
count, the fused positions, and the final state.

Why the hand-over: over the whole replay the two packages part by
millimetres before any loop is found, though their inputs are the same.
Voxel sums and centroids differ in their last bits (XLA's cumulative sums
associate differently, ROADMAP.md Queue 3), a 5-NN selection that nearly
ties flips on such a bit, and each flip moves a mapping step by a few
micrometres, which the later steps carry on.  At a loop attempt that is
enough to move the implied correction across the solve threshold.

Cut to fit the CPU: 84 scans (three loop attempts find a candidate, the
third is accepted and solved), half the integration test's cloud and map
capacities, `loop_icp_iters` 12 and a 256-point current cloud (the
reference's ICP sorts an 8192-wide row per cloud point on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.mapping import mapper as jmapper
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.mapping import mapper as tmapper
from lins_tpu_torch.odometry import LinsOdometry as TOdometry
from lins_tpu_torch.slam import imu_roll_pitch

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

JCFG = TINY.replace(loop_time_gate=4.0, loop_icp_iters=12)
TCFG = SlamConfig.from_dict(JCFG.to_dict())
N_SCANS = 84
HANDOVER = 58          # input rows the port maps alone (scans 1-58)
CHUNK = 12
MAP_KW = dict(corner_cap=128, surf_cap=512, map_corner_cap=2048,
              map_surf_cap=4096, submap_cap=2048, cloud_cap=256)
POS_TOL = 1e-6


@pytest.fixture(scope="module")
def inputs():
    """Per scan after the first: (time, odometry pos, quat, the six cloud
    arrays, IMU roll/pitch) from the port's odometry streaming over the
    sequence, as numpy."""
    data = jsyn.generate_sequence(
        JCFG, n_scans=N_SCANS, kind="loop", speed=2.2, loop_scale=0.32,
        acc_noise=0.02, gyr_noise=0.002, ba=(0.05, -0.03, 0.02),
        bw=(0.002, -0.001, 0.0015))
    odo = TOdometry(TCFG, dtype=torch.float64, device="cpu")
    rows, imu_i = [], 0
    for k in range(N_SCANS):
        t = float(data["scan_times"][k]) + JCFG.scan_period
        while (imu_i < len(data["imu_times"])
               and data["imu_times"][imu_i] <= t + 1e-9):
            odo.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                        data["imu_gyr"][imu_i])
            imu_i += 1
        out = odo.add_scan(t, data["scans_xyz"][k], data["scans_n"][k])
        if out is None:
            continue
        clouds = [np.array(c[key]) for c in (odo.last_corner, odo.last_surf,
                                             odo.last_outlier)
                  for key in ("xyz", "valid")]
        imu = odo._last_imu
        rp = (imu_roll_pitch(imu[0], JCFG.gravity) if imu is not None
              else np.full(2, np.nan))
        rows.append((t, np.array(out[0], np.float64),
                     np.array(out[1], np.float64), clouds, rp))
    return rows


def _tfeed(m, row):
    t, pos, quat, clouds, rp = row
    pos, quat = torch.as_tensor(pos), torch.as_tensor(quat)
    m.process(t, pos, quat, *(torch.as_tensor(c) for c in clouds), imu_rp=rp)
    m.maybe_close_loop(t)
    return tmapper.warm_start(m.state, pos, quat)[0].numpy()


@pytest.fixture(scope="module")
def handover(inputs):
    """The port's mapper over the rows before the hand-over: its state,
    cadence and loop attempts there."""
    m = tmapper.LinsMapper(TCFG, dtype=torch.float64, device="cpu", **MAP_KW)
    for row in inputs[:HANDOVER]:
        _tfeed(m, row)
    return m.state, m.last_time, m.last_loop_time, _attempts(m)


def _to_reference(state, template):
    """A port MapperState as the reference's, leaf for leaf (both flatten
    their NamedTuples and voxel-map dataclasses in field order)."""
    leaves = [a for _, a in _leaves(state)]
    want = jax.tree_util.tree_leaves(template)
    assert len(leaves) == len(want)
    for a, w in zip(leaves, want):
        assert a.shape == w.shape
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(a, w.dtype) for a, w in zip(leaves, want)])


@pytest.fixture(scope="module")
def reference(inputs, handover):
    state, last_time, last_loop_time, _ = handover
    m = jmapper.LinsMapper(JCFG, dtype=jnp.float64, **MAP_KW)
    m.state = _to_reference(state, m.state)
    m.last_time, m.last_loop_time = last_time, last_loop_time
    fused = []
    for t, pos, quat, clouds, rp in inputs[HANDOVER:]:
        pos, quat = jnp.asarray(pos), jnp.asarray(quat)
        m.process(t, pos, quat, *(jnp.asarray(c) for c in clouds), imu_rp=rp)
        m.maybe_close_loop(t)
        fused.append(np.asarray(jmapper.warm_start(m.state, pos, quat)[0]))
    return m, np.stack(fused)


def _tmapper(handover):
    state, last_time, last_loop_time, _ = handover
    m = tmapper.LinsMapper(TCFG, dtype=torch.float64, device="cpu", **MAP_KW)
    m.load_numpy_state(state, last_time=last_time)
    m.last_loop_time = last_loop_time
    return m


@pytest.fixture(scope="module")
def streamed(inputs, handover):
    m = _tmapper(handover)
    return m, np.stack([_tfeed(m, row) for row in inputs[HANDOVER:]])


@pytest.fixture(scope="module")
def chunked(inputs, handover):
    """The port's replay driver: cadence flags planned on the host, then
    mapping and loop attempts over each chunk in one call."""
    m = _tmapper(handover)
    fused = []
    rest = inputs[HANDOVER:]
    for c0 in range(0, len(rest), CHUNK):
        rows = rest[c0:c0 + CHUNK]
        ts = np.asarray([r[0] for r in rows])
        mf, lf = m.plan_chunk(ts)
        keys = ("cxyz", "cval", "sxyz", "sval", "oxyz", "oval")
        clouds = {k: torch.as_tensor(np.stack([r[3][i] for r in rows]))
                  for i, k in enumerate(keys)}
        ps, _ = m.process_chunk(
            ts, torch.as_tensor(np.stack([r[1] for r in rows])),
            torch.as_tensor(np.stack([r[2] for r in rows])), clouds,
            torch.as_tensor(ts), mf, lf,
            imu_rp_dev=torch.as_tensor(np.stack([r[4] for r in rows])))
        fused.append(ps.numpy())
    return m, np.concatenate(fused)


def _attempts(m):
    return [{k: float(np.asarray(v)) for k, v in i.items()}
            for i in m.loop_info]


@pytest.mark.parametrize("mode", ["streamed", "chunked"])
def test_loop_attempts(handover, reference, mode, request):
    """The attempts after the hand-over (the earlier ones found nothing)."""
    jm, _ = reference
    tm, _ = request.getfixturevalue(mode)
    before = handover[3]
    assert len(before) >= 5 and not any(a["found"] for a in before)
    want, got = _attempts(jm), _attempts(tm)
    assert len(got) == len(want) >= 2
    for key in ("found", "accepted", "applied", "matched"):
        assert [a[key] for a in got] == [a[key] for a in want], key
    # fitness is a mean squared distance; corr_t a length, held as the
    # positions are
    np.testing.assert_allclose([a["fitness"] for a in got],
                               [a["fitness"] for a in want], rtol=1e-6)
    np.testing.assert_allclose([a["corr_t"] for a in got],
                               [a["corr_t"] for a in want], rtol=0,
                               atol=POS_TOL)
    assert sum(a["found"] for a in want) >= 2
    assert sum(a["accepted"] for a in want) >= 1


@pytest.mark.parametrize("mode", ["streamed", "chunked"])
def test_loops_and_edges(reference, mode, request):
    jm, _ = reference
    tm, _ = request.getfixturevalue(mode)
    n_loops = int(tm.state.n_loops)
    assert n_loops == int(np.asarray(jm.state.n_loops)) >= 1
    n_kf = int(tm.state.store.count)
    assert n_kf == int(np.asarray(jm.state.store.count))
    assert int(tm.state.edges.count) == n_kf - 1 + n_loops


@pytest.mark.parametrize("mode", ["streamed", "chunked"])
def test_fused_positions(reference, mode, request):
    _, jp = reference
    _, tp = request.getfixturevalue(mode)
    assert tp.shape == jp.shape == (N_SCANS - 1 - HANDOVER, 3)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POS_TOL)


@pytest.mark.parametrize("mode", ["streamed", "chunked"])
def test_final_state(reference, mode, request):
    jm, _ = reference
    tm, _ = request.getfixturevalue(mode)
    want = dict(_leaves(jm.state))
    got = dict(_leaves(tm.state))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _leaves(state, prefix=""):
    if hasattr(state, "_fields"):
        for f in state._fields:
            yield from _leaves(getattr(state, f), f"{prefix}{f}.")
    elif hasattr(state, "__dataclass_fields__"):
        for f in state.__dataclass_fields__:
            v = getattr(state, f)
            if not isinstance(v, (int, float)):
                yield from _leaves(v, f"{prefix}{f}.")
    else:
        yield prefix[:-1], np.asarray(state)


if __name__ == "__main__":
    # The reference package's own numbers on chip_smoke.py's loop-closure
    # paths, on the CPU in float32 with its kernels off, as bench.py
    # configures it without a TPU:
    #     PYTHONPATH=. python tests/test_torch_loop.py [H|V|HR|R|E|HS ...]
    # H: HDL-64, the revisiting circuit (107 scans, loop_time_gate 4 s);
    # V: bench.py's main cell with loop attempts, the gentle sequence;
    # HR: H over the radius-selected map (lc_map_mode="radius");
    # R: the radius map with loop closure off (run_slam.py
    # --no-loop-closure), VLP-16, the first 6 + 2x32 gentle scans;
    # E: the window map without loop attempts in the "exact" feature mode,
    # VLP-16, the first 6 + 2x32 gentle scans;
    # HS: H with max_keyframes=2048, where every solve is the sparse one
    # (optimize_cg).
    import json
    import sys
    import time

    import jax
    import numpy as np

    from lins_tpu.config import HDL64, VLP16
    from lins_tpu.datasets import synthetic as jsyn
    from lins_tpu.slam import LinsSlam as JSlam
    from lins_tpu.utils.trajectory import ate

    jax.config.update("jax_platforms", "cpu")
    paths = dict(
        H=(HDL64.replace(loop_time_gate=4.0), dict(
            n_scans=107, kind="loop", speed=2.2, loop_scale=0.32,
            acc_noise=0.02, gyr_noise=0.002, ba=(0.05, -0.03, 0.02),
            bw=(0.002, -0.001, 0.0015))),
        V=(VLP16.replace(max_points=28800), dict(
            n_scans=134, kind="gentle", speed=1.5)))
    paths["HR"] = (paths["H"][0].replace(lc_map_mode="radius"),
                   paths["H"][1])
    paths["R"] = (VLP16.replace(max_points=28800,
                                loop_closure_enabled=False),
                  dict(n_scans=70, kind="gentle", speed=1.5))
    paths["E"] = (VLP16.replace(max_points=28800, loop_attempts=False,
                                feature_mode="exact"),
                  dict(n_scans=70, kind="gentle", speed=1.5))
    paths["HS"] = (paths["H"][0].replace(max_keyframes=2048), paths["H"][1])
    for name in sys.argv[1:] or ["H", "V", "HR", "R"]:
        cfg, seq_kw = paths[name]
        t0 = time.perf_counter()
        seq = jsyn.generate_sequence(cfg, **seq_kw)
        out = dict(path=name, sequence_s=time.perf_counter() - t0)
        for what, mapping in (("odometry", False), ("fused", True)):
            t0 = time.perf_counter()
            slam = JSlam(cfg, enable_mapping=mapping).run_replay(seq,
                                                                 chunk=32)
            _, ps, _ = slam.trajectory_arrays()
            out[f"{what}_ate_m"] = ate(ps, seq["gt_pos"][1:1 + len(ps)],
                                       align=True)
            out[f"{what}_s"] = time.perf_counter() - t0
            if mapping:
                m = slam.mapper
                out["n_loops"] = int(m.state.n_loops)
                out["keyframes"] = int(m.state.store.count)
                out["edges"] = int(np.asarray(m.state.edges.count))
                out["attempts"] = [
                    dict(found=bool(np.asarray(i["found"])),
                         accepted=bool(np.asarray(i["accepted"])),
                         fitness=float(np.asarray(i["fitness"])),
                         corr_t=float(np.asarray(i["corr_t"])))
                    for i in m.loop_info]
        out["device"] = str(jax.devices()[0])
        print(json.dumps(out), flush=True)
