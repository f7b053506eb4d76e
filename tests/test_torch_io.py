"""Port parity for the runner's outputs and checkpoints, lins_tpu_torch
against lins_tpu on the CPU:

  * `write_tum` byte for byte, `read_tum`, `associate`, `ate` and `rpe`
    (with and without orientations) on the same arrays;
  * `MetricsLog` JSON lines equal apart from the wall time; `write_ply`
    byte for byte;
  * `ate_rmse` with and without the frame alignment;
  * on one handed-over TINY state: `export_global_map` the same point set;
    a checkpoint written by the reference's `save_state` loads with the
    port's `load_state` into the state `load_numpy_state` gives; the
    port's own save and load round-trip; a checkpoint of a TINY run loaded
    with doubled feature capacities or another `max_keyframes` raises
    ValueError;
  * a TINY split run (save at scan 20, load into a fresh pipeline, go on to
    scan 28) against the continuous run, as
    tests/test_slam_integration.py::TestCheckpointResume holds the
    reference."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.mapping import mapper as jmapper
from lins_tpu.slam import LinsSlam as JSlam
from lins_tpu.slam import ate_rmse as j_ate_rmse
from lins_tpu.slam import run_sequence as j_run
from lins_tpu.utils import checkpoint as jckpt
from lins_tpu.utils import metrics as jmetrics
from lins_tpu.utils import trajectory as jtraj
from lins_tpu_torch import run_slam as trunner
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.slam import LinsSlam as TSlam
from lins_tpu_torch.slam import ate_rmse as t_ate_rmse
from lins_tpu_torch.slam import run_sequence as t_run
from lins_tpu_torch.utils import checkpoint as tckpt
from lins_tpu_torch.utils import metrics as tmetrics
from lins_tpu_torch.utils import trajectory as ttraj

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

# a 16-keyframe store keeps the reference's programs small to compile
JCFG = TINY.replace(loop_attempts=False, max_keyframes=16)
TCFG = SlamConfig.from_dict(JCFG.to_dict())
MAP_KW = dict(corner_cap=256, surf_cap=1024, map_corner_cap=4096,
              map_surf_cap=8192, n_window=8)


# ------------------------------------------------------------ trajectories

def _traj(seed, n=40):
    rng = np.random.default_rng(seed)
    t = 100.0 + np.cumsum(rng.uniform(0.05, 0.15, n))
    p = np.cumsum(rng.normal(size=(n, 3)), axis=0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return t, p, q


def test_tum_files(tmp_path):
    t, p, q = _traj(0)
    ja, ta = tmp_path / "j.tum", tmp_path / "t.tum"
    jtraj.write_tum(str(ja), t, p, q)
    ttraj.write_tum(str(ta), t, p, q)
    assert ta.read_bytes() == ja.read_bytes()
    for got, want in zip(ttraj.read_tum(str(ta)), jtraj.read_tum(str(ja))):
        np.testing.assert_array_equal(got, want)
    t2, p2, q2 = ttraj.read_tum(str(ta))
    np.testing.assert_allclose(t2, t, atol=5e-7)
    np.testing.assert_allclose(p2, p, atol=5e-7)
    np.testing.assert_allclose(q2, q, atol=5e-7)


@pytest.mark.parametrize("seed", range(3))
def test_associate_ate_rpe(seed):
    t, p, q = _traj(seed)
    rng = np.random.default_rng(seed + 10)
    t_b = np.sort(t + rng.normal(scale=0.01, size=len(t)))[::2]
    for max_dt in (0.005, 0.02):
        for got, want in zip(ttraj.associate(t, t_b, max_dt),
                             jtraj.associate(t, t_b, max_dt)):
            np.testing.assert_array_equal(got, want)
    gt = p + rng.normal(scale=0.1, size=p.shape)
    gt_q = q + rng.normal(scale=0.01, size=q.shape)
    assert ttraj.ate(p, gt) == jtraj.ate(p, gt)
    assert ttraj.ate(p, gt, align=False) == jtraj.ate(p, gt, align=False)
    assert ttraj.rpe(p, gt) == jtraj.rpe(p, gt)
    assert ttraj.rpe(p, gt, 5, q, gt_q) == jtraj.rpe(p, gt, 5, q, gt_q)
    assert np.isnan(ttraj.rpe(p[:5], gt[:5]))
    for got, want in zip(ttraj.umeyama_align(p, gt, with_scale=True),
                         jtraj.umeyama_align(p, gt, with_scale=True)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aligned", [False, True])
def test_ate_rmse(aligned):
    """The no-fit ATE over trajectories of different lengths, with the
    ground truth given in another world frame (R0, p0) and put into the
    estimator's, or given in the estimator's frame."""
    _, p, _ = _traj(5)
    rng = np.random.default_rng(6)
    gt = p + rng.normal(scale=0.05, size=p.shape)
    frame = None
    if aligned:
        R0, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R0 *= np.linalg.det(R0)
        frame = (R0, rng.normal(size=3))
        gt = gt @ R0.T + frame[1]
    got = t_ate_rmse(p[:33], gt, frame)
    assert got == j_ate_rmse(p[:33], gt, frame)
    assert 0.05 < got < 0.15
    if aligned:
        assert t_ate_rmse(p[:33], gt) > 1.0


def test_metrics_log(tmp_path):
    fields = [("odometry", dict(iters=3, n_surf=np.int32(411), ok=True,
                                res=0.25)),
              ("mapping", dict(warm_dist=np.float32(0.125),
                               vec=np.arange(3.0)))]
    jlog, tlog = jmetrics.MetricsLog(), tmetrics.MetricsLog()
    for stage, kw in fields:
        jlog.record(stage, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                              else v for k, v in kw.items()})
        tlog.record(stage, **{k: torch.as_tensor(v)
                              if isinstance(v, np.ndarray) else v
                              for k, v in kw.items()})
    jlog.dump(str(tmp_path / "j.jsonl"))
    tlog.dump(str(tmp_path / "t.jsonl"))

    def lines(path):
        out = [json.loads(s) for s in path.read_text().splitlines()]
        for rec in out:
            assert isinstance(rec.pop("t_wall"), float)
        return out

    assert lines(tmp_path / "t.jsonl") == lines(tmp_path / "j.jsonl")
    assert tlog.summary() == jlog.summary()
    assert tlog.mean("odometry/iters") == 3.0
    rec = tmetrics.SpanRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmetrics, "RECORDER", rec)
        with tmetrics.trace_scope("stage", iters=torch.tensor(3)):
            pass
    (span,) = rec.spans()
    assert span["name"] == "stage" and span["attrs"] == {"iters": 3}
    assert span["end_ns"] >= span["start_ns"] and span["parent"] == 0


def test_write_ply(tmp_path):
    pts = np.random.default_rng(1).normal(size=(257, 3))
    jckpt.write_ply(str(tmp_path / "j.ply"), pts)
    tckpt.write_ply(str(tmp_path / "t.ply"), pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


# -------------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def data():
    return jsyn.generate_sequence(JCFG, n_scans=28, kind="turny", speed=1.0)


@pytest.fixture(scope="module")
def jrun(data):
    """The reference pipeline over the first 9 scans (float64 mapper)."""
    s = JSlam(JCFG, dtype=jnp.float64, enable_mapping=False)
    s.mapper = jmapper.LinsMapper(JCFG, dtype=jnp.float64, **MAP_KW)
    return j_run(s, data, 9)


def _tslam(dtype=torch.float64):
    return TSlam(TCFG, dtype=dtype, device="cpu", **MAP_KW)


def _leaves(tree, prefix=""):
    """(name, numpy array) of every array leaf of a state container,
    dataclass fields (the voxel maps) included."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}.")
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            v = getattr(tree, f)
            if not isinstance(v, (int, float)):
                yield from _leaves(v, f"{prefix}{f}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _assert_tree_equal(got, want, what):
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert set(gl) == set(wl) and gl, what
    for name, w in wl.items():
        g = gl[name]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


def test_reference_checkpoint_loads(jrun, tmp_path):
    """A checkpoint written by the reference loads with the port's
    `load_state` into the state that `load_numpy_state` hands over, the
    local map rebuilt from the store."""
    path = str(tmp_path / "ref.npz")
    jckpt.save_state(path, jrun.odometry, jrun.mapper)
    ts = _tslam()
    meta = tckpt.load_state(path, ts.odometry, ts.mapper)
    jo, to = jrun.odometry, ts.odometry
    assert meta["format"] == 2
    assert (to.status, to.time) == (jo.status, jo.time) and to.status == 3
    for name in ("filter_state", "global_state", "last_surf", "last_corner"):
        want = getattr(jo, name)
        if isinstance(want, dict):
            want = {k: np.asarray(v).astype(np.int32) if k == "ring"
                    else np.asarray(v) for k, v in want.items()}
        _assert_tree_equal(getattr(to, name), want, name)
    assert to.last_surf["xyz"].dtype == torch.float64

    want = _tslam().mapper
    want.load_numpy_state(jax.tree_util.tree_map(np.asarray,
                                                 jrun.mapper.state))
    want.rebuild_local_map()
    _assert_tree_equal(ts.mapper.state, want.state, "mapper_state")
    assert int(ts.mapper.state.store.count) >= 2
    assert ts.mapper.state.lmap.n_surf > 50
    assert ts.mapper.last_time == jrun.mapper.last_time
    assert ts.mapper._has_map


def test_own_checkpoint_round_trip(jrun, tmp_path):
    """The port's save and load in float32: every saved leaf equal, the
    archive's keys the reference's, and the local map rebuilt."""
    src = _tslam(torch.float32)
    src.mapper.load_numpy_state(jax.tree_util.tree_map(np.asarray,
                                                       jrun.mapper.state))
    jo = jrun.odometry
    src.odometry.load_numpy_state(dict(
        filter_state=jo.filter_state._asdict(),
        global_state=jo.global_state._asdict(), last_surf=jo.last_surf,
        last_corner=jo.last_corner, last_outlier=None, status=jo.status,
        time=jo.time, imu_t=[], imu_a=[], imu_g=[]))
    src.mapper.last_loop_time = 7.5
    path = str(tmp_path / "own.npz")
    tckpt.save_state(path, src.odometry, src.mapper, extra=dict(tag=[1, 2]))
    keys = set(np.load(path).files)
    jpath = str(tmp_path / "ref.npz")
    jckpt.save_state(jpath, jrun.odometry, jrun.mapper, extra=dict(tag=[1]))
    assert keys == set(np.load(jpath).files)

    dst = _tslam(torch.float32)
    tckpt.load_state(path, dst.odometry, dst.mapper)
    for name in ("filter_state", "global_state", "last_surf", "last_corner"):
        _assert_tree_equal(getattr(dst.odometry, name),
                           getattr(src.odometry, name), name)
    src.mapper.rebuild_local_map()
    _assert_tree_equal(dst.mapper.state, src.mapper.state, "mapper_state")
    assert dst.mapper.last_loop_time == 7.5
    assert (dst.odometry.status, dst.odometry.time) == (jo.status, jo.time)


@pytest.fixture(scope="module")
def tiny_ckpt(data, tmp_path_factory):
    """The port's checkpoint of a TINY run saved at scan 8."""
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    s = t_run(_tslam(), data, 9)
    tckpt.save_state(path, s.odometry, s.mapper)
    return path


def _doubled_capacities():
    """TCFG under the runner's `--feature-scale 2` transform."""
    args = trunner.build_parser().parse_args(
        ["--preset", "tiny", "--synthetic", "gentle", "--feature-scale",
         "2"])
    return trunner.configure(args).replace(
        loop_attempts=JCFG.loop_attempts, max_keyframes=JCFG.max_keyframes)


@pytest.mark.parametrize("change,leaf", [
    ("feature_scale", r"'last_surf/0' \(ring\) has shape \(1536,\) but "
     r"the current state expects \(3072,\)"),
    ("max_keyframes", r"'mapper_state/\d+' \(store\.[a-z_]+\) has shape "
     r"\(16,")], ids=["feature_scale", "max_keyframes"])
def test_checkpoint_other_capacities_refused(tiny_ckpt, change, leaf):
    """A checkpoint loads only into a state of its own capacities: with
    twice the feature capacities (`--feature-scale 2`) or another
    `max_keyframes`, `load_state` raises ValueError naming the leaf and
    both shapes, instead of a crash at the next scan."""
    cfg = (_doubled_capacities() if change == "feature_scale"
           else TCFG.replace(max_keyframes=32))
    assert cfg != TCFG
    slam = TSlam(cfg, dtype=torch.float64, device="cpu", **MAP_KW)
    with pytest.raises(ValueError, match=leaf) as e:
        tckpt.load_state(tiny_ckpt, slam.odometry, slam.mapper)
    assert "capacities" in str(e.value) and "max_keyframes" in str(e.value)


def test_export_global_map(jrun, tmp_path):
    """The same world-frame point set as the reference's export, from the
    same handed-over store; .npz and .ply."""
    jckpt.export_global_map(str(tmp_path / "j.npz"), jrun.mapper)
    tm = _tslam().mapper
    tm.load_numpy_state(jax.tree_util.tree_map(np.asarray, jrun.mapper.state))
    n = tckpt.export_global_map(str(tmp_path / "t.npz"), tm)
    want = np.load(tmp_path / "j.npz")["points"]
    got = np.load(tmp_path / "t.npz")["points"]
    assert n == len(got) == len(want) > 100
    order = (np.lexsort(want.T[::-1]), np.lexsort(got.T[::-1]))
    np.testing.assert_allclose(got[order[1]], want[order[0]], rtol=0,
                               atol=1e-9)
    assert tckpt.export_global_map(str(tmp_path / "t.ply"), tm) == n
    jckpt.write_ply(str(tmp_path / "j.ply"), got)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def _feed(slam, data, start, end, imu_from):
    """Scans start..end-1 with every IMU sample after `imu_from` up to each
    scan's end."""
    imu_t = data["imu_times"]
    t_prev = imu_from
    for k in range(start, end):
        t_scan = float(data["scan_times"][k]) + TCFG.scan_period
        for i in np.nonzero((imu_t > t_prev) & (imu_t <= t_scan + 1e-9))[0]:
            slam.add_imu(imu_t[i], data["imu_acc"][i], data["imu_gyr"][i])
        slam.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
        t_prev = t_scan
    return slam


def test_split_run_resumes(data, tmp_path):
    """Save at scan 20, load into a fresh pipeline, go on to scan 28 (the
    IMU fed again from a scan before the save): the fused positions after
    the resume equal the continuous run's within 1e-6 m."""
    n_split, n_total = 20, 28
    cont = t_run(_tslam(), data, n_total)
    first = t_run(_tslam(), data, n_split)
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, first.odometry, first.mapper)
    resumed = _tslam()
    tckpt.load_state(path, resumed.odometry, resumed.mapper)
    t_prev = float(data["scan_times"][n_split - 1]) + TCFG.scan_period
    _feed(resumed, data, n_split, n_total, t_prev - 0.11)
    tc, pc, _ = cont.trajectory_arrays()
    tr, pr, _ = resumed.trajectory_arrays()
    k = len(tr)
    assert k == n_total - n_split
    np.testing.assert_array_equal(tr, tc[-k:])
    np.testing.assert_allclose(pr, pc[-k:], rtol=0, atol=1e-6)
    assert len(resumed.mapper.metrics) >= 2
    assert int(resumed.mapper.state.store.count) > int(
        first.mapper.state.store.count)
