"""Port parity for the parallel drivers (lins_tpu/parallel/dist_graph.py,
replay.py and __graft_entry__.py's dry run), lins_tpu_torch against
lins_tpu in float64 on the CPU:

  * `pad_edges` exactly;
  * the edge-sharded dense and sparse solves on an 8-shard CPU mesh
    against the reference's on its 8 virtual devices (the conftest sets
    them up), within 1e-8 m;
  * `make_sharded_chunk_replay` with B = 4 distinct TINY streams (the
    gentle trajectory at four speeds) on a 2-shard mesh against the
    reference's on the same streams, within 1e-6 m; each stream also equals
    its own `LinsOdometry.add_scan_chunk` exactly;
  * `make_sharded_slam_replay` with B = 2 distinct TINY streams against
    each stream's own `LinsSlam` chunk (`stage_replay` + `run_chunk`, the
    body of `run_replay`), bit for bit;
  * `dryrun.entry()` and `dryrun_multichip(2)`.

Unlike tests/test_parallel.py, whose batched replay broadcasts one stream
to every lane, every lane here is a different stream, so state leaking
from one stream into another would show.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.graph import pose_graph as jpg
from lins_tpu.odometry import LinsOdometry as JOdometry
from lins_tpu.parallel import dist_graph as jdg
from lins_tpu.parallel import replay as jreplay
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.graph import pose_graph as tpg
from lins_tpu_torch.odometry import LinsOdometry as TOdometry
from lins_tpu_torch.parallel import dist_graph as tdg
from lins_tpu_torch.parallel import dryrun
from lins_tpu_torch.parallel import replay as treplay
from lins_tpu_torch.slam import LinsSlam
from lins_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

F64 = jnp.float64
SPEEDS = (1.0, 1.5, 2.0, 2.5)


def _t(x):
    return torch.as_tensor(np.array(x))


def _edges_t(e):
    return tpg.EdgeSet(*(_t(x) for x in e))


def chain_graph(n=24, K=32, drift=0.03, seed=0):
    """tests/test_parallel.py::chain_graph."""
    rng = np.random.default_rng(seed)
    edges = jpg.empty_edges(64, F64)
    e = jnp.asarray([1.0, 0, 0, 0], F64)
    gt = np.cumsum(np.tile([1.0, 0, 0], (n, 1)), axis=0) - [1, 0, 0]
    for k in range(n - 1):
        edges = jpg.add_edge(edges, k, k + 1, jnp.asarray([1.0, 0, 0]), e,
                             1e4, 1e4)
    edges = jpg.add_edge(edges, n - 1, 0,
                         jnp.asarray(gt[0] - gt[n - 1], F64), e, 1e4, 1e4)
    init = gt + rng.normal(0, drift, gt.shape).cumsum(axis=0)
    pos = np.zeros((K, 3))
    pos[:n] = init
    quat = np.zeros((K, 4))
    quat[:, 0] = 1.0
    return pos, quat, n, edges


@pytest.mark.parametrize("cap,n", [(10, 8), (64, 8), (61, 2), (5, 1)])
def test_pad_edges(cap, n):
    edges = jpg.empty_edges(cap, F64)
    edges = jpg.add_edge(edges, 1, 2, jnp.asarray([1.0, 2, 3], F64),
                         jnp.asarray([0.5, 0.5, 0.5, 0.5], F64), 3.0, 4.0)
    want = jdg.pad_edges(edges, n)
    got = tdg.pad_edges(_edges_t(edges), n)
    assert got.i.shape[0] % n == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["dense", "cg"])
def test_sharded_solves_on_8_shards(kind):
    """Each of 8 CPU shards builds its edges' terms, summed per iteration
    (CG: per CG iteration), against the reference's shard_map + psum."""
    pos, quat, n, edges = chain_graph()
    K = pos.shape[0]
    jmesh = jreplay.make_mesh(8)
    tmesh = treplay.make_mesh(8, device="cpu")
    assert tmesh.size == 8 and jmesh.devices.size == 8
    if kind == "dense":
        jopt = jdg.make_sharded_optimizer(jmesh, K, iters=6)
        topt = tdg.make_sharded_optimizer(tmesh, K, iters=6)
    else:
        jopt = jdg.make_sharded_cg_optimizer(jmesh, K, iters=6, cg_iters=48)
        topt = tdg.make_sharded_cg_optimizer(tmesh, K, iters=6, cg_iters=48)
    pj, qj = jopt(jnp.asarray(pos), jnp.asarray(quat), n, edges)
    pt, qt = topt(_t(pos), _t(quat), torch.tensor(n), _edges_t(edges))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-8)
    # and the one-shard solve of the same kind
    one = (tpg.optimize(_t(pos), _t(quat), torch.tensor(n), _edges_t(edges),
                        iters=6) if kind == "dense" else
           tpg.optimize_cg(_t(pos), _t(quat), torch.tensor(n),
                           _edges_t(edges), iters=6, cg_iters=48))
    np.testing.assert_allclose(pt.numpy(), one[0].numpy(), rtol=0,
                               atol=1e-9)
    assert np.abs(pt.numpy() - pos).max() > 0.05


# --- the chunked odometry replay ---------------------------------------------

CFG_J = TINY.replace(use_pallas=False)
CFG_T = SlamConfig.from_dict(CFG_J.to_dict())
WARM, K = 6, 4


def _warm(odo, data, cfg):
    """Stream the first WARM scans with their IMU, then buffer the rest."""
    imu_i = 0
    for k in range(WARM):
        t_scan = data["scan_times"][k] + cfg.scan_period
        while (imu_i < len(data["imu_times"])
               and data["imu_times"][imu_i] <= t_scan + 1e-9):
            odo.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                        data["imu_gyr"][imu_i])
            imu_i += 1
        odo.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
    while imu_i < len(data["imu_times"]):
        odo.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                    data["imu_gyr"][imu_i])
        imu_i += 1
    return odo


def _chunk(odo, data, cfg):
    """The next K scans and their IMU batches as numpy (advances the
    odometry's IMU bookkeeping, as the reference's test does)."""
    ks = range(WARM, WARM + K)
    imu = [np.zeros((K,) + s) for s in ((cfg.max_imu_per_scan,),
                                        (cfg.max_imu_per_scan, 3),
                                        (cfg.max_imu_per_scan, 3))]
    valid = np.zeros((K, cfg.max_imu_per_scan), bool)
    ts = np.zeros(K)
    for i, k in enumerate(ks):
        t = float(data["scan_times"][k]) + cfg.scan_period
        imu[0][i], imu[1][i], imu[2][i], valid[i] = odo._imu_batch_np(t)
        odo.time = t
        ts[i] = t
    return (ts, np.stack([data["scans_xyz"][k] for k in ks]).astype(
        np.float32), np.asarray([data["scans_n"][k] for k in ks], np.int32),
        *imu, valid)


@pytest.fixture(scope="module")
def streams():
    out = []
    for speed in SPEEDS:
        data = jsyn.generate_sequence(CFG_J, n_scans=WARM + K, kind="gentle",
                                      speed=speed)
        jodo = _warm(JOdometry(CFG_J), data, CFG_J)
        todo = _warm(TOdometry(CFG_T, dtype=torch.float64, device="cpu"),
                     data, CFG_T)
        chunk = _chunk(jodo, data, CFG_J)
        _chunk(todo, data, CFG_T)
        out.append((jodo, todo, chunk))
    return out


def test_sharded_chunk_replay_distinct_streams(streams):
    B = len(streams)
    jstate = [(o.filter_state, o.global_state, o.last_surf, o.last_corner)
              for o, _, _ in streams]
    jchunks = [c[1:] for _, _, c in streams]
    jstep, jput = jreplay.make_sharded_chunk_replay(CFG_J,
                                                    jreplay.make_mesh(2))
    stack = lambda xs: jnp.stack([jnp.asarray(x) for x in xs])   # noqa: E731
    js = jput(jax.tree_util.tree_map(lambda *xs: stack(xs), *jstate))
    jc = jput(tuple(stack([c[i] for c in jchunks]) for i in range(6)))
    _, (rn_j, _) = jstep(js, *jc)

    tstate = [tree_map(torch.clone, (o.filter_state, o.global_state,
                                     o.last_surf, o.last_corner))
              for _, o, _ in streams]
    tstep, tput = treplay.make_sharded_chunk_replay(
        CFG_T, treplay.make_mesh(2, device="cpu"))
    ts_ = tput(treplay.stack_lanes(tstate))
    tc = tput(tuple(torch.stack([_t(c[i]) for c in jchunks])
                    for i in range(6)))
    _, (rn_t, qbn_t) = tstep(ts_, *tc)
    assert rn_t.shape == (B, K, 3)
    np.testing.assert_allclose(rn_t.numpy(), np.asarray(rn_j), rtol=0,
                               atol=1e-6)
    # distinct streams: every lane moved its own way
    ends = rn_t[:, -1].numpy()
    assert min(np.linalg.norm(ends[a] - ends[b]) for a in range(B)
               for b in range(a)) > 0.05
    # each lane equals its stream's own chunk, exactly
    for b, (_, todo, chunk) in enumerate(streams):
        ts, xyz, n, *imu = chunk
        todo.add_scan_chunk(ts, xyz, n, imu=tuple(_t(x) for x in imu))
        rns, qbns = todo.last_chunk_poses
        np.testing.assert_array_equal(rn_t[b].numpy(), rns.numpy())
        np.testing.assert_array_equal(qbn_t[b].numpy(), qbns.numpy())


# --- the full SLAM replay ----------------------------------------------------

SLAM_CFG = CFG_T.replace(max_keyframes=32, max_map_corner=8192,
                         max_map_surf=16384)
SLAM_K = 6


def test_sharded_slam_replay_equals_each_stream():
    """Two distinct streams through the full-pipeline batched replay: each
    lane's fused poses and final states equal its own LinsSlam's chunk bit
    for bit."""
    slams, jobs = [], []
    for speed in SPEEDS[1:3]:
        data = jsyn.generate_sequence(TINY, n_scans=WARM + SLAM_K,
                                      kind="gentle", speed=speed)
        slam = LinsSlam(SLAM_CFG, device="cpu", dtype=torch.float64)
        job, tail = slam.stage_replay(data, WARM + SLAM_K, chunk=SLAM_K,
                                      min_streamed=WARM)
        assert len(job) == 1 and not tail
        slams.append(slam)
        jobs.append(job[0])
    (_, _, _, _), (_, mf, lf, _) = jobs[0]
    assert mf.any() and lf.any()
    for (_, (_, mf_b, lf_b, _)) in jobs:
        np.testing.assert_array_equal(mf_b, mf)
        np.testing.assert_array_equal(lf_b, lf)
    step, put = treplay.make_sharded_slam_replay(
        SLAM_CFG, treplay.make_mesh(1, device="cpu"))
    odo = treplay.stack_lanes([tree_map(torch.clone, (
        s.odometry.filter_state, s.odometry.global_state,
        s.odometry.last_surf, s.odometry.last_corner)) for s in slams])
    maps = treplay.stack_lanes([tree_map(torch.clone, s.mapper.state)
                                for s in slams])
    chunk = [torch.stack([j[0][i] for j in jobs]) for i in (1, 2)]
    imu = [torch.stack([j[0][3][i] for j in jobs]) for i in range(4)]
    ts = torch.stack([j[1][0] for j in jobs])
    rp = torch.stack([j[1][3] for j in jobs])
    odo2, maps2, (pos, quat) = step(*put((odo, maps)), *put(chunk),
                                    *put(imu), put(ts), put(rp), mf, lf,
                                    has_map=True)
    for b, (slam, job) in enumerate(zip(slams, jobs)):
        slam.run_chunk(job)
        _, ps, qs = slam.trajectory_arrays()
        np.testing.assert_array_equal(pos[b].numpy(), ps[-SLAM_K:])
        np.testing.assert_array_equal(quat[b].numpy(), qs[-SLAM_K:])
        st = slam.mapper.state
        for f in ("pos", "quat", "count"):
            np.testing.assert_array_equal(
                getattr(maps2.store, f)[b].numpy(),
                getattr(st.store, f).numpy())
        np.testing.assert_array_equal(odo2[1].rn[b].numpy(),
                                      slam.odometry.global_state.rn.numpy())
    assert float(torch.linalg.vector_norm(pos[0, -1] - pos[1, -1])) > 0.05


# --- the dry run ---------------------------------------------------------------

def test_dryrun_entry():
    fn, args = dryrun.entry(device="cpu")
    rn, qbn, residual = fn(*args)
    assert rn.shape == (3,) and qbn.shape == (4,)
    assert bool(torch.isfinite(rn).all())


def test_dryrun_multichip():
    report = dryrun.dryrun_multichip(2, device="cpu")
    assert report["shards"] == 2 and len(report["ran"]) == 4
    assert report["skipped"] == []
    assert "keyframe-sharded store" in report["ran"][3]
