"""Port parity for the sparse pose-graph solve (lins_tpu/graph/
pose_graph.py:240-343, `optimize_cg`, the matrix-free block-Jacobi PCG the
mapper takes above 1024 keyframe slots), lins_tpu_torch against lins_tpu
in float64 on the CPU:

  * `optimize_cg` on the chain graph of tests/test_parallel.py:19-33 and
    on drifted circles with a loop edge, with and without the Huber loss
    and with the gauge prior on another slot: within 1e-8 m of the
    reference's;
  * `optimize_cg` against the port's dense `optimize` within 1e-4 m, as
    tests/test_parallel.py:296-309 holds the reference's pair;
  * a `LinsMapper` with `max_keyframes` = 1056 and loop closure on
    constructs, and its solve and rewrite (`_solve_and_rewrite`, the route
    of every loop attempt's solve and of `final_solve`) on a hand-built
    state matches the reference's `_final_solve_impl` within 1e-8 m.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY
from lins_tpu.geom import so3 as jso3
from lins_tpu.graph import pose_graph as jpg
from lins_tpu.mapping import keyframes as jkf
from lins_tpu.mapping import mapper as jmapper
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.graph import pose_graph as tpg
from lins_tpu_torch.mapping import mapper as tmapper

torch.set_num_threads(1)

F64 = jnp.float64
TOL_M = 1e-8


def _t(x):
    return torch.as_tensor(np.array(x))


def _edges_t(e):
    return tpg.EdgeSet(*(_t(x) for x in e))


def chain_graph(n=24, K=32, drift=0.03, seed=0):
    """tests/test_parallel.py::chain_graph: a straight chain with a loop
    edge from its end to its start, positions drifted by a random walk."""
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


def drifted_circle(n=20, drift=0.05, seed=0, K=32):
    """tests/test_graph.py's drifted circle with its true loop edge."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt_pos = np.stack([5.0 * np.cos(theta), 5.0 * np.sin(theta),
                       np.zeros(n)], 1)
    gt_quat = np.stack([np.asarray(jso3.rpy_to_quat(
        jnp.asarray([0.0, 0.0, y], F64))) for y in theta + np.pi / 2])
    edges = jpg.empty_edges(64, F64)
    pos = np.zeros((K, 3))
    quat = np.zeros((K, 4))
    quat[:, 0] = 1.0
    pos[0], quat[0] = gt_pos[0], gt_quat[0]
    p, q = jnp.asarray(gt_pos[0], F64), jnp.asarray(gt_quat[0], F64)
    for k in range(n - 1):
        rel = jpg.relative_pose(*(jnp.asarray(a, F64) for a in (
            gt_pos[k], gt_quat[k], gt_pos[k + 1], gt_quat[k + 1])))
        edges = jpg.add_edge(edges, k, k + 1, *rel, 1e4, 1e4)
        p = p + jso3.quat_rotate(q, rel[0] + drift * rng.normal(size=3))
        q = jso3.quat_normalize(jso3.quat_mul(q, rel[1]))
        pos[k + 1], quat[k + 1] = np.asarray(p), np.asarray(q)
    edges = jpg.add_edge(edges, n - 1, 0, *jpg.relative_pose(
        *(jnp.asarray(a, F64) for a in (gt_pos[n - 1], gt_quat[n - 1],
                                        gt_pos[0], gt_quat[0]))), 1e4, 1e4)
    return pos, quat, n, edges


# (graph, huber delta, prior slot)
CASES = {
    "chain": (chain_graph, 0.0, 0),
    "circle_loop": (drifted_circle, 0.0, 0),
    "circle_loop_huber": (drifted_circle, 0.5, 0),
    "circle_loop_huber_prior3": (drifted_circle, 0.5, 3),
}


@pytest.mark.parametrize("active", ["count", "mask"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_optimize_cg_matches_reference(name, active):
    make, huber, prior = CASES[name]
    pos, quat, n, edges = make()
    K = pos.shape[0]
    act = np.arange(K) < n
    a_j = jnp.int32(n) if active == "count" else jnp.asarray(act)
    a_t = torch.tensor(n) if active == "count" else torch.as_tensor(act)
    pj, qj = jpg.optimize_cg(jnp.asarray(pos), jnp.asarray(quat), a_j, edges,
                             iters=8, cg_iters=64, prior_slot=prior,
                             huber_delta=huber)
    pt, qt = tpg.optimize_cg(_t(pos), _t(quat), a_t, _edges_t(edges),
                             iters=8, cg_iters=64, prior_slot=prior,
                             huber_delta=huber)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=TOL_M)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=TOL_M)
    c0 = float(tpg.graph_cost(_t(pos), _t(quat), _edges_t(edges)))
    c1 = float(tpg.graph_cost(pt, qt, _edges_t(edges)))
    assert c1 < 0.1 * c0


def test_optimize_cg_matches_dense():
    """The sparse solve against the dense one on the chain graph (96 CG
    iterations, the dense solve's damping), as the reference's pair."""
    pos, quat, n, edges = chain_graph()
    p0, _ = tpg.optimize(_t(pos), _t(quat), torch.tensor(n), _edges_t(edges),
                         iters=8)
    p1, _ = tpg.optimize_cg(_t(pos), _t(quat), torch.tensor(n),
                            _edges_t(edges), iters=8, cg_iters=96,
                            damping=1e-6)
    np.testing.assert_allclose(p1.numpy()[:n], p0.numpy()[:n], rtol=0,
                               atol=1e-4)
    assert np.abs(p0.numpy()[:n] - pos[:n]).max() > 0.05   # it moved


def test_poisoned_cg_solve_is_a_no_op():
    pos, quat, n, edges = chain_graph()
    bad = jpg.add_edge(edges, 0, n - 1, jnp.asarray([np.nan, 0.0, 0.0], F64),
                       jnp.asarray([1.0, 0, 0, 0], F64), 1e4, 1e4)
    pt, _ = tpg.optimize_cg(_t(pos), _t(quat), torch.tensor(n),
                            _edges_t(bad), iters=3, cg_iters=16)
    np.testing.assert_array_equal(pt.numpy(), pos)


# --- the mapper above 1024 slots ---------------------------------------------

JCFG = TINY.replace(max_keyframes=1056, loop_time_gate=4.0)
TCFG = SlamConfig.from_dict(JCFG.to_dict())
CAPS = dict(corner_cap=16, surf_cap=32, outlier_cap=16)
N_WINDOW = 8
N_KF = 30


def _reference_state():
    """A reference mapper state of N_KF keyframes around a drifted circle,
    their odometry edges and a loop edge back to the start."""
    rng = np.random.default_rng(3)
    st = jmapper.init_mapper(JCFG, **CAPS, n_window=N_WINDOW, dtype=F64)
    pos, quat, n, edges = drifted_circle(n=N_KF, K=N_KF, drift=0.05, seed=2)
    store = st.store
    for k in range(N_KF):
        c = rng.uniform(-4, 4, (CAPS["corner_cap"], 3))
        s = rng.uniform(-4, 4, (CAPS["surf_cap"], 3))
        o = rng.uniform(-4, 4, (CAPS["outlier_cap"], 3))
        store = jkf.add_keyframe(
            store, jnp.asarray(pos[k]), jnp.asarray(quat[k]), 0.3 * k,
            jnp.asarray(c), jnp.ones(len(c), bool), jnp.asarray(s),
            jnp.ones(len(s), bool), jnp.asarray(o), jnp.ones(len(o), bool))
    big = jpg.empty_edges(JCFG.max_keyframes + 128, F64)
    for e in range(int(edges.count)):
        big = jpg.add_edge(big, edges.i[e], edges.j[e], edges.t[e],
                           edges.q[e], edges.w_rot[e], edges.w_pos[e])
    return st._replace(store=store, edges=big, aft_pos=jnp.asarray(pos[-1]),
                       aft_quat=jnp.asarray(quat[-1]))


def test_mapper_above_1024_slots_solves_sparse():
    m = tmapper.LinsMapper(TCFG, device="cpu", dtype=torch.float64,
                           n_window=N_WINDOW, **CAPS)
    assert m.state.store.pos.shape[0] == 1056 and m._loops()
    jst = _reference_state()
    gp_j = jmapper.lmn.grid_params(JCFG)
    want = jax.jit(lambda s: jmapper._final_solve_impl(
        s, JCFG, 8, N_WINDOW, gp_j))(jst)
    tst = tmapper.mapper_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu", torch.float64)
    tst = tst._replace(lmap=m.state.lmap)
    calls = []
    inner = tpg.optimize_cg

    def spy(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    tpg.optimize_cg = spy
    try:
        got, good = tmapper._solve_and_rewrite(tst, tst.edges, TCFG, 8,
                                               N_WINDOW, m.gp)
    finally:
        tpg.optimize_cg = inner
    assert calls == [1] and bool(good)
    live = np.asarray(want.store.kf_id) >= 0
    for f in ("pos", "quat"):
        np.testing.assert_allclose(
            getattr(got.store, f).numpy()[live],
            np.asarray(getattr(want.store, f))[live], rtol=0, atol=TOL_M,
            err_msg=f)
    np.testing.assert_allclose(got.aft_pos.numpy(), np.asarray(want.aft_pos),
                               rtol=0, atol=TOL_M)
    moved = np.abs(np.asarray(want.store.pos)[live]
                   - np.asarray(jst.store.pos)[live]).max()
    assert moved > 0.01
