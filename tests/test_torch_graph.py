"""Port parity for the graph backend in float64 on the CPU, lins_tpu_torch
against lins_tpu on the same numpy inputs:

  * the pose graph: the normal system (H, g) and the Gauss-Newton solve on
    the drifted-circle graphs of tests/test_graph.py, with and without the
    Huber loss and a loop edge, with the gauge prior on another slot, and
    the poisoned solve that must change nothing;
  * the chunked brute-force nearest neighbours of the ICP (`top_k_nn`):
    lattice ties, invalid references, chunk boundaries, indices equal;
  * point-to-point ICP on tests/test_graph.py's two clouds;
  * loop detection, the chain's arc length and the consistency bound.

One loop-closure attempt on a constructed revisit is in
tests/test_torch_revisit.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import VLP16
from lins_tpu.geom import so3 as jso3
from lins_tpu.graph import loop_closure as jlc
from lins_tpu.graph import pose_graph as jpg
from lins_tpu.mapping import keyframes as jkf
from lins_tpu.ops.voxel import top_k_nn as j_top_k_nn
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.graph import loop_closure as tlc
from lins_tpu_torch.graph import pose_graph as tpg
from lins_tpu_torch.mapping import keyframes as tkf
from lins_tpu_torch.ops.voxel import top_k_nn as t_top_k_nn

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

F64 = jnp.float64
TCFG = SlamConfig.from_dict(VLP16.to_dict())


def _t(x, dtype=None):
    a = np.array(x)
    t = torch.as_tensor(a)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _edges_t(e):
    return tpg.EdgeSet(*(_t(x) for x in e))


def _drifted_circle(n=20, drift=0.02, seed=0, loop=False):
    """tests/test_graph.py::make_drifted_circle (K=32 slots, 64 edge slots),
    optionally with the true loop edge n-1 -> 0."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt_pos = np.stack([5.0 * np.cos(theta), 5.0 * np.sin(theta),
                       np.zeros(n)], 1)
    gt_quat = np.stack([np.asarray(jso3.rpy_to_quat(
        jnp.asarray([0.0, 0.0, y], F64))) for y in theta + np.pi / 2])
    rel = [jpg.relative_pose(*(jnp.asarray(a, F64) for a in (
        gt_pos[k], gt_quat[k], gt_pos[k + 1], gt_quat[k + 1])))
        for k in range(n - 1)]
    edges = jpg.empty_edges(64, F64)
    for k in range(n - 1):
        edges = jpg.add_edge(edges, k, k + 1, *rel[k], 1e4, 1e4)
    K = 32
    pos = np.zeros((K, 3))
    quat = np.zeros((K, 4))
    quat[:, 0] = 1.0
    pos[0], quat[0] = gt_pos[0], gt_quat[0]
    p, q = jnp.asarray(gt_pos[0], F64), jnp.asarray(gt_quat[0], F64)
    for k in range(n - 1):
        t_noisy = rel[k][0] + drift * rng.normal(size=3)
        p = p + jso3.quat_rotate(q, t_noisy)
        q = jso3.quat_normalize(jso3.quat_mul(q, rel[k][1]))
        pos[k + 1], quat[k + 1] = np.asarray(p), np.asarray(q)
    if loop:
        edges = jpg.add_edge(edges, n - 1, 0, *jpg.relative_pose(
            *(jnp.asarray(a, F64) for a in (gt_pos[n - 1], gt_quat[n - 1],
                                            gt_pos[0], gt_quat[0]))),
            1e4, 1e4)
    return pos, quat, edges, n


# (drift, loop edge, huber delta, prior slot)
GRAPHS = {
    "consistent": (0.0, False, 0.0, 0),
    "drift": (0.02, False, 0.0, 0),
    "loop": (0.05, True, 0.0, 0),
    "loop_huber": (0.05, True, 0.5, 0),
    "loop_huber_prior3": (0.05, True, 0.5, 3),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_normal_system(name):
    drift, loop, huber, _ = GRAPHS[name]
    pos, quat, edges, _ = _drifted_circle(drift=drift, loop=loop)
    H_j, g_j = jpg.build_normal_system(jnp.asarray(pos), jnp.asarray(quat),
                                       edges, huber)
    H_t, g_t = tpg.build_normal_system(_t(pos), _t(quat), _edges_t(edges),
                                       huber)
    assert H_t.shape == (32, 6, 32, 6)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-9)
    assert np.abs(np.asarray(H_j)).max() > 1e3


@pytest.mark.parametrize("active", ["count", "mask"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_optimize(name, active):
    drift, loop, huber, prior = GRAPHS[name]
    pos, quat, edges, n = _drifted_circle(drift=drift, loop=loop)
    act = np.arange(32) < n
    a_j = jnp.int32(n) if active == "count" else jnp.asarray(act)
    a_t = torch.tensor(n) if active == "count" else torch.as_tensor(act)
    pj, qj = jpg.optimize(jnp.asarray(pos), jnp.asarray(quat), a_j, edges,
                          iters=8, prior_slot=prior, huber_delta=huber)
    pt, qt = tpg.optimize(_t(pos), _t(quat), a_t, _edges_t(edges), iters=8,
                          prior_slot=prior, huber_delta=huber)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-9)
    c0 = float(tpg.graph_cost(_t(pos), _t(quat), _edges_t(edges)))
    c1 = float(tpg.graph_cost(pt, qt, _edges_t(edges)))
    assert c1 == pytest.approx(float(jpg.graph_cost(pj, qj, edges)),
                               rel=1e-9, abs=1e-12)
    assert c1 <= c0


def test_poisoned_solve_is_a_no_op():
    pos, quat, edges, n = _drifted_circle()
    bad = jpg.add_edge(edges, 0, n - 1, jnp.asarray([np.nan, 0.0, 0.0], F64),
                       jnp.asarray([1.0, 0, 0, 0], F64), 1e4, 1e4)
    pt, qt = tpg.optimize(_t(pos), _t(quat), torch.tensor(n), _edges_t(bad),
                          iters=4)
    pj, qj = jpg.optimize(jnp.asarray(pos), jnp.asarray(quat), jnp.int32(n),
                          bad, iters=4)
    np.testing.assert_array_equal(pt.numpy(), pos)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-12)


def test_edge_jacobians_finite_at_zero():
    """The Jacobians are taken at zero perturbation, where `exp_axis` and
    `log_quat` sit on their small-angle branches: finite and the
    reference's."""
    pos, quat, edges, n = _drifted_circle(drift=0.0)
    ii, jj = np.asarray(edges.i)[:n - 1], np.asarray(edges.j)[:n - 1]
    args = [pos[ii], quat[ii], pos[jj], quat[jj],
            np.asarray(edges.t)[:n - 1], np.asarray(edges.q)[:n - 1],
            np.asarray(edges.w_rot)[:n - 1], np.asarray(edges.w_pos)[:n - 1]]
    got = tpg._edge_blocks(*(_t(a) for a in args))
    want = jax.vmap(jpg._edge_blocks)(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    # the identity branch of `exp_axis` has a zero tangent, so in both
    # packages the rotation columns vanish and the solve moves positions
    # only (ROADMAP.md Queue 3)
    _, Ji, Jj, _ = got
    assert not Ji[..., 0:3].any() and not Jj[..., 0:3].any()
    assert Ji[..., 3:6].abs().max() > 0.5


# --- nearest neighbours ---------------------------------------------------

@pytest.mark.parametrize("k,chunk", [(1, 8192), (1, 16), (5, 8192), (5, 16),
                                     (5, 7)])
def test_top_k_nn(k, chunk):
    """A 0.5 m lattice, so many distances tie exactly; invalid references
    (also one whole chunk of them at chunk=16) and invalid queries."""
    rng = np.random.default_rng(k * 100 + chunk)
    ref = np.round(rng.uniform(-2, 2, (70, 3)) * 2) / 2
    ref[10:14] = ref[3]                                  # duplicates
    query = np.round(rng.uniform(-2, 2, (33, 3)) * 2) / 2
    query[0] = ref[3]
    r_valid = rng.random(70) < 0.85
    r_valid[16:32] = False
    r_valid[3] = True
    q_valid = rng.random(33) < 0.9
    q_valid[0] = True
    ij, dj = j_top_k_nn(*(jnp.asarray(a) for a in (query, q_valid, ref,
                                                   r_valid)), k=k,
                        chunk=chunk)
    it, dt = t_top_k_nn(*(_t(a) for a in (query, q_valid, ref, r_valid)),
                        k=k, chunk=chunk)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert it[0, 0] == 3


# --- ICP ------------------------------------------------------------------

def _walls(n, half, seed, slope):
    """tests/test_graph.py::TestICP's clouds: two perpendicular walls at
    `half` and a floor, each a third of the points; `slope` > 0 makes the
    walls' height grow with |a| (the 16 m room)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-half, half, (n, 2))
    m = 3 * n // 8 if slope == 0 else n // 3
    pts = np.zeros((n, 3))
    h = slope * np.abs(a[:, 1]) if slope else a[:, 1]
    pts[:m, 0], pts[:m, 1], pts[:m, 2] = a[:m, 0], half, h[:m]
    w = slice(m, 2 * m)
    pts[w, 1], pts[w, 0], pts[w, 2] = a[w, 0], half, h[w]
    pts[2 * m:, :2] = a[2 * m:]
    return pts


ICP_CASES = {
    # tests/test_graph.py::TestICP: 800 points, 5 cm and 3 deg off, 30
    # trips; 2400 points, 4 m and 15 deg off, 40 trips.  The moved cloud is
    # every 5th / 16th point: the reference's nearest neighbour sorts a
    # row of 8192 per source point on the CPU, a few seconds a trip at
    # full size.
    "small": (800, 3.0, 1, 0.0, [0.0, 0.0, 0.05], [0.2, -0.1, 0.05], 30, 5),
    "multimeter": (2400, 8.0, 7, 0.3, [0.0, 0.0, 0.26], [3.5, -2.0, 0.3], 40,
                   16),
}


@pytest.mark.parametrize("case", sorted(ICP_CASES))
def test_icp_align(case):
    n, half, seed, slope, rot, t_true, iters, every = ICP_CASES[case]
    max_corr = 25.0
    pts = _walls(n, half, seed, slope)
    R_true = np.asarray(jso3.quat_to_mat(jso3.exp_axis(jnp.asarray(rot,
                                                                   F64))))
    src = ((pts - np.asarray(t_true)) @ R_true)[::every]
    ok = np.ones(n, bool)
    ok[::37] = False
    src_ok = ok[::every].copy()
    src_ok[3] = False
    Rj, tj, fj = jlc.icp_align(jnp.asarray(src), jnp.asarray(src_ok),
                               jnp.asarray(pts), jnp.asarray(ok), iters=iters,
                               max_corr=max_corr)
    Rt, tt, ft = tlc.icp_align(_t(src), _t(src_ok), _t(pts), _t(ok),
                               iters=iters, max_corr=max_corr)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-6)
    assert float(ft) == pytest.approx(float(fj), rel=1e-6, abs=1e-9)
    np.testing.assert_allclose(Rt.numpy(), R_true, atol=0.03)
    assert float(ft) < 0.05


def test_rotation_of_matches_svd():
    """The port's closed-form Kabsch rotation equals the reference's SVD
    rotation on random cross-covariances, reflections included, and on
    the zero matrix."""
    rng = np.random.default_rng(3)
    for k in range(40):
        S = rng.normal(size=(3, 3)) * 10 ** rng.uniform(-3, 3)
        if k % 4 == 0:
            S[:, 2] *= 1e-4            # a nearly planar cloud
        w = np.ones(3)
        src, dst = np.eye(3), S.T     # S = dst^T src for unit weights
        Rj, _ = jlc._umeyama(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(w))
        Rt, _ = tlc._umeyama(_t(src), _t(dst), _t(w))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0,
                                   atol=1e-9, err_msg=str(k))
    np.testing.assert_array_equal(tlc.rotation_of(torch.zeros(3, 3)).numpy(),
                                  np.eye(3))


# --- detection and the consistency gate -----------------------------------

def _track(positions, times):
    store = jkf.empty_store(VLP16.replace(max_keyframes=64), 8, 8, 8, F64)
    for p, t in zip(positions, times):
        store = jkf.add_keyframe(store, jnp.asarray(p, F64),
                                 jnp.asarray([1.0, 0, 0, 0], F64), t,
                                 jnp.zeros((8, 3), F64), jnp.zeros(8, bool),
                                 jnp.zeros((8, 3), F64), jnp.zeros(8, bool))
    return store


def _store_t(store):
    return tkf.KeyframeStore(*(_t(x) for x in store))


def test_add_keyframe_short_clouds():
    """The store's writer takes clouds narrower than its rows (a config
    whose feature sets are narrower than the store's caps, as
    `--feature-scale 0.1` gives): their leading rows are written and the
    rest of the slot kept, as the reference's `dynamic_update_slice`
    keeps it, also in a slot that ring eviction reuses."""
    rng = np.random.default_rng(3)
    cfg = VLP16.replace(max_keyframes=2)
    js = jkf.empty_store(cfg, 8, 8, 8, F64)
    ts = tkf.empty_store(TCFG.replace(max_keyframes=2), 8, 8, 8,
                         torch.float64)
    for k, w in enumerate((8, 5, 3)):       # the third push evicts slot 0
        pos, quat = rng.normal(size=3), np.array([1.0, 0, 0, 0])
        clouds = [rng.normal(size=(w, 3)), rng.random(w) < 0.7,
                  rng.normal(size=(w, 3)), rng.random(w) < 0.7,
                  rng.normal(size=(w, 3)), rng.random(w) < 0.7]
        js = jkf.add_keyframe(js, jnp.asarray(pos), jnp.asarray(quat),
                              0.1 * k, *(jnp.asarray(c) for c in clouds))
        ts = tkf.add_keyframe(ts, _t(pos), _t(quat),
                              torch.tensor(0.1 * k, dtype=torch.float64),
                              *(_t(c) for c in clouds))
    for name, a, b in zip(ts._fields, ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert bool(ts.corner_valid[0, 3:].any())   # kept from the first push


@pytest.mark.parametrize("track", ["revisit", "recent"])
def test_detect_loop(track):
    if track == "revisit":
        pos = [[0, 0, 0], [10, 0, 0], [20, 0, 0], [10, 5, 0], [1.0, 0.5, 0]]
        times = [0.0, 10.0, 20.0, 30.0, 45.0]
    else:
        pos = [[0, 0, 0], [0.5, 0, 0], [1.0, 0, 0]]
        times = [0.0, 1.0, 2.0]
    store = _track(pos, times)
    cur = len(pos) - 1
    ij, fj = jlc.detect_loop(store, jnp.int32(cur), times[-1], VLP16)
    it, ft = tlc.detect_loop(_store_t(store), torch.tensor(cur), times[-1],
                             TCFG)
    assert bool(ft) == bool(fj) == (track == "revisit")
    assert int(it) == int(ij)
    assert it.dtype == torch.int32
    for a, b in ((0, cur), (1, 3), (2, 2)):
        assert float(tlc.path_length(_store_t(store), a, b)) == pytest.approx(
            float(jlc.path_length(store, a, b)), rel=1e-12, abs=1e-12)
        assert float(tlc.consistency_bound(_store_t(store), a, b, TCFG)) == (
            pytest.approx(float(jlc.consistency_bound(store, a, b, VLP16)),
                          rel=1e-12))
