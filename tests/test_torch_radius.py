"""Port parity for the radius-selected local map (the reference's
loopClosureEnableFlag=false mode, `run_slam.py --no-loop-closure`, and
`lc_map_mode="radius"`), lins_tpu_torch against lins_tpu in float64 on the
CPU:

  * `select_radius` on hand-made keyframe stores: two clusters, ties at the
    W-th distance, fewer than W live keyframes, keyframes evicted after the
    ring overflowed, a keyframe exactly at the radius, random lattices of
    ties; the kept ids exactly;
  * a TINY radius replay (14 turny scans, the selection changing twice):
    fused positions within 1e-6 m, per-step metrics equal, the final state
    close;
  * one mapping step from the reference's state after a resume (the local
    map left empty, so the selection changes), in the form the card runs
    it (every device branch computed and selected);
  * `final_solve` with lc_map_mode "radius" from a handed-over reference
    state, keyframe poses within 1e-9; and no solve with loop closure off.

The reference's LinsSlam keeps its mapper at float32, so its float64 mapper
is set in by hand."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.mapping import keyframes as jkf
from lins_tpu.mapping import local_map as jlmn
from lins_tpu.mapping import mapper as jmapper
from lins_tpu.slam import LinsSlam as JSlam
from lins_tpu.slam import run_sequence as j_run
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.mapping import keyframes as tkf
from lins_tpu_torch.mapping import local_map as tlmn
from lins_tpu_torch.mapping import mapper as tmapper
from lins_tpu_torch.mapping import scan2map as tscan2map
from lins_tpu_torch.slam import LinsSlam as TSlam
from lins_tpu_torch.utils import tree

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

# a 16-keyframe store and an 8-keyframe window keep the reference's
# programs small to compile
JCFG = TINY.replace(loop_closure_enabled=False, max_keyframes=16)
TCFG = SlamConfig.from_dict(JCFG.to_dict())
N_SCANS = 14
CHUNK = 6
MAP_KW = dict(corner_cap=256, surf_cap=1024, map_corner_cap=4096,
              map_surf_cap=8192, n_window=8)
POS_TOL = 1e-6
METRICS = ("iters", "n_matches", "n_refresh", "keyframe_added",
           "query_overflow")


# --------------------------------------------------------------- selection

def _stores(K, pos, kf_id):
    """The same hand-made keyframe store in both packages: positions and
    ids by slot (-1 for a dead slot), the count one past the largest id."""
    cfg = TINY.replace(max_keyframes=K)
    count = int(max(kf_id)) + 1
    js = jkf.empty_store(cfg, 4, 8, 8, jnp.float64)._replace(
        pos=jnp.asarray(pos, jnp.float64), kf_id=jnp.asarray(kf_id, jnp.int32),
        count=jnp.int32(count))
    ts = tkf.empty_store(SlamConfig.from_dict(cfg.to_dict()), 4, 8, 8,
                         torch.float64)._replace(
        pos=torch.as_tensor(np.asarray(pos, np.float64)),
        kf_id=torch.as_tensor(np.asarray(kf_id, np.int32)),
        count=torch.tensor(count, dtype=torch.int32))
    return js, ts


def _select_both(js, ts, cur, radius, W):
    want = jlmn.select_radius(js, jnp.asarray(cur, jnp.float64), radius, W)
    got = tlmn.select_radius(ts, torch.as_tensor(np.asarray(cur, np.float64)),
                             radius, W)
    want = tuple(np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[0].dtype == torch.int32
    return want[0]


def test_select_two_clusters():
    """The reference's own case (tests/test_mapping.py): two clusters
    100 m apart, only the near one within 50 m."""
    pos = [[(0.0 if i < 4 else 100.0) + i * 0.1, 0, 0] for i in range(8)]
    pos += [[0, 0, 0]] * 8
    js, ts = _stores(16, pos, list(range(8)) + [-1] * 8)
    ids = _select_both(js, ts, [0, 0, 0], 50.0, 6)
    assert ids.tolist() == [-1, -1, 0, 1, 2, 3]


# eight offsets at exactly 5 m (integer coordinates: the distances are
# exact), two at 1 m, and a far one
_TIED = [[3, 4, 0], [4, 3, 0], [0, 3, 4], [5, 0, 0], [0, 5, 0], [0, 0, 5],
         [-3, -4, 0], [4, 0, 3]]
_NEAR = [[1, 0, 0], [0, 0, -1]]


@pytest.mark.parametrize("W", [3, 4, 7, 10, 12])
def test_select_ties_at_the_last_place(W):
    """Ties at the W-th distance keep the lower slot, as lax.top_k does.
    The store has overflowed its ring (slot s holds id s + 16 for s < 5),
    so slot order and id order differ."""
    cur = np.asarray([10.0, -3.0, 2.0])
    offs = _NEAR[:1] + _TIED[:5] + _NEAR[1:] + _TIED[5:] + [[30, 0, 0]] * 6
    pos = cur + np.asarray(offs, float)
    kf_id = [s + 16 if s < 5 else s for s in range(16)]
    js, ts = _stores(16, pos, kf_id)
    ids = _select_both(js, ts, cur, 20.0, W)
    assert (ids >= 0).sum() == min(W, 10)


def test_select_fewer_live_than_the_window():
    pos = np.zeros((16, 3))
    pos[[2, 7, 11]] = [[1, 0, 0], [0, 2, 0], [0, 0, 3]]
    kf_id = [-1] * 16
    kf_id[2], kf_id[7], kf_id[11] = 18, 23, 27
    js, ts = _stores(16, pos, kf_id)
    ids = _select_both(js, ts, [0, 0, 0], 50.0, 6)
    assert ids.tolist() == [-1, -1, -1, 18, 23, 27]


def test_select_window_wider_than_the_store():
    """A window wider than the store (the reference's top_k refuses it)
    pads with -1."""
    _, ts = _stores(4, [[0, 0, 0], [1, 0, 0], [9, 0, 0], [2, 0, 0]],
                    [5, 6, 7, -1])
    ids, ok = tlmn.select_radius(ts, torch.zeros(3, dtype=torch.float64),
                                 5.0, 6)
    assert ids.tolist() == [-1, -1, -1, -1, 5, 6]
    assert ok.tolist() == [False] * 4 + [True] * 2


def test_select_at_the_radius_and_after_eviction():
    """20 keyframes through a 16-slot ring with the packages' own
    add_keyframe (ids 0-3 evicted); one keyframe exactly at the radius is
    not kept (distance < radius)."""
    cfg = TINY.replace(max_keyframes=16)
    js = jkf.empty_store(cfg, 4, 8, 8, jnp.float64)
    ts = tkf.empty_store(SlamConfig.from_dict(cfg.to_dict()), 4, 8, 8,
                         torch.float64)
    for i in range(20):
        p = [float(i % 7) * 2.0, 0.0, 5.0 if i == 9 else 0.0]
        js = jkf.add_keyframe(js, jnp.asarray(p), jnp.asarray([1.0, 0, 0, 0]),
                              float(i), jnp.zeros((4, 3)), jnp.ones(4, bool),
                              jnp.zeros((8, 3)), jnp.ones(8, bool))
        ts = tkf.add_keyframe(
            ts, torch.tensor(p, dtype=torch.float64),
            torch.tensor([1.0, 0, 0, 0], dtype=torch.float64),
            torch.tensor(float(i), dtype=torch.float64),
            torch.zeros((4, 3), dtype=torch.float64),
            torch.ones(4, dtype=torch.bool),
            torch.zeros((8, 3), dtype=torch.float64),
            torch.ones(8, dtype=torch.bool))
    np.testing.assert_array_equal(ts.kf_id.numpy(), np.asarray(js.kf_id))
    ids = _select_both(js, ts, [4.0, 0.0, 0.0], 5.0, 8)
    assert 9 not in ids.tolist() and min(ids[ids >= 0]) >= 4


@pytest.mark.parametrize("seed", range(4))
def test_select_random_lattices(seed):
    """Keyframes on a small integer lattice (many equal distances), random
    dead slots and ids, random windows and radii."""
    rng = np.random.default_rng(seed)
    K = 64
    pos = rng.integers(-3, 4, size=(K, 3)).astype(float)
    kf_id = rng.permutation(K) + 40
    kf_id[rng.random(K) < 0.3] = -1
    js, ts = _stores(K, pos, kf_id.tolist())
    for W in (5, 16, 50):
        _select_both(js, ts, rng.integers(-2, 3, 3).astype(float),
                     float(rng.integers(2, 6)), W)


# ------------------------------------------------------- mapping and replay

@pytest.fixture(scope="module")
def data():
    return jsyn.generate_sequence(JCFG, n_scans=N_SCANS, kind="turny",
                                  speed=1.0)


def _jslam():
    s = JSlam(JCFG, dtype=jnp.float64, enable_mapping=False)
    s.mapper = jmapper.LinsMapper(JCFG, dtype=jnp.float64, **MAP_KW)
    return s


def _card_form(mp, preds):
    """Patch the mapping modules to run as on the card: each device branch
    computed and selected (`tree.select_cond`), its predicate recorded in
    `preds` by module, and the scan-to-map trips never stopping early."""
    for mod in (tmapper, tscan2map):
        def card_cond(pred, branch, keep, span, name=mod.__name__):
            preds.setdefault(name, []).append(bool(pred))
            return tree.select_cond(pred, branch, keep)
        mp.setattr(mod, "cond", card_cond)
    mp.setattr(tscan2map, "may_stop", lambda active: False)


@pytest.fixture(scope="module")
def replayed(data):
    """The reference streaming (it compiles fewer programs than its replay,
    and equals it to float rounding), and the port's replay with each
    step's radius selection recorded."""
    js = j_run(_jslam(), data)
    selections = []
    select = tlmn.select_radius

    def recorded(*args):
        out = select(*args)
        selections.append(tuple(out[0].tolist()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlmn, "select_radius", recorded)
        ts = TSlam(TCFG, dtype=torch.float64, device="cpu",
                   **MAP_KW).run_replay(data, chunk=CHUNK)
    return js, ts, selections


def test_radius_mapper_constructs():
    """Both radius modes construct (the port refused them before the
    radius map was ported) and pick the radius map."""
    for cfg in (TCFG, TCFG.replace(loop_closure_enabled=True,
                                   lc_map_mode="radius")):
        m = tmapper.LinsMapper(cfg, device="cpu", **MAP_KW)
        assert tmapper._radius_map(cfg)
        assert m._loops() == cfg.loop_closure_enabled


def test_replay_selection_changes(replayed):
    """The radius window was re-selected (and rebuilt) at least twice."""
    _, ts, selections = replayed
    empty = (-1,) * ts.mapper.n_window
    changes = sum(a != b for a, b in zip([empty] + selections, selections))
    assert changes >= 2, selections
    assert tuple(ts.mapper.state.lmap.sel.tolist()) == selections[-1]


def test_replay_trajectory(replayed):
    js, ts = replayed[:2]
    jt, jp, jq = js.trajectory_arrays()
    tt, tp, tq = ts.trajectory_arrays()
    assert len(tp) == N_SCANS - 1
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-7)
    assert np.linalg.norm(tp[-1] - tp[0]) > 1.0      # it moved


@pytest.mark.parametrize("key", METRICS)
def test_replay_step_metrics(replayed, key):
    js, ts = replayed[:2]
    want = [int(np.asarray(m[key])) for m in js.mapper.metrics]
    got = [int(m[key]) for m in ts.mapper.metrics]
    assert got == want
    assert len(got) >= 4
    if key == "n_matches":
        assert max(got) > 300


def _leaves(state, prefix=""):
    """(name, numpy array) of every tensor/array leaf of a MapperState."""
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


def _assert_state_close(jstate, tstate, tol=1e-6):
    want = dict(_leaves(jstate))
    got = dict(_leaves(tstate))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_replay_final_state(replayed):
    js, ts = replayed[:2]
    assert int(ts.mapper.state.store.count) >= 3
    _assert_state_close(js.mapper.state, ts.mapper.state)


def test_step_after_resume_card_form(replayed):
    """Both packages take the reference's final state with the local map
    left empty, as a resumed checkpoint has it (`rebuild_local_map` defers
    a radius map to the next step), and run one more mapping step on the
    same pose and clouds; the port in the card's form.  The selection
    changes, the window is rebuilt, and the states match field-wise."""
    js = replayed[0]
    state_np = jax.tree_util.tree_map(np.asarray, js.mapper.state)
    jm = jmapper.LinsMapper(JCFG, dtype=jnp.float64, **MAP_KW)
    jm._step = js.mapper._step        # compiled by the run
    jm.state = jax.tree_util.tree_map(jnp.asarray, state_np)
    jm.rebuild_local_map()
    tm = tmapper.LinsMapper(TCFG, dtype=torch.float64, device="cpu",
                            **MAP_KW)
    tm.load_numpy_state(state_np)
    tm.rebuild_local_map()
    assert (tm.state.lmap.sel == -1).all()
    _assert_state_close(jm.state, tm.state, tol=0)

    odo = js.odometry
    pos = np.asarray(odo.global_state.rn) + np.asarray([0.2, -0.1, 0.02])
    quat = np.asarray(odo.global_state.qbn)
    clouds = [np.asarray(c[k]) for c in (odo.last_corner, odo.last_surf,
                                         odo.last_outlier)
              for k in ("xyz", "valid")]
    rp = np.asarray([0.01, -0.02])
    t = float(np.asarray(js.mapper.state.store.time).max()) + 0.3
    jp, jq = jm.process(t, jnp.asarray(pos), jnp.asarray(quat),
                        *(jnp.asarray(c) for c in clouds), imu_rp=rp)
    preds = {}
    with pytest.MonkeyPatch.context() as mp:
        _card_form(mp, preds)
        tp, tq = tm.process(t, torch.as_tensor(pos), torch.as_tensor(quat),
                            *(torch.as_tensor(c) for c in clouds), imu_rp=rp)
    # the selection changed (first), then the keyframe gate; each branch
    # site of scan-to-map saw both outcomes
    assert preds[tmapper.__name__][0]
    seen = preds[tscan2map.__name__]
    assert any(seen) and not all(seen)
    assert (tm.state.lmap.sel >= 0).sum() == int(js.mapper.state.store.count)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=POS_TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-7)
    for key in METRICS:
        assert int(tm.metrics[-1][key]) == int(np.asarray(
            jm.metrics[-1][key])), key
    _assert_state_close(jm.state, tm.state)


def test_final_solve_radius(replayed):
    """final_solve over a handed-over reference state whose keyframe
    positions were disturbed, in loop-closure mode with lc_map_mode
    "radius": the solve pulls them back and rebuilds the current radius
    selection at the corrected poses; keyframe poses within 1e-9."""
    js = replayed[0]
    jcfg = JCFG.replace(loop_closure_enabled=True, lc_map_mode="radius",
                        loop_attempts=False)
    tcfg = SlamConfig.from_dict(jcfg.to_dict())
    state_np = jax.tree_util.tree_map(np.asarray, js.mapper.state)
    store = state_np.store
    rng = np.random.default_rng(3)
    live = store.kf_id >= 0
    pos = store.pos + np.where(live[:, None],
                               rng.normal(scale=0.05, size=store.pos.shape),
                               0.0)
    state_np = state_np._replace(store=store._replace(pos=pos))
    jm = jmapper.LinsMapper(jcfg, dtype=jnp.float64, **MAP_KW)
    jm.state = jax.tree_util.tree_map(jnp.asarray, state_np)
    jm.final_solve()
    tm = tmapper.LinsMapper(tcfg, dtype=torch.float64, device="cpu",
                            **MAP_KW)
    tm.load_numpy_state(state_np)
    tm.final_solve()
    got, want = tm.state.store, jm.state.store
    moved = np.abs(np.asarray(want.pos) - pos)[live].max()
    assert moved > 1e-3
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tm.state.lmap.sel.numpy(),
                                  np.asarray(state_np.lmap.sel))
    _assert_state_close(jm.state, tm.state)

    # with loop closure off the graph is never solved
    off = tmapper.LinsMapper(TCFG, dtype=torch.float64, device="cpu",
                             **MAP_KW)
    off.load_numpy_state(state_np)
    before = off.state
    off.final_solve()
    assert off.state is before
