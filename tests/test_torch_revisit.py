"""Port parity for one loop-closure attempt in float64 on the CPU,
lins_tpu_torch against lins_tpu: `LinsMapper.maybe_close_loop`,
`try_close_loop` and `final_solve` on the constructed out-and-back revisit
of tests/test_graph.py, started from the reference's state; accepted and
solved, rejected by the consistency gate, and without a candidate.  The
port runs on the CPU's taken branches and in the card's form (every branch
computed and selected, every ICP and scan-to-map trip run)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import VLP16
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.frontend import make_frontend
from lins_tpu.graph import pose_graph as jpg
from lins_tpu.mapping import keyframes as jkf
from lins_tpu.mapping import mapper as jmapper
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.graph import loop_closure as tlc
from lins_tpu_torch.mapping import mapper as tmapper
from lins_tpu_torch.mapping import scan2map as tscan2map
from lins_tpu_torch.utils import tree

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

F64 = jnp.float64

LOOP_CFG = VLP16.replace(max_points=28800, loop_time_gate=5.0)
TCFG = SlamConfig.from_dict(LOOP_CFG.to_dict())
# the current cloud cut to 256 points, the submap to 2048: the reference's
# nearest neighbour sorts a row of 8192 per cloud point on the CPU
CAPS = dict(corner_cap=256, surf_cap=1024, map_corner_cap=4096,
            map_surf_cap=8192, submap_cap=2048, cloud_cap=256)
# (current keyframe's drifted position, its time): accepted and solved; found
# but rejected by the consistency gate (a 3.6 m correction over a 39 m arc,
# where 2 m pass); no candidate old enough
REVISITS = {"accepted": ([0.5, 0.3, 0.0], 60.0),
            "rejected": ([3.0, 2.0, 0.0], 60.0),
            "none": ([0.5, 0.3, 0.0], 4.5)}


@pytest.fixture(scope="module")
def features():
    """Less-sharp and less-flat features of one static VLP-16 scan, cut to
    the mapper's capacities."""
    fe = make_frontend(LOOP_CFG)
    data = jsyn.generate_sequence(LOOP_CFG, n_scans=1, kind="static",
                                  speed=0.0)
    feats = fe(jnp.asarray(data["scans_xyz"][0]),
               jnp.asarray(data["scans_n"][0]))[2]
    cc, sc = CAPS["corner_cap"], CAPS["surf_cap"]
    return (feats.less_sharp.xyz[:cc].astype(F64), feats.less_sharp.valid[:cc],
            feats.less_flat.xyz[:sc].astype(F64), feats.less_flat.valid[:sc])


_JIT = {}


def _jmapper():
    m = jmapper.LinsMapper(LOOP_CFG, dtype=F64, **CAPS)
    # later mappers of this configuration reuse the first one's programs
    setattr(m, "_loop_step", _JIT.setdefault("_loop_step", m._loop_step))
    return m


def _tmapper(state_np=None):
    m = tmapper.LinsMapper(TCFG, dtype=torch.float64, device="cpu", **CAPS)
    return m if state_np is None else m.load_numpy_state(state_np)


def _revisit_state(features, drift, t_cur):
    """tests/test_graph.py's out-and-back: keyframes at 0, 20 and 21 m
    (times 0, 10, 11 s), then the current one back near the start with
    injected drift; odometry edges between consecutive keyframes."""
    c, cv, s, sv = features
    st = _jmapper().state
    e = jnp.asarray([1.0, 0, 0, 0], F64)
    wr, wp = 1.0 / LOOP_CFG.pg_odom_rot_var, 1.0 / LOOP_CFG.pg_odom_pos_var
    poses = [[0.0, 0, 0], [20.0, 0, 0], [21.0, 0, 0], drift]
    times = [0.0, 10.0, 11.0, t_cur]
    for k in range(4):
        store = jkf.add_keyframe(st.store, jnp.asarray(poses[k], F64), e,
                                 times[k], c, cv, s, sv)
        edges = st.edges
        if k:
            edges = jpg.add_edge(edges, k - 1, k, jnp.asarray(
                np.subtract(poses[k], poses[k - 1]), F64), e, wr, wp)
        st = st._replace(store=store, edges=edges)
    return jax.tree_util.tree_map(np.asarray, st)


def _card_form(mp, preds):
    """Patch the loop-closure path to run as on the card: each device
    branch computed and selected (`tree.select_cond`), its predicate
    recorded by module, and the ICP and scan-to-map trips never stopping
    early."""
    for mod in (tlc, tmapper, tscan2map):
        def card_cond(pred, branch, keep, span, name=mod.__name__):
            preds.setdefault(name, []).append(bool(pred))
            return tree.select_cond(pred, branch, keep)
        mp.setattr(mod, "cond", card_cond)
    for mod in (tlc, tscan2map):
        mp.setattr(mod, "may_stop", lambda active: False)


@pytest.fixture(scope="module")
def attempts(features):
    """Per revisit: the reference's attempt, and the port's on the CPU's
    taken branches and in the card's form, all from the same state."""
    out = {}
    for name, (drift, t_cur) in REVISITS.items():
        st = _revisit_state(features, drift, t_cur)
        jm = _jmapper()
        jm.state = jax.tree_util.tree_map(jnp.asarray, st)
        j_info = jm.maybe_close_loop(t_cur)
        runs = {}
        for form in ("taken", "card"):
            tm = _tmapper(st)
            preds = {}
            with pytest.MonkeyPatch.context() as mp:
                if form == "card":
                    _card_form(mp, preds)
                info = tm.maybe_close_loop(t_cur)
            runs[form] = (tm, info, preds)
        out[name] = (st, jm, j_info, runs)
    return out


@pytest.mark.parametrize("form", ["taken", "card"])
@pytest.mark.parametrize("name", sorted(REVISITS))
def test_loop_attempt(attempts, name, form):
    """found / accepted / applied / matched id exact, fitness and corr_t
    close, and the mapper state after the attempt (corrected store, edges,
    window map, correction) equal to the reference's."""
    _, jm, j_info, runs = attempts[name]
    tm, info, _ = runs[form]
    for key in ("found", "accepted", "applied", "matched"):
        assert int(info[key]) == int(np.asarray(j_info[key])), key
    assert bool(info["found"]) == (name != "none")
    assert bool(info["accepted"]) == (name == "accepted")
    for key in ("fitness", "corr_t"):
        w = float(np.asarray(j_info[key]))
        g = float(info[key])
        assert g == w or abs(g - w) <= 1e-6 * max(1.0, abs(w)), key
    _assert_state_close(tm.state, jm.state)
    assert int(tm.state.n_loops) == (name == "accepted")


def test_loop_attempt_corrects_drift(attempts):
    tm = attempts["accepted"][3]["taken"][0]
    corrected = tm.state.store.pos[3].numpy()
    assert np.linalg.norm(corrected) < 0.5 * np.hypot(0.5, 0.3)
    # the loop edge: matched keyframe 0 -> current keyframe 3
    k = int(tm.state.edges.count) - 1
    assert (int(tm.state.edges.i[k]), int(tm.state.edges.j[k])) == (0, 3)
    # the rejected revisit was aligned: its correction is the drift
    info = attempts["rejected"][3]["taken"][1]
    assert abs(float(info["corr_t"]) - np.hypot(3.0, 2.0)) < 0.3


def test_card_form_selects_both_ways(attempts):
    """Across the revisits the card's form computed and selected both
    outcomes of align or skip (loop_closure) and of solve or not (mapper),
    and ran the polish's scan-to-map trips each time (their re-gather
    branch, never due on an aligned cloud, is covered by
    tests/test_torch_mapping.py)."""
    seen = {}
    for _, _, _, runs in attempts.values():
        for mod, preds in runs["card"][2].items():
            seen.setdefault(mod, []).extend(preds)
    for mod in (tlc, tmapper):
        assert any(seen[mod.__name__]) and not all(seen[mod.__name__]), \
            mod.__name__
    assert len(seen[tscan2map.__name__]) == 3 * TCFG.scan2map_iters


@pytest.mark.parametrize("name", ["accepted", "rejected"])
def test_try_close_loop(attempts, name):
    """The detection and alignment alone against what the reference's
    attempt measured: ids and gates exact; fitness, the correction, and
    for the accepted revisit the transform its loop edge carries."""
    st, jm, j_info, _ = attempts[name]
    tm = _tmapper(st)
    idx, found, accepted, t_rel, q_rel, fitness, corr_t = tlc.try_close_loop(
        tm.state.store, torch.tensor(3), torch.tensor(60.0,
                                                      dtype=torch.float64),
        TCFG, tm.submap_cap, tm.cloud_cap)
    assert int(idx) == int(np.asarray(j_info["matched"])) == 0
    assert bool(found)
    assert bool(accepted) == bool(np.asarray(j_info["accepted"]))
    for g, key in ((fitness, "fitness"), (corr_t, "corr_t")):
        assert float(g) == pytest.approx(float(np.asarray(j_info[key])),
                                         rel=1e-6, abs=1e-9), key
    if name == "accepted":
        k = int(np.asarray(jm.state.edges.count)) - 1
        np.testing.assert_allclose(t_rel.numpy(),
                                   np.asarray(jm.state.edges.t[k]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(q_rel.numpy(),
                                   np.asarray(jm.state.edges.q[k]), rtol=0,
                                   atol=1e-6)


def test_final_solve(attempts):
    """The final solve over every edge, with a loop edge that entered the
    graph without a solve (keyframe 3 is truly back at keyframe 0): both
    packages pull the drifted keyframe home alike."""
    st = attempts["accepted"][0]
    e = st.edges
    jedges = jpg.add_edge(jax.tree_util.tree_map(jnp.asarray, e), 0, 3,
                          jnp.zeros(3, F64), jnp.asarray([1.0, 0, 0, 0], F64),
                          1e4, 1e4)
    st = st._replace(edges=jax.tree_util.tree_map(np.asarray, jedges),
                     n_loops=np.int32(1))
    jm = _jmapper()
    jm.state = jax.tree_util.tree_map(jnp.asarray, st)
    jm.final_solve()
    tm = _tmapper(st)
    tm.final_solve()
    _assert_state_close(tm.state, jm.state)
    before = np.linalg.norm(st.store.pos[3])
    assert np.linalg.norm(tm.state.store.pos[3].numpy()) < 0.5 * before


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


def _assert_state_close(t_state, j_state):
    want = dict(_leaves(j_state))
    got = dict(_leaves(t_state))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
