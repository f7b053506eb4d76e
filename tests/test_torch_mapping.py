"""Port parity for the mapping slice in float64 on the CPU, lins_tpu_torch
against lins_tpu on the same numpy inputs:

  * one-shot `scan_to_map` on the same features;
  * `LinsSlam` with mapping (TINY sensor, recent-window map, no loop
    attempts) over a 20-scan turny sequence, streaming and replay: fused
    positions within 1e-6 m, per-step mapping metrics equal, the final
    MapperState close;
  * the same replay in the form the card runs it, on the CPU: every device
    branch (keyframe add, compaction rebuild, scan-to-map re-gather)
    computed and selected, and the scan-to-map trips run to their fixed
    count; held to the reference at the same tolerances;
  * one mapping step, and the window map's compaction rebuild, started
    from the reference's state (`mapper_state_from_numpy`); one step with
    the rebuild due, in the card's form equal to the branches taken;
  * the loop-closure entry points run, also on a store sharded over CPU
    shards (the radius-selected map is tests/test_torch_radius.py's, the
    sharded store tests/test_torch_shardstore.py's);
  * the port alone, streaming and replay: mapping bounds the odometry's
    drift.

The reference's LinsSlam keeps its mapper at float32, so its float64 mapper
is set in by hand.  Its selection runs the sort path (`use_pallas_select`
False, TINY's default): the reference kernel refuses float64 inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.mapping import mapper as jmapper
from lins_tpu.mapping.scan2map import scan_to_map as j_scan_to_map
from lins_tpu.slam import LinsSlam as JSlam
from lins_tpu.slam import run_sequence as j_run
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.frontend.pipeline import process_cloud
from lins_tpu_torch.geom import so3
from lins_tpu_torch.mapping import mapper as tmapper
from lins_tpu_torch.mapping import scan2map as tscan2map
from lins_tpu_torch.mapping.scan2map import scan_to_map as t_scan_to_map
from lins_tpu_torch.slam import LinsSlam as TSlam
from lins_tpu_torch.slam import ate_rmse as t_ate_rmse
from lins_tpu_torch.slam import run_sequence as t_run
from lins_tpu_torch.utils import tree

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

JCFG = TINY.replace(loop_attempts=False)
TCFG = SlamConfig.from_dict(JCFG.to_dict())
N_SCANS = 20
CHUNK = 6
MAP_KW = dict(corner_cap=256, surf_cap=1024, map_corner_cap=4096,
              map_surf_cap=8192)
POS_TOL = 1e-6
METRICS = ("iters", "n_matches", "n_refresh", "keyframe_added",
           "query_overflow")


@pytest.fixture(scope="module")
def data():
    return jsyn.generate_sequence(JCFG, n_scans=N_SCANS, kind="turny",
                                  speed=1.0)


_JITTED = {}


def _jslam():
    s = JSlam(JCFG, dtype=jnp.float64, enable_mapping=False)
    m = jmapper.LinsMapper(JCFG, dtype=jnp.float64, **MAP_KW)
    # the reference mapper jits per instance: later mappers of the same
    # configuration reuse the first one's compiled programs
    for name in ("_step", "_chunk_step"):
        setattr(m, name, _JITTED.setdefault(name, getattr(m, name)))
    s.mapper = m
    return s


def _tslam():
    return TSlam(TCFG, dtype=torch.float64, device="cpu", **MAP_KW)


@pytest.fixture(scope="module")
def streamed(data):
    return j_run(_jslam(), data), t_run(_tslam(), data)


@pytest.fixture(scope="module")
def replayed(data):
    return (_jslam().run_replay(data, chunk=CHUNK),
            _tslam().run_replay(data, chunk=CHUNK))


def _card_form(mp, preds):
    """Patch the mapping modules to run as on the card: each device branch
    computed and selected (`tree.select_cond`, the card's side of
    `tree.cond`), its predicate recorded in `preds` by module, and the
    scan-to-map trips never stopping early."""
    for mod in (tmapper, tscan2map):
        def card_cond(pred, branch, keep, span, name=mod.__name__):
            preds.setdefault(name, []).append(bool(pred))
            return tree.select_cond(pred, branch, keep)
        mp.setattr(mod, "cond", card_cond)
    mp.setattr(tscan2map, "may_stop", lambda active: False)


@pytest.fixture(scope="module")
def selected_run(replayed, data):
    preds = {}
    with pytest.MonkeyPatch.context() as mp:
        _card_form(mp, preds)
        ts = _tslam().run_replay(data, chunk=CHUNK)
    return replayed[0], ts, preds


@pytest.fixture(scope="module")
def selected(selected_run):
    return selected_run[:2]


def test_card_form_selects_both_ways(selected_run):
    """The card's form ran in the selected replay, and each branch site
    (keyframe add + rebuild in the mapper, the re-gather in scan-to-map)
    saw both outcomes of its predicate."""
    _, _, preds = selected_run
    for mod in (tmapper, tscan2map):
        seen = preds[mod.__name__]
        assert any(seen) and not all(seen), mod.__name__


@pytest.mark.parametrize("mode", ["streamed", "replayed", "selected"])
def test_fused_trajectory(mode, request):
    js, ts = request.getfixturevalue(mode)
    jt, jp, jq = js.trajectory_arrays()
    tt, tp, tq = ts.trajectory_arrays()
    assert len(tp) == N_SCANS - 1
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-7)
    assert np.linalg.norm(tp[-1] - tp[0]) > 1.0      # it moved
    assert len(ts.mapper.metrics) == len(js.mapper.metrics) >= 6


@pytest.mark.parametrize("mode", ["streamed", "replayed", "selected"])
@pytest.mark.parametrize("key", METRICS)
def test_mapping_step_metrics(mode, key, request):
    js, ts = request.getfixturevalue(mode)
    want = [int(np.asarray(m[key])) for m in js.mapper.metrics]
    got = [int(m[key]) for m in ts.mapper.metrics]
    assert got == want
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


def test_final_mapper_state(streamed):
    """Every leaf of the final state: integer and mask leaves exactly,
    floating leaves within 1e-6 absolute or relative (poses, clouds,
    centroids, and voxel sums, which add up several world points that
    carry the trajectory's differences)."""
    _assert_state_close(*streamed)


def test_final_mapper_state_selected(selected):
    """The same for the replay in the card's form."""
    _assert_state_close(*selected)


def _assert_state_close(js, ts):
    want = dict(_leaves(js.mapper.state))
    got = dict(_leaves(ts.mapper.state))
    assert set(got) == set(want)
    assert int(got["store.count"]) >= 3
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_step_from_reference_state(streamed, data):
    """The port takes over the reference's mapper state and both run one
    more mapping step on the same odometry pose and clouds."""
    js, _ = streamed
    jm = js.mapper
    state_np = jax.tree_util.tree_map(np.asarray, jm.state)
    tm = tmapper.LinsMapper(TCFG, dtype=torch.float64, device="cpu",
                            **MAP_KW)
    tm.load_numpy_state(state_np)
    rng = np.random.default_rng(0)
    odo = js.odometry
    pos = np.asarray(odo.global_state.rn) + np.asarray([0.25, -0.1, 0.02])
    quat = np.asarray(odo.global_state.qbn)
    clouds = [np.asarray(odo.last_corner["xyz"]),
              np.asarray(odo.last_corner["valid"]),
              np.asarray(odo.last_surf["xyz"]),
              np.asarray(odo.last_surf["valid"]),
              np.asarray(odo.last_outlier["xyz"]),
              np.asarray(odo.last_outlier["valid"])]
    rp = rng.normal(size=2) * 0.01
    t = float(np.asarray(jm.state.store.time).max()) + 0.3
    jm.last_time = tm.last_time = -np.inf
    jp, jq = jm.process(t, jnp.asarray(pos), jnp.asarray(quat),
                        *(jnp.asarray(c) for c in clouds), imu_rp=rp)
    tp, tq = tm.process(t, torch.as_tensor(pos), torch.as_tensor(quat),
                        *(torch.as_tensor(c) for c in clouds), imu_rp=rp)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=POS_TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-7)
    for key in METRICS:
        assert int(tm.metrics[-1][key]) == int(np.asarray(
            jm.metrics[-1][key])), key
    assert int(tm.metrics[-1]["n_matches"]) > 300
    assert int(tm.state.store.count) == int(np.asarray(jm.state.store.count))


@pytest.mark.parametrize("gate", [0.0, 1.0e9])
def test_step_card_form_equals_taken_branches(streamed, gate):
    """One mapping step from the reference's final state with the window
    map's compaction rebuild due: in the card's form (every branch computed
    and selected) it leaves the same state, leaf for leaf, as the branches
    taken on the CPU.  Gate 0 m adds a keyframe and so rebuilds; 1e9 m adds
    none."""
    js, _ = streamed
    cfg = TCFG.replace(keyframe_gate_meters=gate)
    state_np = jax.tree_util.tree_map(np.asarray, js.mapper.state)
    odo = js.odometry
    pos = torch.as_tensor(np.asarray(odo.global_state.rn) + [0.2, -0.1, 0.0])
    quat = torch.as_tensor(np.asarray(odo.global_state.qbn))
    clouds = [torch.as_tensor(np.asarray(c[k]))
              for c in (odo.last_corner, odo.last_surf, odo.last_outlier)
              for k in ("xyz", "valid")]
    t = float(np.asarray(js.mapper.state.store.time).max()) + 0.3
    runs = []
    for card in (False, True):
        m = tmapper.LinsMapper(cfg, dtype=torch.float64, device="cpu",
                               **MAP_KW)
        m.load_numpy_state(state_np)
        lm = m.state.lmap
        m.state = m.state._replace(lmap=lm._replace(
            pushes=torch.full_like(lm.pushes, cfg.map_rebuild_interval)))
        preds = {}
        with pytest.MonkeyPatch.context() as mp:
            if card:
                _card_form(mp, preds)
            m.process(t, pos, quat, *clouds)
        runs.append(m)
    taken, card = runs
    # the keyframe gate, then the rebuild inside the add (computed either
    # way in the card's form, and due)
    assert preds[tmapper.__name__] == [gate == 0.0, True]
    assert int(card.metrics[-1]["keyframe_added"]) == (gate == 0.0)
    assert int(card.state.lmap.pushes) == (0 if gate == 0.0 else
                                           cfg.map_rebuild_interval)
    want = dict(_leaves(taken.state))
    got = dict(_leaves(card.state))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    for key in METRICS:
        assert int(card.metrics[-1][key]) == int(taken.metrics[-1][key]), key


def test_rebuild_from_reference_state(streamed):
    """The compaction rebuild of the window map (which the short runs above
    never trigger) from the reference's final keyframe store."""
    js, _ = streamed
    jm = jmapper.LinsMapper(JCFG, dtype=jnp.float64, **MAP_KW)
    jm.state = js.mapper.state
    jm.rebuild_local_map()
    tm = tmapper.LinsMapper(TCFG, dtype=torch.float64, device="cpu",
                            **MAP_KW)
    tm.load_numpy_state(jax.tree_util.tree_map(np.asarray, js.mapper.state))
    tm.rebuild_local_map()
    want = dict(_leaves(jm.state.lmap))
    got = dict(_leaves(tm.state.lmap))
    assert set(got) == set(want)
    assert int(got["corner_vm.n_live"]) > 50
    assert int(got["surf_vm.n_live"]) > 50
    for name, w in want.items():
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_scan_to_map_one_shot(data):
    """One-shot scan_to_map: a scan's features against the same clouds as
    the map, from a perturbed pose."""
    xyz = torch.as_tensor(data["scans_xyz"][0])
    n = torch.as_tensor(int(data["scans_n"][0]))
    _, _, feats = process_cloud(xyz, n, TCFG)
    c = feats.less_sharp
    s = feats.less_flat
    cx, cv = c.xyz.double().numpy(), c.valid.numpy()
    sx, sv = s.xyz.double().numpy(), s.valid.numpy()
    t0 = np.asarray([0.2, -0.15, 0.1])
    q0 = so3.exp_axis(torch.as_tensor([0.02, -0.02, 0.05],
                                      dtype=torch.float64)).numpy()
    args = (t0, q0, cx, cv, sx, sv, cx, cv, sx, sv)
    want = j_scan_to_map(*(jnp.asarray(a) for a in args), JCFG)
    got = t_scan_to_map(*(torch.as_tensor(a) for a in args), TCFG)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=POS_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-7)
    assert [int(v) for v in got[2:]] == [int(np.asarray(v))
                                         for v in want[2:]]
    assert int(got[3]) > 100
    assert np.abs(got[0].numpy()).max() < 0.05       # it pulled back


def test_slice_3_entry_points_raise():
    """The loop-closure entry points of slice 3 run (TCFG has loop attempts
    off, so the attempt is skipped; on an empty store the final solve keeps
    the state), and so does the sharded store: over a mesh of 4 CPU shards
    the final solve keeps the count and the store stays sharded
    (tests/test_torch_shardstore.py holds it to the unsharded store)."""
    from lins_tpu_torch.parallel.multihost import Mesh
    from lins_tpu_torch.parallel.shard_map_store import ShardedRows

    m = tmapper.LinsMapper(TCFG, device="cpu", **MAP_KW)
    assert m.maybe_close_loop(1.0) is None
    count = int(m.state.store.count)
    m.final_solve()
    assert int(m.state.store.count) == count
    assert torch.isfinite(m.state.aft_pos).all()
    m.shard_store_over(Mesh(["cpu"] * 4))
    m.final_solve()
    assert int(m.state.store.count) == count
    surf = m.state.store.surf
    assert isinstance(surf, ShardedRows) and len(surf.parts) == 4
    assert surf.shape == (TCFG.max_keyframes, MAP_KW["surf_cap"], 3)


def test_mapping_bounds_drift(data, streamed, replayed):
    """The port alone: its streamed and its replayed runs with mapping end
    closer to ground truth than its odometry alone over the same drive, by
    the bounds of the reference's long-horizon test
    (tests/test_slam_integration.py::test_mapping_bounds_drift)."""
    R0 = so3.quat_to_mat(torch.as_tensor(np.asarray(data["gt_quat"][0]),
                                         dtype=torch.float64)).numpy()
    gt = np.asarray(data["gt_pos"])

    def ate(slam):
        _, ps, _ = slam.trajectory_arrays()
        assert len(ps) == N_SCANS - 1
        return t_ate_rmse(ps, gt[1:1 + len(ps)], (R0, gt[0]))

    odometry = TSlam(TCFG, dtype=torch.float64, device="cpu",
                     enable_mapping=False, **MAP_KW)
    ate_odo = ate(odometry.run_replay(data, chunk=CHUNK))
    for ate_map in (ate(streamed[1]), ate(replayed[1])):
        assert ate_map < 0.5 * ate_odo
        assert ate_map < 0.2


if __name__ == "__main__":
    # The reference package's own ATE on chip_smoke.py's sequence and
    # configuration (VLP-16, 6 + 4x32 gentle scans at 1.5 m/s), on the CPU
    # in float32 with the label and selection kernels off, as bench.py
    # configures it without a TPU:
    #     PYTHONPATH=. python tests/test_torch_mapping.py
    import json
    import time

    from lins_tpu.config import VLP16
    from lins_tpu.utils.trajectory import ate

    jax.config.update("jax_platforms", "cpu")
    cfg = VLP16.replace(max_points=28800, loop_attempts=False)
    seq = jsyn.generate_sequence(cfg, n_scans=134, kind="gentle", speed=1.5)
    out = {}
    for name, mapping in (("odometry", False), ("fused", True)):
        t0 = time.perf_counter()
        slam = JSlam(cfg, enable_mapping=mapping).run_replay(seq, chunk=32)
        _, ps, _ = slam.trajectory_arrays()
        out[f"{name}_ate_m"] = ate(ps, seq["gt_pos"][1:1 + len(ps)],
                                   align=True)
        out[f"{name}_s"] = time.perf_counter() - t0
    out["device"] = str(jax.devices()[0])
    print(json.dumps(out))
