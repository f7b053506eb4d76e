"""The keyframe store sharded along the keyframe axis
(lins_tpu_torch/parallel/shard_map_store.py) on CPU shards, the counterpart
of tests/test_parallel.py's sharded-store tests:

  * the one-shot window assembly `assemble_local_map` on the reference's
    store (16 slots, 10 keyframes, caps 32/64) sharded over 8 shards equals
    lins_tpu's unsharded one within 1e-6 (masks equal) and the port's
    unsharded one bit for bit;
  * the window rebuild and the loop attempt's clouds from a 4-shard store
    equal the unsharded ones bit for bit, for windows across each shard
    seam and across the ring's wrap (20 keyframes in 16 slots);
  * writes into each shard, and a store that does not split evenly;
  * `LinsSlam.run_replay` with the store sharded over 4 shards equals the
    unsharded run bit for bit (the reference's heavy test, on the port);
  * a checkpoint of a sharded mapper equals the unsharded one key by key
    and loads back into a sharded mapper.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import VLP16 as J_VLP16
from lins_tpu.mapping import keyframes as jkf
from lins_tpu_torch.config import TINY, VLP16
from lins_tpu_torch.datasets import synthetic as syn
from lins_tpu_torch.graph import loop_closure as lc
from lins_tpu_torch.mapping import keyframes as kf
from lins_tpu_torch.mapping import local_map as lmn
from lins_tpu_torch.mapping import mapper as tmapper
from lins_tpu_torch.mapping import scan2map as tscan2map
from lins_tpu_torch.mapping.mapper import LinsMapper
from lins_tpu_torch.parallel.multihost import Mesh
from lins_tpu_torch.parallel.shard_map_store import (ShardedRows,
                                                     shard_store,
                                                     unshard_store)
from lins_tpu_torch.slam import LinsSlam
from lins_tpu_torch.utils import checkpoint, tree
from lins_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)

F64 = torch.float64


def _cpu_mesh(n):
    return Mesh(["cpu"] * n)


def _rows(seed, n_kf, caps):
    """Seeded keyframes: (pos, quat, time, clouds, valid masks) each, the
    masks with some points off."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_kf):
        clouds = [rng.uniform(-5, 5, (c, 3)) for c in caps]
        valid = [rng.random(c) < 0.9 for c in caps]
        q = rng.normal(size=4)
        out.append((rng.uniform(-3, 3, 3), q / np.linalg.norm(q), float(i),
                    clouds, valid))
    return out


def _port_store(cfg, caps, rows, outlier=True):
    store = kf.empty_store(cfg, *caps, dtype=F64, device="cpu")
    for pos, q, t, clouds, valid in rows:
        c = [torch.as_tensor(x) for x in clouds]
        v = [torch.as_tensor(x) for x in valid]
        extra = (c[2], v[2]) if outlier else ()
        store = kf.add_keyframe(
            store, torch.as_tensor(pos), torch.as_tensor(q),
            torch.tensor(t, dtype=F64), c[0], v[0], c[1], v[1], *extra)
    return store


def _equal(a, b):
    """Every tensor of two containers equal bit for bit."""
    got, want = [], []
    tree_map(got.append, a)
    tree_map(want.append, b)
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_assemble_local_map_matches_reference():
    """tests/test_parallel.py's store: 10 keyframes in 16 slots, caps
    32/64, the window of 8 ending at id 9."""
    rows = _rows(0, 10, (32, 64))
    jstore = jkf.empty_store(J_VLP16.replace(max_keyframes=16), 32, 64,
                             dtype=jnp.float64)
    for pos, q, t, clouds, valid in rows:
        jstore = jkf.add_keyframe(
            jstore, jnp.asarray(pos), jnp.asarray(q), t,
            jnp.asarray(clouds[0]), jnp.asarray(valid[0]),
            jnp.asarray(clouds[1]), jnp.asarray(valid[1]))
    want = jkf.assemble_local_map(jstore, jnp.int32(9), 8, 256, 512, 0.2,
                                  0.4)

    cfg = VLP16.replace(max_keyframes=16)
    store = _port_store(cfg, (32, 64, 2048), [
        (p, q, t, c[:2], v[:2]) for p, q, t, c, v in rows], outlier=False)
    center = torch.tensor(9, dtype=torch.int32)
    plain = kf.assemble_local_map(store, center, 8, 256, 512, 0.2, 0.4)
    sharded = shard_store(store, _cpu_mesh(8))
    assert all(len(getattr(sharded, f).parts) == 8
               for f in ("corner", "surf_valid", "outlier"))
    got = kf.assemble_local_map(sharded, center, 8, 256, 512, 0.2, 0.4)
    _equal(got, plain)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == bool:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    assert int(got[1].sum()) > 100 and int(got[3].sum()) > 100


def test_gather_window_matches_reference():
    """The window's slots and mask before, at and after the ring's wrap."""
    K = 16
    jstore = jkf.empty_store(J_VLP16.replace(max_keyframes=K), 8, 8, 8)
    store = kf.empty_store(VLP16.replace(max_keyframes=K), 8, 8, 8,
                           device="cpu")
    for count, center in ((3, 2), (10, 9), (20, 19), (20, 11)):
        js = jstore._replace(count=jnp.int32(count))
        ts = store._replace(count=torch.tensor(count, dtype=torch.int32))
        want = jkf.gather_window(js, jnp.int32(center), 8)
        got = kf.gather_window(ts, torch.tensor(center, dtype=torch.int32),
                               8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# 20 keyframes in 16 slots over 4 shards of 4: windows of 8 ids ending at
# each center cross the seams at slots 4, 8, 12 and the wrap 15 -> 0
SEAM_CENTERS = (5, 9, 13, 19)
SEAM_CFG = VLP16.replace(max_keyframes=16, history_keyframe_search_num=3,
                         loop_time_gate=1.0)
SEAM_CAPS = (24, 40, 16)


@pytest.fixture(scope="module")
def seam_stores():
    store = _port_store(SEAM_CFG, SEAM_CAPS, _rows(1, 20, SEAM_CAPS))
    return store, shard_store(store, _cpu_mesh(4))


@pytest.mark.parametrize("center", SEAM_CENTERS)
def test_rebuild_window_across_seams(seam_stores, center):
    store, sharded = seam_stores
    gp = lmn.grid_params(SEAM_CFG)
    lm = lmn.empty_local_map(SEAM_CFG, 8, *SEAM_CAPS, F64, gp, "cpu")
    ids = torch.arange(center - 7, center + 1, dtype=torch.int32)
    oldest = int(store.count) - store.capacity
    ok = ids >= oldest
    wslots = torch.remainder(ids, 8).to(torch.int32)
    want = lmn.rebuild_window(lm, store, ids, ok, wslots, gp)
    got = lmn.rebuild_window(lm, sharded, ids, ok, wslots, gp)
    _equal(got, want)
    assert int(got.n_surf) > 0 and int(got.n_corner) > 0


@pytest.mark.parametrize("center", SEAM_CENTERS)
def test_loop_clouds_across_seams(seam_stores, center):
    store, sharded = seam_stores
    idx = torch.tensor(center - 2, dtype=torch.int32)
    cur = torch.tensor(center, dtype=torch.int32)
    t = torch.tensor(100.0, dtype=F64)
    want = lc.loop_clouds(store, idx, cur, t, SEAM_CFG, 512, 256)
    got = lc.loop_clouds(sharded, idx, cur, t, SEAM_CFG, 512, 256)
    _equal(got, want)
    assert int(got[1].sum()) > 0 and int(got[3].sum()) > 0


@pytest.mark.parametrize("slot", [0, 3, 4, 9, 15])
def test_put_row_into_each_shard(slot):
    caps = (6, 10, 4)
    store = _port_store(SEAM_CFG, caps, _rows(2, 16, caps))
    sharded = shard_store(store, _cpu_mesh(4))
    rng = np.random.default_rng(slot)
    i = torch.tensor(slot)
    for field, row in (("corner", torch.as_tensor(rng.normal(size=(6, 3)))),
                       ("surf", torch.as_tensor(rng.normal(size=(7, 3)))),
                       ("outlier_valid", True)):
        want = kf.put_row(getattr(store, field), i, row)
        got = kf.put_row(getattr(sharded, field), i, row)
        assert isinstance(got, ShardedRows) and len(got.parts) == 4
        assert torch.equal(got.gather(), want)
        assert torch.equal(kf.take_row(got, i), kf.take_row(want, i))


def test_uneven_split_raises():
    store = kf.empty_store(VLP16.replace(max_keyframes=10), 4, 4, 4,
                           device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        shard_store(store, _cpu_mesh(4))
    with pytest.raises(ValueError, match="axis"):
        shard_store(store, _cpu_mesh(2), axis="kf")


REPLAY_CFG = TINY.replace(use_pallas=False, max_keyframes=32,
                          max_map_corner=8192, max_map_surf=16384)


@pytest.fixture(scope="module")
def replays():
    """The 16-scan TINY replay (chunks of 8), unsharded and with the store
    sharded over 4 CPU shards (the reference's test: its 4 keyframes sit in
    shard 0) and over 16 (2 slots a shard: every window read crosses
    seams)."""
    data = syn.generate_sequence(REPLAY_CFG, n_scans=16, kind="gentle",
                                 speed=1.5, device="cpu")
    out = {}
    for shards in (0, 4, 16):
        slam = LinsSlam(REPLAY_CFG, device="cpu", dtype=F64)
        if shards:
            slam.mapper.shard_store_over(_cpu_mesh(shards))
        slam.run_replay(data, chunk=8)
        out[shards] = slam
    return out


@pytest.mark.parametrize("shards", [4, 16])
def test_run_replay_sharded_matches_unsharded(replays, shards):
    plain, sharded = replays[0], replays[shards]
    _, p0, q0 = plain.trajectory_arrays()
    _, p1, q1 = sharded.trajectory_arrays()
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(q1, q0)
    st = sharded.mapper.state.store
    assert int(st.count) >= 4 and isinstance(st.surf, ShardedRows)
    assert (len(st.surf.parts) == shards
            and st.surf.parts[0].shape[0] == 32 // shards)
    _equal(unshard_store(st), plain.mapper.state.store)
    _equal(sharded.mapper.state.lmap, plain.mapper.state.lmap)


def test_card_form_replay_sharded_matches_unsharded(replays):
    """The replay with the mapper's device branches (keyframe add,
    compaction rebuild, the loop attempt's solve and rewrite, its guard)
    computed and selected as on the card (`tree.select_cond`, whose selects
    then take the sharded fields' parts leaf by leaf), the store over 16
    shards: a select gives the branch's own bits, so this equals the
    unsharded replay bit for bit."""
    data = syn.generate_sequence(REPLAY_CFG, n_scans=16, kind="gentle",
                                 speed=1.5, device="cpu")
    preds = []

    def card_cond(pred, branch, keep, span):
        preds.append(bool(pred))
        return tree.select_cond(pred, branch, keep)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmapper, "cond", card_cond)
        slam = LinsSlam(REPLAY_CFG, device="cpu", dtype=F64)
        slam.mapper.shard_store_over(_cpu_mesh(16))
        slam.run_replay(data, chunk=8)
    _, p0, q0 = replays[0].trajectory_arrays()
    _, p1, q1 = slam.trajectory_arrays()
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(q1, q0)
    assert True in preds and False in preds and len(slam.mapper.loop_info)
    _equal(unshard_store(slam.mapper.state.store),
           replays[0].mapper.state.store)


def test_checkpoint_of_sharded_mapper(replays, tmp_path):
    paths = {}
    for shards, slam in replays.items():
        paths[shards] = str(tmp_path / f"ckpt_{shards}.npz")
        checkpoint.save_state(paths[shards], slam.odometry, slam.mapper)
    a, b = np.load(paths[0]), np.load(paths[4])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    loaded = {}
    for shards in (0, 4):
        m = LinsMapper(REPLAY_CFG, device="cpu", dtype=F64)
        if shards:
            m.shard_store_over(_cpu_mesh(shards))
        checkpoint.load_state(paths[4], mapper=m)
        loaded[shards] = m
    st = loaded[4].state.store
    assert isinstance(st.corner, ShardedRows) and len(st.corner.parts) == 4
    _equal(unshard_store(st), replays[0].mapper.state.store)
    _equal(loaded[4].state.lmap, loaded[0].state.lmap)
    np.testing.assert_array_equal(
        checkpoint.global_map_points(loaded[4]),
        checkpoint.global_map_points(replays[0].mapper))
