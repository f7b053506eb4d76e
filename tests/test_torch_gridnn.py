"""The hash grid's functions off the mapper's path, lins_tpu_torch against
lins_tpu on the same seeded numpy inputs, on the CPU:

  * `build_grid_voxelized` (the voxel filter and the binning fused into one
    sort) at nb=27 and nb=8, with the reference's supercell and dense-corner
    cases and a cap that drops slots: `cells` slot for slot and `cnt`
    exactly, `n_voxels` equal, centroids within 1e-9 m in float64;
  * K3's plain version through `gather_candidates` on the port's fused grid
    against the reference's `gather_candidates` on its own fused grid;
  * `grid_knn`: distances equal, neighbours equal where a distance is not
    tied, invalid queries and an empty grid;
  * `gather_block`: the whole block exactly.

The reference functions run under `jax.jit` with their sizes static, as
its mapper runs them."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.ops import grid_nn as jgrid
from lins_tpu_torch.ops import grid_nn as tgrid
from lins_tpu_torch.ops import select as tsel

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

# float64 centroids are run means of prefix-sum differences, which XLA
# associates in another order than torch.cumsum
CENT_ATOL = 1e-9
# float64 squared distances: a few ulps (see test_grid_knn)
D2_RTOL = 1e-15


def _t(a):
    return torch.as_tensor(np.array(a))


def _clusters(seed, n_centers, per, scale, spread=20.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_centers, 3))
    return np.concatenate([c + rng.normal(scale=scale, size=(per, 3))
                           for c in centers])


def _dense_corner():
    """The reference's adversarial cell: every 0.2 m voxel of one 1.2 m
    cell occupied (216 centroids; tests/test_mapping.py:308-323)."""
    g = (np.arange(6) + 0.5) * 0.2
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def _points(case):
    """(points, valid, build_grid_voxelized keywords) of a named case."""
    rng = np.random.default_rng(len(case))
    if case == "supercell":          # tests/test_mapping.py:256-268
        pts = _clusters(3, 40, 30, 0.5)
        kw = dict(leaf=0.4, m=5, table=4096, cap=128, nb=8)
    elif case == "dense_corner":
        pts = _dense_corner()
        kw = dict(leaf=0.2, m=6, table=512, cap=224, nb=27)
    elif case == "cell27":
        pts = _clusters(5, 50, 80, 0.6, spread=15.0)
        kw = dict(leaf=0.2, m=6, table=2048, cap=216, nb=27)
    elif case == "dropped":          # cells hold more voxels than cap
        pts = _clusters(6, 30, 150, 0.5, spread=10.0)
        kw = dict(leaf=0.2, m=6, table=1024, cap=16, nb=27)
    else:                            # a map of leaf-boundary lattice points
        pts = rng.integers(-60, 60, (3000, 3)) * 0.2
        pts[::3] += rng.uniform(0, 0.2, (1000, 3))
        kw = dict(leaf=0.2, m=6, table=512, cap=64, nb=27)
    valid = rng.random(len(pts)) > 0.05
    if case == "dense_corner":
        valid[:] = True
    return pts, valid, kw


CASES = ["supercell", "dense_corner", "cell27", "dropped", "boundaries"]


def _both_grids(case):
    pts, valid, kw = _points(case)
    jg, jn = jax.jit(partial(jgrid.build_grid_voxelized, **kw))(
        jnp.asarray(pts), jnp.asarray(valid))
    tg, tn = tgrid.build_grid_voxelized(_t(pts), _t(valid), **kw)
    return pts, valid, kw, jg, jn, tg, tn


@pytest.mark.parametrize("case", CASES)
def test_build_grid_voxelized(case):
    pts, valid, kw, jg, jn, tg, tn = _both_grids(case)
    np.testing.assert_array_equal(tg.cnt.numpy(), np.asarray(jg.cnt))
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tg.cells.numpy(), np.asarray(jg.cells),
                               rtol=0, atol=CENT_ATOL)
    assert (tg.cell, tg.table, tg.cap, tg.nb) == (jg.cell, jg.table, jg.cap,
                                                  jg.nb)
    assert tg.cells.dtype == torch.float64 and tg.cnt.dtype == torch.int32
    n_kept = int(tg.cnt.sum())
    if case == "dropped":
        assert n_kept < int(tn)
    else:
        assert n_kept == int(tn)
    if case == "dense_corner":
        assert int(tn) == 216 and int(tg.cnt.max()) == 216


def test_build_grid_voxelized_centroids_float32():
    """In float32 the port's run sums are float64: each centroid is its
    voxel's float64 mean rounded once, while the reference's float32
    prefix sums drift over the map."""
    pts, valid, kw = _points("cell27")
    pts = (pts + 40.0).astype(np.float32)
    tg, tn = tgrid.build_grid_voxelized(_t(pts), _t(valid), **kw)
    g64, n64 = tgrid.build_grid_voxelized(_t(pts).double(), _t(valid), **kw)
    assert int(tn) == int(n64)
    np.testing.assert_array_equal(tg.cnt.numpy(), g64.cnt.numpy())
    np.testing.assert_array_equal(tg.cells.numpy(),
                                  g64.cells.numpy().astype(np.float32))


def _queries(pts, seed, Q=160):
    rng = np.random.default_rng(seed)
    q = pts[rng.integers(0, len(pts), Q)] + rng.normal(scale=0.3,
                                                       size=(Q, 3))
    q[0] = 500.0                        # far: buckets that collide
    qv = rng.random(Q) > 0.1
    return q, qv


@pytest.mark.parametrize("case", ["supercell", "cell27", "dense_corner"])
def test_gather_candidates_on_fused_grid(case):
    """K3's plain version on the port's fused grid keeps the sets that the
    reference's gather_candidates keeps on its own fused grid."""
    pts, _, kw, jg, _, tg, _ = _both_grids(case)
    q, qv = _queries(pts, 1)
    C = 32
    w = jax.jit(lambda a, b: jgrid.gather_candidates(a, b, jg, C))(
        jnp.asarray(q), jnp.asarray(qv))
    before = tsel.select_candidates_plain.calls
    g = tgrid.gather_candidates(_t(q), _t(qv), tg, C)
    assert tsel.select_candidates_plain.calls == before + 1
    np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
    assert int(g[1].sum()) > 100
    for i in (0, 2, 3):
        np.testing.assert_allclose(g[i].numpy(), np.asarray(w[i]), rtol=0,
                                   atol=CENT_ATOL)


def _knn_grids(kind):
    """(points, reference grid, port grid) for grid_knn: a fused grid or a
    build_grid grid over clustered points, or an empty grid."""
    pts = _clusters(7, 40, 40, 0.6).astype(np.float64)
    valid = np.random.default_rng(8).random(len(pts)) > 0.1
    if kind == "fused":
        kw = dict(leaf=0.4, m=5, table=2048, cap=128, nb=8)
        jg, _ = jax.jit(partial(jgrid.build_grid_voxelized, **kw))(
            jnp.asarray(pts), jnp.asarray(valid))
        tg, _ = tgrid.build_grid_voxelized(_t(pts), _t(valid), **kw)
        return pts, jg, tg
    if kind == "empty":
        valid[:] = False
    kw = dict(cell=1.0, table=2048, cap=64)
    jg = jax.jit(partial(jgrid.build_grid, **kw))(jnp.asarray(pts),
                                                  jnp.asarray(valid))
    tg = tgrid.build_grid(_t(pts), _t(valid), **kw)
    return pts, jg, tg


@pytest.mark.parametrize("kind,k", [("fused", 5), ("cell", 5), ("cell", 3),
                                    ("empty", 5)])
def test_grid_knn(kind, k):
    pts, jg, tg = _knn_grids(kind)
    q, qv = _queries(pts, 2)
    q[1] = pts[3]                       # a query on a map point
    q[2] = pts[4]
    qv[1], qv[2] = True, False          # an invalid query
    w_nn, w_d2 = jax.jit(partial(jgrid.grid_knn, k=k))(
        jnp.asarray(q), jnp.asarray(qv), jg)
    g_nn, g_d2 = tgrid.grid_knn(_t(q), _t(qv), tg, k)
    w_nn, w_d2 = np.asarray(w_nn), np.asarray(w_d2)
    # the reference's CPU build contracts the distance into fused
    # multiply-adds (an ulp or two from the port's separate roundings, which
    # K3 shares); the fused grid's centroids also carry the prefix sums'
    # association differences
    rtol = 1e-12 if kind == "fused" else D2_RTOL
    np.testing.assert_allclose(g_d2.numpy(), w_d2, rtol=rtol, atol=1e-12)
    # the neighbour of a distance tied with another of the row (to that
    # tolerance) may be either point
    close = np.isclose(w_d2[:, 1:], w_d2[:, :-1], rtol=rtol, atol=1e-12)
    tied = np.zeros_like(w_d2, bool)
    tied[:, 1:] |= close
    tied[:, :-1] |= close
    tied &= np.isfinite(w_d2)
    assert tied.sum() < 10
    np.testing.assert_allclose(g_nn.numpy()[~tied], w_nn[~tied], rtol=0,
                               atol=CENT_ATOL if kind == "fused" else 0)
    # the invalid query: every slot at +inf, parked on the query
    assert np.all(np.isinf(g_d2[2].numpy()))
    np.testing.assert_array_equal(g_nn.numpy()[2], np.repeat(q[2:3], k, 0))
    if kind == "empty":
        assert np.all(np.isinf(g_d2.numpy()))
        np.testing.assert_array_equal(g_nn.numpy(),
                                      np.repeat(q[:, None], k, 1))
    else:
        assert np.isfinite(g_d2.numpy()).sum() > 100
        if kind == "cell":
            assert g_d2[1, 0] == 0.0    # the map point itself


@pytest.mark.parametrize("case", ["supercell", "cell27"])
def test_gather_block(case):
    pts, _, _, jg, _, tg, _ = _both_grids(case)
    q, qv = _queries(pts, 3, Q=64)
    w = jax.jit(jgrid.gather_block)(jnp.asarray(q), jnp.asarray(qv), jg)
    g = tgrid.gather_block(_t(q), _t(qv), tg)
    np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
    assert g[1].shape == (64, tg.nb * tg.cap) and int(g[1].sum()) > 100
    np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]), rtol=0,
                               atol=CENT_ATOL)
    np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
