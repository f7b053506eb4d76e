"""K3 and K6 on the CPU: the port's plain selection of a gathered block
against the reference's TPU kernel run in interpret mode, `gather_candidates`
(K3's fused gather and selection) against the reference for both values of
the selection flag, on voxel grids and on hand-made grids whose neighbour
cells collide in the hash, and the values-only top-k against the canary's
own check (`np.sort(d2)[:, :C]`).

Inputs are float32, as on the card (the reference kernel's fori_loop
carries float32 and refuses float64 inputs).  Kept sets and their order
are compared exactly, coordinates within 1e-6 m: both sides compute the
same float32 distances, the reference's XLA build possibly with fused
multiply-adds (one-ulp differences, which reorder only exact near-ties)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.ops import grid_nn as jgrid
from lins_tpu.ops.pallas_select import select_candidates as jselect
from lins_tpu_torch.ops import grid_nn as tgrid
from lins_tpu_torch.ops import select as tsel

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


def _block_case(seed, Q=96, nb=8, cap=40):
    """A random gathered block (Q, nb, 3, cap) with the edge cases of the
    main path: duplicate points (exact ties), tombstones at the voxel map's
    SENTINEL, all-invalid rows, invalid queries, rows with fewer than C+1
    valid candidates."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    cand = (q[:, None, :, None]
            + rng.uniform(-2, 2, (Q, nb, 3, cap))).astype(np.float32)
    cand[:, 1, :, :7] = cand[:, 0, :, :7]               # duplicates
    cand[:, :, :, 3] = cand[:, :, :, 2]
    cand[:, 2, :, 10:14] = 1.0e9                        # tombstones
    ok = rng.random((Q, nb, cap)) < 0.85
    ok[0] = False                                       # all invalid
    ok[1:4] = False
    ok[1:4, 0, :5] = True                               # fewer than C+1
    qv = rng.random(Q) < 0.9
    qv[5] = False
    return q, qv, cand, ok


def _planes(cand):
    Q = cand.shape[0]
    return cand.transpose(0, 2, 1, 3).reshape(Q, 3, -1)


@pytest.mark.parametrize("seed,nb,cap,C", [(0, 8, 40, 16), (1, 27, 24, 32),
                                           (2, 8, 216, 32)])
def test_plain_matches_tpu_kernel(seed, nb, cap, C):
    q, qv, cand, ok = _block_case(seed, nb=nb, cap=cap)
    fc = _planes(cand)
    Q = len(q)
    w_cand, w_ok, w_d2k, w_d2C = jselect(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(fc[:, 0]),
        jnp.asarray(fc[:, 1]), jnp.asarray(fc[:, 2]),
        jnp.asarray(ok.reshape(Q, -1)), C, interpret=True)
    g_cand, g_ok, g_d2k, g_d2C = tsel.select_block_plain(
        _t(q), _t(qv), _t(cand), _t(ok), C, first_dropped=True)
    np.testing.assert_array_equal(g_ok.numpy(), np.asarray(w_ok))
    np.testing.assert_allclose(g_cand.numpy(), np.asarray(w_cand), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(g_d2k.numpy(), np.asarray(w_d2k), rtol=1e-6)
    np.testing.assert_allclose(g_d2C.numpy(), np.asarray(w_d2C), rtol=1e-6)
    assert not g_ok[0].any() and not g_ok[5].any()
    assert g_ok[1:4].sum(1).max() <= 5


def _grid(nb):
    """A reference supercell (nb=8, 0.4 m leaf) or 27-cell (0.2 m leaf)
    grid over random points, as tests/test_pallas.py builds it."""
    rng = np.random.default_rng(7 + nb)
    n_map = 20000
    pts = jnp.asarray(rng.uniform(-20, 20, (n_map, 3)), jnp.float32)
    ok = jnp.asarray(rng.random(n_map) > 0.05)
    leaf = 0.4 if nb == 8 else 0.2
    grid, _ = jgrid.build_grid_voxelized(pts, ok, leaf=leaf, m=6, table=4096,
                                         cap=216, nb=nb)
    q = rng.uniform(-18, 18, (256, 3)).astype(np.float32)
    q[0] = 500.0                        # far: hash-colliding far buckets
    qv = rng.random(256) > 0.1
    tgrid_ = tgrid.HashGrid(cells=_t(grid.cells), cnt=_t(grid.cnt),
                            cell=grid.cell, table=grid.table, cap=grid.cap,
                            nb=grid.nb)
    return grid, tgrid_, q, qv


@pytest.mark.parametrize("nb", [8, 27])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gather_candidates(nb, use_pallas):
    jg, tg, q, qv = _grid(nb)
    C = 32
    f = jax.jit(lambda q_, v_: jgrid.gather_candidates(
        q_, v_, jg, C, use_pallas=use_pallas, interpret=True))
    w_cand, w_ok, w_d2C, w_cov = f(jnp.asarray(q), jnp.asarray(qv))
    before = tsel.select_candidates_plain.calls
    g_cand, g_ok, g_d2C, g_cov = tgrid.gather_candidates(
        _t(q), _t(qv), tg, C, use_pallas=use_pallas)
    assert tsel.select_candidates_plain.calls == before + 1
    np.testing.assert_array_equal(g_ok.numpy(), np.asarray(w_ok))
    assert g_ok.sum() > 1000
    np.testing.assert_allclose(g_cand.numpy(), np.asarray(w_cand), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(g_d2C.numpy(), np.asarray(w_d2C), rtol=1e-6)
    np.testing.assert_allclose(g_cov.numpy(), np.asarray(w_cov), rtol=0,
                               atol=1e-6)


def _colliding_grid(nb, seed=11, table=13, cap=24, Q=64):
    """A hand-made grid of `table` buckets, so small that neighbour cells
    of one query hash to one bucket; counts below cap, empty buckets and
    tombstones at the voxel map's SENTINEL among the counted slots."""
    rng = np.random.default_rng(seed)
    cells = rng.uniform(-3, 3, (table, 3, cap)).astype(np.float32)
    cnt = rng.integers(0, cap + 1, table).astype(np.int32)
    cnt[0], cnt[1] = 0, cap
    tomb = (rng.random((table, cap)) < 0.1)[:, None, :].repeat(3, 1)
    cells[tomb] = 1.0e9
    q = rng.uniform(-2, 2, (Q, 3)).astype(np.float32)
    qv = rng.random(Q) < 0.9
    grid = dict(cells=cells, cnt=cnt, cell=0.8, table=table, cap=cap, nb=nb)
    return (jgrid.HashGrid(cells=jnp.asarray(cells), cnt=jnp.asarray(cnt),
                           cell=0.8, table=table, cap=cap, nb=nb),
            tgrid.HashGrid(**{k: _t(v) if isinstance(v, np.ndarray) else v
                              for k, v in grid.items()}), q, qv)


@pytest.mark.parametrize("nb", [8, 27])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_gather_colliding_buckets(nb, use_pallas):
    """K3's plain version reads the grid at the hashed buckets itself:
    against the reference's gather (its TPU kernel in interpret mode, or
    its sort path) where neighbour cells share a bucket, counts stop below
    cap and tombstones sit among the counted slots."""
    jg, tg, q, qv = _colliding_grid(nb)
    nbc, _ = tgrid._neighborhood(_t(q), tg)
    bb = tgrid._bucket_of(nbc, tg.table)
    dup = (bb[:, :, None] == bb[:, None, :]).sum(-1) > 1
    assert dup.any(1).float().mean() > 0.5           # collisions are common
    C = 16
    w = jgrid.gather_candidates(jnp.asarray(q), jnp.asarray(qv), jg, C,
                                use_pallas=use_pallas, interpret=True)
    before = tsel.select_candidates_plain.calls
    g = tgrid.gather_candidates(_t(q), _t(qv), tg, C, use_pallas=use_pallas)
    assert tsel.select_candidates_plain.calls == before + 1
    np.testing.assert_array_equal(g[1].numpy(), np.asarray(w[1]))
    assert 0 < int(g[1].sum()) < g[1].numel()
    np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(g[2].numpy(), np.asarray(w[2]), rtol=1e-6)
    np.testing.assert_allclose(g[3].numpy(), np.asarray(w[3]), rtol=0,
                               atol=1e-6)


def test_d2c_by_flag():
    """One call holds both bounds: the first dropped distance is >= the
    C-th kept one."""
    q, qv, cand, ok = _block_case(3)
    args = (_t(q), _t(qv), _t(cand), _t(ok), 16)
    _, _, d2k, kept = tsel.select_block_plain(*args, first_dropped=False)
    _, _, _, dropped = tsel.select_block_plain(*args, first_dropped=True)
    np.testing.assert_array_equal(kept.numpy(), d2k[:, -1].numpy())
    both = torch.isfinite(kept) & torch.isfinite(dropped)
    assert both.sum() > 50
    assert bool((dropped[both] >= kept[both]).all())


@pytest.mark.parametrize("Q,B,C", [(128, 256, 8), (64, 1728, 64)])
def test_topk_smallest(Q, B, C):
    """K6's plain version against the canary's own check, with +inf rows
    and ties."""
    rng = np.random.default_rng(Q)
    d2 = rng.uniform(0, 100, (Q, B)).astype(np.float32)
    d2[0] = np.inf
    d2[1, ::2] = 3.0
    before = tsel.topk_smallest_plain.calls
    got = tsel.topk_smallest(_t(d2), C)
    assert tsel.topk_smallest_plain.calls == before + 1
    np.testing.assert_array_equal(got.numpy(), np.sort(d2, axis=1)[:, :C])
