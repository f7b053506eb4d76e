"""The port's map ops against the reference package on the same numpy
inputs: voxel hashing and downsampling, closed-form 3x3 algebra, the hash
grid, the incremental voxel map and the candidate re-rank.  The reference
functions run under `jax.jit` with their sizes static, as the mapper runs
them (XLA folds a division by a constant into a reciprocal product there,
which the port copies)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.ops import grid_nn as jgrid
from lins_tpu.ops import lin3 as jlin3
from lins_tpu.ops import voxel as jvoxel
from lins_tpu.ops import voxel_map as jvm
from lins_tpu_torch.ops import grid_nn as tgrid
from lins_tpu_torch.ops import lin3 as tlin3
from lins_tpu_torch.ops import voxel as tvoxel
from lins_tpu_torch.ops import voxel_map as tvm

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

M32 = 2 ** 32
# sums and centroids are differences of cumulative sums, which XLA
# associates in another order than torch.cumsum: in float64 they agree to
# ~1e-12 m at the magnitudes here (running sums up to ~1e4)
SUM_ATOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_equal(got, want, atol=0.0):
    for f in ("cells", "hwm", "vcoord", "vsum", "vcnt", "n_live",
              "overflow"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=0, atol=atol, err_msg=f)


def _int_min_preimage():
    """Voxel coords (0, 0, z) whose hash3 is INT_MIN: invert the hash's
    finalizer and its last multiply (all bijections on uint32)."""
    def inv(c):
        return pow(c, -1, M32)

    y = 0x80000000
    h = y ^ (y >> 16)
    h = (h * inv(0x846CA68B)) % M32
    h = h ^ (h >> 15) ^ (h >> 30)
    h = (h * inv(0x7FEB352D)) % M32
    h = h ^ (h >> 16)
    z = (h * inv(0xC2B2AE3D)) % M32
    return np.asarray([[0, 0, z - M32 if z >= 2 ** 31 else z]], np.int32)


def test_hash3_and_bucket():
    rng = np.random.default_rng(0)
    lo, hi = -2 ** 31, 2 ** 31 - 1
    extreme = np.asarray([[lo, lo, lo], [hi, hi, hi], [-1, -1, -1],
                          [0, 0, 0], [lo, 0, hi], [-7, 40, -6], [6, -40, -6],
                          [-6, -40, 6]], np.int32)
    coords = np.concatenate([
        rng.integers(-1000, 1000, (500, 3)).astype(np.int32),
        rng.integers(lo, hi, (500, 3), dtype=np.int64).astype(np.int32),
        extreme, _int_min_preimage()])
    want_h = np.asarray(jvoxel.hash3(jnp.asarray(coords)))
    assert want_h[-1] == lo                  # the INT_MIN case is covered
    np.testing.assert_array_equal(tvoxel.hash3(_t(coords)).numpy(), want_h)
    for table in (1024, 4096, 5000):
        np.testing.assert_array_equal(
            tgrid._bucket_of(_t(coords), table).numpy(),
            np.asarray(jgrid._bucket_of(jnp.asarray(coords), table)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_voxel_downsample_at_leaf_boundaries(dtype):
    """Points on voxel boundaries, their float neighbours, masked rows and
    duplicates; centroids and masks against the reference."""
    rng = np.random.default_rng(1)
    leaf = 0.4
    k = rng.integers(-30, 30, (300, 3))
    on = (k * leaf).astype(dtype)
    pts = np.concatenate([on, np.nextafter(on, dtype(np.inf)),
                          np.nextafter(on, dtype(-np.inf)),
                          rng.uniform(-12, 12, (400, 3)).astype(dtype),
                          on[:50]])
    # XLA flushes float32 denormals (the neighbours of 0) to zero; no real
    # coordinate is one
    pts[np.abs(pts) < 1e-30] = 0.0
    mask = rng.random(len(pts)) > 0.1
    for cap in (None, 700):
        f = jax.jit(partial(jvoxel.voxel_downsample, leaf=leaf, cap=cap))
        wx, wok = f(jnp.asarray(pts), jnp.asarray(mask))
        gx, gok = tvoxel.voxel_downsample(_t(pts), _t(mask), leaf, cap)
        np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
        # float32: one ulp of a running sum near 1e4 is 1e-3
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0,
                                   atol=SUM_ATOL if dtype == np.float64
                                   else 2e-3)


def test_lin3():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 5, 3))
    A = np.einsum("nki,nkj->nij", X, X) / 5.0
    A[:10] = np.eye(3) * 2.0                          # isotropic
    A[10:20, :, 2] = A[10:20, 2, :] = 0.0             # singular
    w, V = jax.jit(jlin3.eigh_sym3x3)(jnp.asarray(A))
    tw, tV = tlin3.eigh_sym3x3(_t(A))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tV.numpy(), np.asarray(V), rtol=0, atol=1e-9)
    b = rng.normal(size=(300, 3))
    x = jax.jit(jlin3.solve_sym3x3)(jnp.asarray(A), jnp.asarray(b))
    tx = tlin3.solve_sym3x3(_t(A), _t(b))
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-12,
                               atol=1e-9)


def test_build_grid():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 10, (3000, 3))
    pts[:200] = pts[200:400]                          # crowded cells
    valid = rng.random(3000) > 0.1
    f = jax.jit(partial(jgrid.build_grid, cell=1.2, table=512, cap=8))
    want = f(jnp.asarray(pts), jnp.asarray(valid))
    got = tgrid.build_grid(_t(pts), _t(valid), cell=1.2, table=512, cap=8)
    np.testing.assert_array_equal(got.cnt.numpy(), np.asarray(want.cnt))
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))
    assert int(got.cnt.max()) == 8                    # some cells overflow


def _cloud(rng, n, center, spread, valid_frac=0.9):
    pts = center + rng.uniform(-spread, spread, (n, 3))
    return pts, rng.random(n) < valid_frac


@pytest.mark.parametrize("cap", [216, 8])
def test_delta_insert_evict_revive(cap):
    """Insert two scans, evict the first, insert it again (its voxels are
    tombstones to revive in place), evict a never-inserted scan; with a
    small cap the allocation overflows.  Every field against the
    reference after each step."""
    rng = np.random.default_rng(4)
    leaf, m, table = 0.4, 6, 256
    a = _cloud(rng, 800, 0.0, 3.0)
    b = _cloud(rng, 800, 1.5, 3.0)
    c = _cloud(rng, 300, 40.0, 2.0)
    jdelta = jax.jit(partial(jvm.scan_delta, leaf=leaf, m=m, table=table))
    japply = jax.jit(jvm.apply_delta, static_argnames=("sign",))
    jmap = jvm.empty_voxel_map(leaf, m, table, cap, 8, jnp.float64)
    tmap = tvm.empty_voxel_map(leaf, m, table, cap, 8, torch.float64)
    for pts, ok, sign, en in ((a[0], a[1], 1, True), (b[0], b[1], 1, True),
                              (a[0], a[1], -1, True), (b[0], b[1], -1, False),
                              (a[0], a[1], 1, True), (c[0], c[1], -1, True)):
        jd = jdelta(jnp.asarray(pts), jnp.asarray(ok))
        td = tvm.scan_delta(_t(pts), _t(ok), leaf, m, table)
        for f in jd._fields:
            np.testing.assert_allclose(getattr(td, f).numpy(),
                                       np.asarray(getattr(jd, f)), rtol=0,
                                       atol=SUM_ATOL, err_msg=f)
        jmap = japply(jmap, jd, sign, jnp.asarray(en))
        tmap = tvm.apply_delta(tmap, td, sign, torch.tensor(en))
        _assert_tree_equal(tmap, jmap, atol=SUM_ATOL)
    assert bool(tmap.overflow) == (cap == 8)


def test_build_voxel_map_batched_deltas():
    """The compaction build of a union and the batched per-slot deltas
    (the window rebuild's shapes) against the reference."""
    rng = np.random.default_rng(5)
    leaf, m, table, cap = 0.2, 6, 512, 216
    pts = np.stack([_cloud(rng, 400, i * 0.7, 2.0)[0] for i in range(4)])
    ok = rng.random((4, 400)) < 0.9
    want = jax.jit(partial(jvm.build_voxel_map, leaf=leaf, m=m, table=table,
                           cap=cap, nb=27))(jnp.asarray(pts.reshape(-1, 3)),
                                            jnp.asarray(ok.reshape(-1)))
    got = tvm.build_voxel_map(_t(pts.reshape(-1, 3)), _t(ok.reshape(-1)),
                              leaf, m, table, cap, 27)
    _assert_tree_equal(got, want, atol=SUM_ATOL)
    jd = jax.jit(jax.vmap(partial(jvm.scan_delta, leaf=leaf, m=m,
                                  table=table)))(jnp.asarray(pts),
                                                 jnp.asarray(ok))
    td = tvm.scan_delta(_t(pts), _t(ok), leaf, m, table)
    for f in jd._fields:
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=0,
                                   atol=SUM_ATOL, err_msg=f)


def test_knn_from_candidates_ties():
    """Duplicate candidates (exact distance ties) take the lowest index
    first; masked and tombstone slots never win; exhausted slots park on
    the query."""
    rng = np.random.default_rng(6)
    Q, C = 64, 16
    p = rng.uniform(-2, 2, (Q, 3))
    cand = p[:, None, :] + rng.uniform(-1, 1, (Q, C, 3))
    cand[:, 1] = cand[:, 0]
    cand[:, 5] = cand[:, 3]
    cand[:, 7] = 1.0e9                                 # tombstone
    ok = rng.random((Q, C)) < 0.8
    ok[:4, 3:] = False                                 # fewer than 5
    qv = rng.random(Q) < 0.9
    nn, d2 = jax.jit(jgrid.knn_from_candidates)(
        jnp.asarray(p), jnp.asarray(qv), jnp.asarray(cand), jnp.asarray(ok))
    tnn, td2 = tgrid.knn_from_candidates(_t(p), _t(qv), _t(cand), _t(ok))
    np.testing.assert_array_equal(np.isfinite(td2.numpy()),
                                  np.isfinite(np.asarray(d2)))
    np.testing.assert_allclose(td2.numpy(), np.asarray(d2), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tnn.numpy(), np.asarray(nn), rtol=0,
                               atol=1e-12)


def test_plane_fit_float32_matches_float64():
    """The scan-to-map plane fit (`surf_residuals`) decides the same
    matches in float32 as in float64 on tight 5-point neighbourhoods of
    planes 5-40 m from the origin.  Solved in float32, the normal
    equations of the world coordinates kept only about 30% of them."""
    from lins_tpu_torch.mapping.scan2map import surf_residuals

    rng = np.random.default_rng(0)
    Q = 2000
    normal = rng.normal(size=(Q, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    center = rng.normal(size=(Q, 3))
    center *= (rng.uniform(5, 40, (Q, 1))
               / np.linalg.norm(center, axis=1, keepdims=True))
    u = np.cross(normal, rng.normal(size=(Q, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(normal, u)
    a, b = rng.uniform(-0.4, 0.4, (2, Q, 5, 1))
    nn = (center[:, None] + a * u[:, None] + b * v[:, None]
          + rng.normal(scale=0.01, size=(Q, 5, 1)) * normal[:, None])
    p = center + 0.05 * normal
    d2 = np.sort(np.sum((nn - p[:, None]) ** 2, axis=2), axis=1)
    valid = torch.ones(Q, dtype=torch.bool)
    c64, r64, ok64 = surf_residuals(_t(p), _t(nn), _t(d2), valid)
    c32, r32, ok32 = surf_residuals(_t(p).float(), _t(nn).float(),
                                    _t(d2).float(), valid)
    assert c32.dtype == torch.float32
    assert ok64.float().mean() > 0.99
    assert torch.equal(ok32, ok64)
    np.testing.assert_allclose(c32.numpy(), c64.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(r32.numpy(), r64.numpy(), rtol=0, atol=1e-3)


def test_line_fit_float32_matches_float64():
    """The scan-to-map line fit (`corner_residuals`) decides the same
    matches in float32 as in float64: tight 5-point lines 5-40 m from the
    origin (linear) and 5-point blobs and planes (not linear), so the test
    w[2] > 3 w[1] goes both ways; coefficients and residuals within 1e-3."""
    from lins_tpu_torch.mapping.scan2map import corner_residuals

    rng = np.random.default_rng(1)
    Q = 2000
    center = rng.normal(size=(Q, 3))
    center *= (rng.uniform(5, 40, (Q, 1))
               / np.linalg.norm(center, axis=1, keepdims=True))
    d = rng.normal(size=(Q, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = np.cross(d, rng.normal(size=(Q, 3)))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    t = rng.uniform(-0.4, 0.4, (Q, 5, 1))
    nn = (center[:, None] + t * d[:, None]
          + rng.normal(scale=0.01, size=(Q, 5, 3)))
    blob = rng.random(Q) < 0.3                 # spread in 3D: not linear
    nn[blob] = center[blob, None] + rng.normal(scale=0.25,
                                               size=(int(blob.sum()), 5, 3))
    flat = ~blob & (rng.random(Q) < 0.15)      # spread in a plane
    s = rng.uniform(-0.4, 0.4, (int(flat.sum()), 5, 1))
    nn[flat] += s * e[flat, None]
    p = center + rng.uniform(0.05, 0.4, (Q, 1)) * e
    d2 = np.sort(np.sum((nn - p[:, None]) ** 2, axis=2), axis=1)
    valid = torch.ones(Q, dtype=torch.bool)
    c64, r64, ok64 = corner_residuals(_t(p), _t(nn), _t(d2), valid)
    c32, r32, ok32 = corner_residuals(_t(p).float(), _t(nn).float(),
                                      _t(d2).float(), valid)
    assert c32.dtype == torch.float32
    assert 0.3 < ok64.float().mean() < 0.9
    assert torch.equal(ok32, ok64)
    np.testing.assert_allclose(c32.numpy(), c64.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(r32.numpy(), r64.numpy(), rtol=0, atol=1e-3)
