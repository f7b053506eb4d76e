"""Every voxel builder of the port sums its voxel runs in float64: on a
float32 cloud whose float32 prefix sums lose centroid digits (30,000
points in a 80 m cube whose near corner is at the origin, leaf 0.4 m:
prefix sums up to ~1e6 m), each builder's centroids lie within TOL_M of
the float64 means of their voxels, summed apart by numpy.  Membership,
order, slots and counts equal those of the same builder run on the
float64 copy of the cloud.

Every point is kept 0.02 m off its voxel's faces, so the float32 and
float64 runs put it in the same voxel (the boundaries themselves are
`tests/test_torch_mapops.py::test_voxel_downsample_at_leaf_boundaries`)."""
import numpy as np
import pytest
import torch

from lins_tpu_torch.frontend.features import voxel_downsample_ring
from lins_tpu_torch.frontend.projection import div_const
from lins_tpu_torch.ops.grid_nn import build_grid_voxelized
from lins_tpu_torch.ops.voxel import voxel_downsample
from lins_tpu_torch.ops.voxel_map import build_voxel_map, scan_delta

torch.set_num_threads(1)

LEAF = 0.4
M, TABLE, CAP, NB = 6, 4096, 216, 8     # the mapper's surf grid geometry
N_VOX, PER_VOX = 6000, 5
RINGS = 16
# one float32 rounding of a centroid 80 m out moves it by up to 6.6e-6 m
# (half an ulp, 3.8e-6 m, on each axis)
TOL_M = 1e-5


def _cloud():
    """(N, 3) float32 points, 5 to a voxel of 6,000 drawn in the cube, in
    random order, and a mask that drops a tenth; the points' rel times."""
    rng = np.random.default_rng(12)
    vox = rng.integers(0, 200, (N_VOX, 3))
    v = np.repeat(vox, PER_VOX, axis=0)
    frac = rng.uniform(0.05, 0.95, v.shape)
    perm = rng.permutation(len(v))
    pts = ((v + frac) * LEAF).astype(np.float32)[perm]
    mask = rng.random(len(pts)) > 0.1
    rel = rng.uniform(0.0, 0.1, len(pts)).astype(np.float32)
    return pts, mask, rel


def _key(v):
    """One int64 key for integer voxel triples (..., 3), lexicographic."""
    v = np.asarray(v, np.int64) + 2 ** 20
    return (v[..., 0] * 2 ** 21 + v[..., 1]) * 2 ** 21 + v[..., 2]


def _means64(pts, mask, *extra):
    """(sorted voxel keys, float64 means of pts[mask] and of each `extra`
    column, by voxel)."""
    p = pts[mask].astype(np.float64)
    cols = np.column_stack([p] + [e[mask].astype(np.float64)
                                  for e in extra])
    keys, inv = np.unique(_key(np.floor(p / LEAF)), return_inverse=True)
    sums = np.zeros((len(keys), cols.shape[1]))
    np.add.at(sums, inv, cols)
    return keys, sums / np.bincount(inv)[:, None]


def _lookup(keys, means, vox):
    """The float64 means of the voxels `vox` (n, 3); each must exist."""
    k = _key(vox)
    i = np.searchsorted(keys, k)
    assert np.all(keys[np.minimum(i, len(keys) - 1)] == k), "unknown voxel"
    return means[i]


def _voxel_of(c):
    return torch.floor(div_const(c, LEAF)).to(torch.int32).numpy()


def _err(got, want):
    return float(np.max(np.linalg.norm(np.asarray(got, np.float64) - want,
                                       axis=-1)))


def _voxel_downsample(pts, mask, rel):
    keys, means = _means64(pts, mask)
    runs = [voxel_downsample(torch.as_tensor(p), torch.as_tensor(mask), LEAF)
            for p in (pts, pts.astype(np.float64))]
    (c32, ok32), (c64, ok64) = runs
    assert torch.equal(ok32, ok64)
    n = int(ok32.sum())
    assert n == len(keys)
    # centroids compacted in the lexicographic order of their voxels
    np.testing.assert_array_equal(_voxel_of(c32[:n]), _voxel_of(c64[:n]))
    np.testing.assert_array_equal(_key(_voxel_of(c64[:n])), keys)
    return _err(c32[:n], means)


def _voxel_map(pts, mask, rel):
    keys, means = _means64(pts, mask)
    errs = []
    # the window's per-slot deltas: a batch of 4 scans, each its own voxels
    b_pts, b_mask = pts.reshape(4, -1, 3), mask.reshape(4, -1)
    d32, d64 = (scan_delta(torch.as_tensor(p), torch.as_tensor(b_mask),
                           LEAF, M, TABLE)
                for p in (b_pts, b_pts.astype(np.float64)))
    for f in ("bucket", "vox", "cnt", "ok"):
        assert torch.equal(getattr(d32, f), getattr(d64, f)), f
    for b in range(4):
        bk, bm = _means64(b_pts[b], b_mask[b])
        ok = d32.ok[b].numpy()
        c = (d32.psum[b].double() / d32.cnt[b, :, None]).numpy()[ok]
        errs.append(_err(c, _lookup(bk, bm, d32.vox[b].numpy()[ok])))
    # the compaction build over the union
    vm32, vm64 = (build_voxel_map(torch.as_tensor(p), torch.as_tensor(mask),
                                  LEAF, M, TABLE, CAP, NB)
                  for p in (pts, pts.astype(np.float64)))
    for f in ("hwm", "vcoord", "vcnt", "n_live", "overflow"):
        assert torch.equal(getattr(vm32, f), getattr(vm64, f)), f
    live = (vm32.vcnt > 0).numpy()
    assert int(live.sum()) == len(keys) and not bool(vm32.overflow)
    cells = vm32.cells.transpose(1, 2).numpy()[live]
    vox = vm32.vcoord.transpose(1, 2).numpy()[live]
    errs.append(_err(cells, _lookup(keys, means, vox)))
    return max(errs)


def _fused_grid(pts, mask, rel):
    keys, means = _means64(pts, mask)
    (g32, n32), (g64, n64) = (
        build_grid_voxelized(torch.as_tensor(p), torch.as_tensor(mask),
                             LEAF, M, TABLE, CAP, NB)
        for p in (pts, pts.astype(np.float64)))
    assert int(n32) == int(n64) == len(keys)
    assert torch.equal(g32.cnt, g64.cnt)
    live = (torch.arange(CAP)[None, :] < g32.cnt[:, None]).numpy()
    c32 = g32.cells.transpose(1, 2)
    c64 = g64.cells.transpose(1, 2)
    vox = _voxel_of(c32)[live]
    np.testing.assert_array_equal(vox, _voxel_of(c64)[live])
    return _err(c32.numpy()[live], _lookup(keys, means, vox))


def _ring(pts, mask, rel):
    r_pts = pts.reshape(RINGS, -1, 3)
    r_mask, r_rel = mask.reshape(RINGS, -1), rel.reshape(RINGS, -1)
    (x32, t32, s32), (x64, t64, s64) = (
        voxel_downsample_ring(torch.as_tensor(p), torch.as_tensor(t),
                              torch.as_tensor(r_mask), LEAF)
        for p, t in ((r_pts, r_rel), (r_pts.astype(np.float64),
                                      r_rel.astype(np.float64))))
    assert torch.equal(s32, s64)
    errs = []
    for r in range(RINGS):
        keys, means = _means64(r_pts[r], r_mask[r], r_rel[r])
        s = s32[r].numpy()
        assert int(s.sum()) == len(keys)
        vox = _voxel_of(x32[r])[s]
        np.testing.assert_array_equal(vox, _voxel_of(x64[r])[s])
        want = _lookup(keys, means, vox)
        errs.append(_err(x32[r].numpy()[s], want[:, :3]))
        errs.append(float(np.max(np.abs(t32[r].numpy()[s] - want[:, 3]))))
    return max(errs)


@pytest.mark.parametrize("builder", [_voxel_downsample, _voxel_map,
                                     _fused_grid, _ring],
                         ids=["voxel_downsample", "scan_delta+build_voxel_map",
                              "build_grid_voxelized",
                              "voxel_downsample_ring"])
def test_float32_centroids_are_float64_means(builder):
    err = builder(*_cloud())
    print(f"{builder.__name__}: worst centroid {err:.3e} m from the float64 "
          f"means")
    assert err <= TOL_M, f"worst centroid {err:.3e} m from the float64 means"
