"""Port parity for the "exact" feature mode (the reference's sequential
greedy picking, StateEstimator.hpp:719-827, and the centroid per voxel of
each ring's less-flat points), lins_tpu_torch against lins_tpu on the CPU:

  * on one VLP-16 raycast scan and one TINY scan: labels and the less-flat
    mask exact (all rings at once, and single rings through
    `extract_ring`), every feature set's `valid` and `ring` exact, sharp, flat
    and less-sharp coordinates exact, less-flat centroids within 1e-9 m in
    float64; in float32 the port's centroids within 1e-5 m of float64,
    where the reference's float32 prefix-sum differences lose up to
    `REF_F32_CENTROID_TOL_M` (measured here, PERF.md §4);
  * hand-made rings: fewer than 12 points (every sector empty), equal
    curvatures (the first index wins), column gaps > 10 inside the ±5
    suppression window, picks at both ends of a ring, fewer candidates than
    picks, points that share a voxel and voxels that share a hash;
  * `LinsOdometry` in exact mode on TINY, 6 + 4 scans, streamed and as one
    chunk: poses within 1e-6 m of the reference's, in float64.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY, VLP16
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.frontend import features as jF
from lins_tpu.frontend import pipeline as jpipe
from lins_tpu.frontend import segmentation as jS
from lins_tpu.odometry import LinsOdometry as JOdometry
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.frontend import features as tF
from lins_tpu_torch.frontend.types import SegmentedScan
from lins_tpu_torch.odometry import LinsOdometry as TOdometry

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

CENTROID_TOL_M = 1e-9
PORT_F32_TOL_M = 1e-5
# the reference's own float32 centroids against float64 on the VLP-16
# scan: 4.2e-4 m at most (the prefix sums reach ~5e4 m); the port's
# float32 centroids are held to the reference's within this bound
REF_F32_CENTROID_TOL_M = 1e-3
# int32 voxel-hash collisions of distinct cells (found by a birthday search)
HASH_PAIRS = (((353, 756, -2424), (-2363, 1402, -2798)),
              ((2729, -2861, 635), (-2511, -2462, -742)))
SETS = ("sharp", "less_sharp", "flat", "less_flat", "outlier")


def _exact(cfg):
    return cfg.replace(feature_mode="exact")


def _t(a):
    return torch.as_tensor(np.array(a))


def _as(seg, dtype):
    """The segmented scan with its float fields in `dtype` (numpy)."""
    return seg._replace(**{
        f: np.asarray(getattr(seg, f)).astype(dtype)
        for f in seg._fields if np.asarray(getattr(seg, f)).dtype.kind == "f"})


def _tseg(seg):
    return SegmentedScan(*(_t(getattr(seg, f)) for f in seg._fields))


def _jseg(seg):
    return seg._replace(**{f: jnp.asarray(getattr(seg, f))
                           for f in seg._fields})


def _ref_rings(seg, jcfg):
    """The reference's `extract_ring` over every ring; `seg` a segmented
    scan or a dict of its fields."""
    d = seg if isinstance(seg, dict) else seg._asdict()
    return jax.jit(jax.vmap(partial(jF.extract_ring, cfg=jcfg)))(
        {k: jnp.asarray(d[k]) for k in ("rng", "col", "ground", "valid",
                                          "count")})


def _ref_voxels(xyz, rel, mask, leaf):
    return jax.jit(jax.vmap(partial(jF.voxel_downsample_ring, leaf=leaf)))(
        jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask))


def _scan_segments(jcfg, kind, seed=0):
    """One raycast scan of the synthetic world through the reference's
    front end up to the segmented scan; returns (segmented scan with numpy
    leaves, the outlier image and mask)."""
    data = jsyn.generate_sequence(jcfg, n_scans=1, kind=kind, speed=1.5,
                                  seed=seed)
    pre = jax.jit(lambda a, b: jpipe.frontend_pre(a, b, jcfg))(
        jnp.asarray(data["scans_xyz"][0]), jnp.asarray(data["scans_n"][0]))
    labels = jS.label_from_edges(pre["e_right"], pre["e_down"],
                                 pre["eligible"])
    _, seg_valid, outlier = jS.segment_from_labels(
        labels, pre["eligible"], pre["ground"], jcfg)
    seg = jax.jit(lambda p, sv: jF.compact_rings(
        p["xyz_img"], p["rng_img"], sv, p["ground"], p["start"], p["diff"],
        jcfg))(pre, seg_valid)
    seg = seg._replace(**{f: np.asarray(getattr(seg, f))
                          for f in seg._fields})
    return seg, np.asarray(pre["xyz_img"]), np.asarray(outlier)


@pytest.fixture(scope="module", params=["vlp16", "tiny"])
def scan(request):
    jcfg = _exact(VLP16.replace(max_points=28800) if request.param == "vlp16"
                  else TINY)
    seg, out_xyz, out_mask = _scan_segments(jcfg, "straight")
    return jcfg, seg, out_xyz, out_mask


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_extract_rings(scan, dtype):
    jcfg, seg, _, _ = scan
    seg = _as(seg, dtype)
    want_lab, want_lf = _ref_rings(_jseg(seg), jcfg)
    got_lab, got_lf = tF.extract_rings(_tseg(seg),
                                       SlamConfig.from_dict(jcfg.to_dict()))
    np.testing.assert_array_equal(got_lab.numpy(), np.asarray(want_lab))
    np.testing.assert_array_equal(got_lf.numpy(), np.asarray(want_lf))
    lab = np.asarray(want_lab)
    assert (lab == 2).sum() > 4 and (lab == 1).sum() > 4
    assert (lab == -1).sum() > 4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_extract_ring(scan, dtype):
    """`extract_ring` on single rings (the first, a middle and the last)
    equals the reference's `extract_ring` on the same ring."""
    jcfg, seg, _, _ = scan
    seg = _as(seg, dtype)
    want_lab, want_lf = _ref_rings(_jseg(seg), jcfg)
    tcfg = SlamConfig.from_dict(jcfg.to_dict())
    L = seg.rng.shape[0]
    for i in (0, L // 2, L - 1):
        ring = {k: _t(getattr(seg, k)[i])
                for k in ("rng", "col", "ground", "valid", "count")}
        lab, lf = tF.extract_ring(ring, tcfg)
        assert lab.shape == seg.rng.shape[1:] and lab.dtype == torch.int32
        np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab[i]))
        np.testing.assert_array_equal(lf.numpy(), np.asarray(want_lf[i]))
    assert (np.asarray(want_lab)[[0, L // 2, L - 1]] != 0).sum() > 4


def test_voxel_downsample_ring_float64(scan):
    jcfg, seg, _, _ = scan
    seg = _as(seg, np.float64)
    _, lf = _ref_rings(_jseg(seg), jcfg)
    want = _ref_voxels(seg.xyz, seg.rel_time, lf, jcfg.surf_leaf_size)
    got = tF.voxel_downsample_ring(_t(seg.xyz), _t(seg.rel_time),
                                   _t(np.asarray(lf)), jcfg.surf_leaf_size)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=CENTROID_TOL_M)
    assert np.asarray(want[2]).sum() < np.asarray(lf).sum()   # it merged


def test_voxel_downsample_ring_float32(scan):
    """The port's float32 centroids (prefix sums in float64) within 1e-5 m
    of float64; the reference's float32 form within
    REF_F32_CENTROID_TOL_M, and on VLP-16 above 1e-4 m (the departure's
    reason)."""
    jcfg, seg, _, _ = scan
    s64, s32 = _as(seg, np.float64), _as(seg, np.float32)
    _, lf = _ref_rings(_jseg(s64), jcfg)
    lf = np.asarray(lf)
    exact = _ref_voxels(s64.xyz, s64.rel_time, lf, jcfg.surf_leaf_size)
    ref32 = _ref_voxels(s32.xyz, s32.rel_time, lf, jcfg.surf_leaf_size)
    got = tF.voxel_downsample_ring(_t(s32.xyz), _t(s32.rel_time), _t(lf),
                                   jcfg.surf_leaf_size)
    keep = np.asarray(exact[2])
    np.testing.assert_array_equal(got[2].numpy(), keep)
    np.testing.assert_array_equal(np.asarray(ref32[2]), keep)
    port_err = np.abs(got[0].numpy() - np.asarray(exact[0])).max()
    ref_err = np.abs(np.asarray(ref32[0]) - np.asarray(exact[0])).max()
    print(f"float32 centroids vs float64: port {port_err:.3e} m, "
          f"reference {ref_err:.3e} m")
    assert port_err <= PORT_F32_TOL_M
    assert ref_err <= REF_F32_CENTROID_TOL_M
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref32[0]), rtol=0,
                               atol=REF_F32_CENTROID_TOL_M)
    if seg.rng.shape[1] == 1800:
        assert ref_err > 1e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_extract_features_exact(scan, dtype):
    """Every feature set: valid and ring exact, sharp / flat / less-sharp /
    outlier coordinates and times exact, less-flat centroids within
    1e-9 m in float64 (float32: the reference's own float32 bound)."""
    jcfg, seg, out_xyz, out_mask = scan
    seg = _as(seg, dtype)
    out_xyz = out_xyz.astype(dtype)
    want = jax.jit(lambda s, o, m: jF.extract_features(s, o, m, jcfg))(
        _jseg(seg), jnp.asarray(out_xyz), jnp.asarray(out_mask))
    got = tF.extract_features(_tseg(seg), _t(out_xyz), _t(out_mask),
                              SlamConfig.from_dict(jcfg.to_dict()))
    tol = CENTROID_TOL_M if dtype == np.float64 else REF_F32_CENTROID_TOL_M
    for name in SETS:
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid),
                                      err_msg=name)
        np.testing.assert_array_equal(g.ring.numpy(), np.asarray(w.ring),
                                      err_msg=name)
        atol = tol if name == "less_flat" else 0.0
        np.testing.assert_allclose(g.xyz.numpy(), np.asarray(w.xyz), rtol=0,
                                   atol=atol, err_msg=name)
        np.testing.assert_allclose(g.rel_time.numpy(), np.asarray(w.rel_time),
                                   rtol=0, atol=atol, err_msg=name)
    assert int(got.less_flat.valid.sum()) > 50
    assert int(got.sharp.valid.sum()) > 4


# --- hand-made rings ---------------------------------------------------------

def _hand_rings(seed, S=120):
    """Rings built to hit the greedy picking's corners: integer ranges (so
    curvatures tie exactly), plateaus of ground (flat candidates), column
    gaps > 10, counts below 12, and points close enough to share voxels."""
    rng = np.random.default_rng(seed)
    counts = [0, 5, 11, 12, 13, 30, 64, S, S, S - 1]
    L = len(counts)
    r = np.zeros((L, S))
    col = np.zeros((L, S), np.int64)
    ground = np.zeros((L, S), bool)
    for i, c in enumerate(counts):
        steps = rng.integers(1, 3, S)
        steps[rng.random(S) < 0.08] = rng.integers(11, 30)   # column gaps
        col[i] = np.cumsum(steps)
        base = rng.integers(4, 9)
        r[i] = base + rng.integers(0, 3, S) * (rng.random(S) < 0.3)
        plateau = rng.random(S) < 0.5
        r[i] = np.where(plateau, base, r[i])
        ground[i] = plateau & (rng.random() < 0.8)
        r[i, c:] = 0
        col[i, c:] = 0
        ground[i, c:] = False
    valid = np.arange(S)[None] < np.asarray(counts)[:, None]
    az = col * 0.01
    elev = np.linspace(-0.2, 0.2, L)[:, None]
    xyz = np.stack([r * np.cos(az) * np.cos(elev),
                    r * np.sin(az) * np.cos(elev),
                    r * np.sin(elev) * np.ones_like(az)], -1)
    xyz = np.where(valid[..., None], xyz, 0.0)
    rel = np.where(valid, rng.random((L, S)), 0.0)
    return dict(xyz=xyz, rng=r, col=col.astype(np.int32), ground=ground,
                valid=valid, count=np.asarray(counts, np.int32),
                rel_time=rel, start_orientation=np.float64(0.0),
                orientation_diff=np.float64(2 * np.pi))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hand_made_rings(seed):
    jcfg = _exact(TINY)
    d = _hand_rings(seed)
    seg = SegmentedScan(**{k: _t(v) for k, v in d.items()})
    want_lab, want_lf = _ref_rings(d, jcfg)
    got_lab, got_lf = tF.extract_rings(seg,
                                       SlamConfig.from_dict(jcfg.to_dict()))
    lab = np.asarray(want_lab)
    np.testing.assert_array_equal(got_lab.numpy(), lab)
    np.testing.assert_array_equal(got_lf.numpy(), np.asarray(want_lf))
    # the cases are there: short rings with nothing picked, picks in the
    # first and last 5 points of a ring's sector range, rings with fewer
    # corner candidates than picks, suppression stopped by a column gap
    count = d["count"]
    assert not lab[count < 12].any()
    picks = [np.nonzero(lab[i])[0] for i in range(len(count))]
    assert any(len(p) and p.min() <= 10 for p in picks)
    assert any(len(p) and p.max() >= c - 12 for p, c in zip(picks, count))
    n_corner = (lab >= 1).sum(axis=1)
    assert ((n_corner > 0) & (n_corner < 6 * jcfg.edge_less_feature_num)).any()
    gaps = np.abs(np.diff(d["col"], axis=1)) > 10
    near_gap = [(np.abs(p[:, None] - np.nonzero(g)[0][None]) <= 5).any()
                for p, g in zip(picks, gaps) if len(p)]
    assert any(near_gap)
    # and the voxels, on the same rings
    want = _ref_voxels(d["xyz"], d["rel_time"], np.asarray(want_lf),
                       jcfg.surf_leaf_size)
    got = tF.voxel_downsample_ring(seg.xyz, seg.rel_time, got_lf,
                                   jcfg.surf_leaf_size)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=CENTROID_TOL_M)


def test_equal_curvatures_first_index_wins():
    """Three equal bumps 20 columns apart in the first sector of one ring
    (ranges in quarter metres, so the curvatures tie exactly): the first
    two by index are the sharp ones (greedy argmax, first index on ties),
    the third less-sharp; torch.argmax / argmin keep the first index too."""
    S = 450
    r = np.full(S, 20.0)
    peaks = [20, 40, 60]
    for p in peaks:
        r[p - 3:p + 4] += np.asarray([0, 0.25, 0.5, 0.75, 0.5, 0.25, 0])
    d = dict(xyz=np.zeros((1, S, 3)), rng=r[None], col=np.arange(
             S, dtype=np.int32)[None], ground=np.zeros((1, S), bool),
             valid=np.ones((1, S), bool), count=np.asarray([S], np.int32),
             rel_time=np.zeros((1, S)), start_orientation=np.float64(0.0),
             orientation_diff=np.float64(2 * np.pi))
    jcfg = _exact(TINY)
    want, _ = _ref_rings(d, jcfg)
    got, _ = tF.extract_rings(SegmentedScan(**{k: _t(v) for k, v in
                                               d.items()}),
                              SlamConfig.from_dict(jcfg.to_dict()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, peaks].tolist() == [2, 2, 1]
    x = torch.tensor([1.0, 3.0, 3.0, 0.0, 0.0])
    assert int(torch.argmax(x)) == 1 and int(torch.argmin(x)) == 3
    assert int(torch.argmax(torch.full((7,), -float("inf")))) == 0


def test_voxels_shared_and_colliding():
    """Points sharing a voxel merge into their centroid; distinct voxels
    whose int32 hashes collide merge too, in both packages."""
    rng = np.random.default_rng(5)
    L, S = 3, 64
    leaf = 0.2
    xyz = rng.uniform(-2, 2, (L, S, 3))
    xyz[:, :8] = xyz[:, :1] + rng.uniform(0, 0.01, (L, 8, 3))   # one voxel
    for row, (a, b) in enumerate(HASH_PAIRS):
        xyz[row, 10] = (np.asarray(a) + 0.5) * leaf
        xyz[row, 11] = (np.asarray(b) + 0.5) * leaf
    rel = rng.random((L, S))
    mask = rng.random((L, S)) < 0.9
    mask[:, :12] = True
    want = _ref_voxels(xyz, rel, mask, leaf)
    got = tF.voxel_downsample_ring(_t(xyz), _t(rel), _t(mask), leaf)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=CENTROID_TOL_M)
    h = tF._voxel_hash32(_t(xyz), leaf)
    assert bool((h[0, 10] == h[0, 11]) & (h[1, 10] == h[1, 11]))
    assert int(got[2].sum()) < int(mask.sum()) - 8


# --- odometry in exact mode ----------------------------------------------------

N_SCANS = 10
STREAMED = 6


def _drive(odo, data, chunked):
    imu_i = 0
    cfg = odo.cfg
    for k in range(N_SCANS):
        t_scan = data["scan_times"][k] + cfg.scan_period
        while (imu_i < len(data["imu_times"])
               and data["imu_times"][imu_i] <= t_scan + 1e-9):
            odo.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                        data["imu_gyr"][imu_i])
            imu_i += 1
        if not chunked or k < STREAMED:
            odo.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
    if chunked:
        ks = range(STREAMED, N_SCANS)
        odo.add_scan_chunk(
            np.asarray([data["scan_times"][k] + cfg.scan_period for k in ks]),
            np.stack([data["scans_xyz"][k] for k in ks]),
            np.asarray([data["scans_n"][k] for k in ks]))
    return odo


@pytest.mark.parametrize("chunked", [False, True])
def test_odometry_exact_mode(chunked):
    jcfg = _exact(TINY)
    tcfg = SlamConfig.from_dict(jcfg.to_dict())
    data = jsyn.generate_sequence(jcfg, n_scans=N_SCANS, kind="gentle",
                                  speed=1.5)
    _, jp, jq = _drive(JOdometry(jcfg), data, False).trajectory_arrays()
    todo = _drive(TOdometry(tcfg, dtype=torch.float64, device="cpu"), data,
                  chunked)
    _, tp, tq = todo.trajectory_arrays()
    assert len(tp) == N_SCANS - 1
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-6)
    assert np.linalg.norm(tp[-1] - tp[0]) > 0.5
