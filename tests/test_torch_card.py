"""Checks of the port that need an NVIDIA card and nvcc (marker `cuda`);
each skips without a card.  This file imports neither JAX nor the reference
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_card.py -q

(`--noconftest`: tests/conftest.py configures JAX for the CPU tests.)"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lins_tpu_torch.config import TINY
from lins_tpu_torch.ops import assoc, label, select


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (python3 chip_smoke.py runs these "
                    "checks at the main path's shapes)")
    return torch.device("cuda")


def _host_syncs(fn):
    """`fn()`'s host syncs by site (`chip_smoke.count_host_syncs`) and the
    spans it records (`chip_smoke.record_spans`)."""
    import chip_smoke

    with chip_smoke.record_spans() as spans, \
            chip_smoke.count_host_syncs() as sites:
        fn()
        torch.cuda.synchronize()
    return sites, spans


def _assert_read_sites(sites, spans):
    """Every host sync at the odometry's and the mapper's read sites, as
    many as the `reads` of the spans; none in the front end."""
    import chip_smoke

    reads = sum(s["attrs"].get("reads", 0) for s in spans)
    assert all(site.startswith(chip_smoke.READ_SITES)
               for site in sites), dict(sites)
    assert sum(sites.values()) == reads > 0, (dict(sites), reads)


def _random_edges(shape, seed):
    rng = np.random.default_rng(seed)
    el = rng.random(shape) < 0.7
    er = (rng.random(shape) < 0.55) & el & np.roll(el, -1, axis=-1)
    ed = (rng.random(shape) < 0.55) & el
    ed[..., :-1, :] &= el[..., 1:, :]
    ed[..., -1, :] = False
    return er, ed, el


def _seam_edges(kind, S=1800):
    """K1's piece seams at 16 x S (8 blocks of 2 rows a scan): a snake of
    vertical runs joined alternately in the last and first row, a comb
    whose teeth join only in the last row, runs wrapping from column S-1 to
    0 on each piece's first and last row (rows 3 and 4 joined), and every
    cell eligible with every edge on."""
    L = 16
    el, er, ed = (np.zeros((L, S), bool) for _ in range(3))
    if kind == "snake":
        for k, c in enumerate(range(0, S - 1, 2)):
            el[:, c] = True
            ed[:-1, c] = True
            if c + 2 < S - 1:
                row = L - 1 if k % 2 == 0 else 0
                el[row, c:c + 3] = True
                er[row, c:c + 2] = True
    elif kind == "comb":
        el[:, ::3] = True
        ed[:-1, ::3] = True
        el[L - 1] = er[L - 1] = True
    elif kind == "wrap":
        for r in (0, 3, 4, 7, 8, 11, 12, 15):
            el[r, :3] = el[r, -3:] = True
            er[r, :2] = er[r, -3:] = True
        ed[3, 1] = True
    else:
        el[:], er[:], ed[:] = True, True, True
    return er, ed, el


# random graphs at the main path's and other routed shapes (rows that 8
# blocks do not divide, TINY's 8 x 450 and S not a multiple of 4, one scan
# and none), and the piece-seam cases
LABEL_CASES = {
    "random_8x16x1800": lambda: _random_edges((8, 16, 1800), 0),
    "random_13_rows": lambda: _random_edges((4, 13, 1800), 1),
    "random_tiny_8x450": lambda: _random_edges((4, 8, 450), 2),
    "random_5x31": lambda: _random_edges((3, 5, 31), 3),
    "one_scan": lambda: _random_edges((16, 1800), 4),
    "no_scan": lambda: _random_edges((0, 16, 1800), 5),
    "snake": lambda: _seam_edges("snake"),
    "comb": lambda: _seam_edges("comb"),
    "wrap_on_piece_rows": lambda: _seam_edges("wrap"),
    "all_on": lambda: _seam_edges("all_on"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_label_kernel_matches_plain(cuda_device, case):
    arrs = [torch.as_tensor(a, device=cuda_device)
            for a in LABEL_CASES[case]()]
    scans = arrs[2].shape[0] if arrs[2].dim() == 3 else 1
    before = label.label_components.launches
    got = label.label_components(*arrs)
    assert label.label_components.launches == before + (scans > 0)
    assert torch.equal(got, label.label_components_plain(*arrs))


def _launched_kernels(shape, seed):
    """Names of the kernels one `label_components` call launches on random
    masks of `shape`, from torch.profiler in a fresh process: in a process
    that has profiled before, the profiler has recorded no launch of the
    port's own kernels."""
    code = f"""
import json, sys
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from lins_tpu_torch.ops import label
rng = np.random.default_rng({seed})
el = rng.random({shape!r}) < 0.7
er = (rng.random({shape!r}) < 0.55) & el
ed = (rng.random({shape!r}) < 0.55) & el
arrs = [torch.as_tensor(a, device="cuda") for a in (er, ed, el)]
label.label_components(*arrs)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    label.label_components(*arrs)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_label_kernel_one_launch(cuda_device):
    """One K1 call is one kernel on the card: a cluster per scan, no
    second launch."""
    names = _launched_kernels((32, 16, 1800), 6)
    assert len(names) == 1 and "label_union_find" in names[0], names


@pytest.mark.cuda
def test_label_launcher_refuses_oversized_pieces(cuda_device):
    """K1's launcher refuses, without launching, a grid whose piece (one
    row here) does not fit a block's shared memory; `route` never sends it
    one."""
    arrs = [torch.zeros((1, 1, 60000), dtype=torch.bool, device=cuda_device)
            for _ in range(3)]
    out = torch.full((1, 1, 60000), 7, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="refused"):
        label._call("label_components", "label_components_launch", *arrs,
                    out, 1, 1, 60000)
    torch.cuda.synchronize()
    assert int(out.min()) == 7


@pytest.mark.cuda
def test_label_kernel_refuses_tall_grids(cuda_device):
    """A grid over one block's shared memory goes to K2 when it is a stack
    of 16-row blocks; any other is refused, not labelled by a fallback."""
    arrs = [torch.zeros((1, 72, 1800), dtype=torch.bool, device=cuda_device)
            for _ in range(3)]
    with pytest.raises(ValueError, match="shared memory"):
        label.label_components(*arrs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 1800), (3, 64, 1024),
                                   (1, 32, 2000), (2, 96, 1800),
                                   (2, 128, 1024)])
def test_blocked_kernel_matches_plain(cuda_device, shape):
    """8 blocks of 8 rows a scan up to 64 rows, 16-row blocks above."""
    arrs = [torch.as_tensor(a, device=cuda_device)
            for a in _random_edges(shape, shape[2])]
    before = label._label_blocked.launches
    got = label.label_components(*arrs)
    assert label._label_blocked.launches == before + 1
    assert torch.equal(got, label.label_blocked_plain(*arrs))
    assert torch.equal(got, label.label_components_plain(*arrs))


@pytest.mark.cuda
def test_blocked_kernel_one_launch(cuda_device):
    """One K2 call is one kernel on the card: the pieces are joined in the
    cluster's shared memory, with no second launch and no parent table."""
    names = _launched_kernels((4, 64, 1800), 7)
    assert len(names) == 1 and "label_cluster" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("S", [900, 1024])
def test_blocked_kernel_seam_cases(cuda_device, S):
    """A column through every seam, a ring segment wrapping the column seam
    joined down across two row seams, an empty and a full grid."""
    L = 64
    cases = []
    el, ed = np.zeros((L, S), bool), np.zeros((L, S), bool)
    el[:, 7] = True
    ed[:-1, 7] = True
    cases.append((np.zeros((L, S), bool), ed, el))
    el, er, ed = (np.zeros((L, S), bool) for _ in range(3))
    el[15, :4] = el[15, -4:] = True
    er[15, -4:] = er[15, :3] = True
    el[16:40, S - 4] = True
    ed[15:39, S - 4] = True
    cases.append((er, ed, el))
    cases.append(tuple(np.zeros((L, S), bool) for _ in range(3)))
    full = np.ones((L, S), bool)
    ed = full.copy()
    ed[-1] = False
    cases.append((full, ed, full))
    for er, ed, el in cases:
        arrs = [torch.as_tensor(a, device=cuda_device) for a in (er, ed, el)]
        got = label.label_components(*arrs)
        assert torch.equal(got, label.label_blocked_plain(*arrs))
    assert int(got.max()) == 0          # the full grid: one component


def _sequence(device):
    from lins_tpu_torch.datasets.synthetic import generate_sequence

    return generate_sequence(TINY.replace(use_pallas=True), n_scans=8,
                             kind="gentle", speed=1.5, device=device)


@pytest.mark.cuda
def test_replay_on_card_matches_cpu(cuda_device):
    """float32 on the card within 1 cm of float64 on the CPU, through the
    label kernel."""
    from lins_tpu_torch.slam import LinsSlam

    cfg = TINY.replace(use_pallas=True)
    data = _sequence(cuda_device)
    before = label.label_components.launches
    card = LinsSlam(cfg, enable_mapping=False)
    card.run_replay(data, chunk=6)
    assert label.label_components.launches > before
    cpu = LinsSlam(cfg, enable_mapping=False, device="cpu",
                   dtype=torch.float64).run_replay(data, chunk=6)
    _, pg, _ = card.trajectory_arrays()
    _, pc, _ = cpu.trajectory_arrays()
    assert np.isfinite(pg).all()
    np.testing.assert_allclose(pg, pc, rtol=0, atol=0.01)


@pytest.mark.cuda
def test_chunk_syncs_only_at_read_sites(cuda_device):
    """An odometry chunk's host syncs are the reads of its loop and
    fallback flags at the port's read sites, as many as its spans
    count."""
    from lins_tpu_torch.odometry import LinsOdometry

    cfg = TINY.replace(use_pallas=True)
    data = _sequence(cuda_device)
    odo = LinsOdometry(cfg)
    imu_t = data["imu_times"]
    imu_i = 0
    for t in [data["scan_times"][k] + cfg.scan_period for k in range(2)] + [
            np.inf]:
        while imu_i < len(imu_t) and imu_t[imu_i] <= t + 1e-9:
            odo.add_imu(imu_t[imu_i], data["imu_acc"][imu_i],
                        data["imu_gyr"][imu_i])
            imu_i += 1
        if np.isfinite(t):
            k = int(round(t / cfg.scan_period)) - 1
            odo.add_scan(t, data["scans_xyz"][k], data["scans_n"][k])
    ks = range(2, 8)
    (ts, xs, ns, imu), = odo.prefetch_chunks(
        [data["scan_times"][k] + cfg.scan_period for k in ks],
        [data["scans_xyz"][k] for k in ks], [data["scans_n"][k] for k in ks],
        chunk=6, with_imu=True)
    sites, spans = _host_syncs(lambda: odo.add_scan_chunk(ts, xs, ns,
                                                           imu=imu))
    _assert_read_sites(sites, spans)
    assert len(odo.trajectory) == 7


def _select_grid(device, seed, Q=300, nb=8, cap=64, table=97):
    """A random map grid and query rows with exact ties (duplicates and a
    0.25 m lattice), two neighbour cells hashed to one bucket, tombstones
    at SENTINEL, counts below cap and empty buckets, rows with fewer than
    C+1 candidates, an all-invalid row and invalid queries: the arguments
    of select_candidates before C."""
    rng = np.random.default_rng(seed)
    q = np.round(rng.uniform(-1, 1, (Q, 3)) * 4) / 4
    cells = np.round(rng.uniform(-2.5, 2.5, (table, 3, cap)) * 4) / 4
    cells[:, :, 1] = cells[:, :, 0]
    cnt = rng.integers(0, cap + 1, table)
    cnt[::7], cnt[1::11] = cap, 0
    cells.transpose(0, 2, 1)[rng.random((table, cap)) < 0.05] = 1.0e9
    bb = rng.integers(0, table, (Q, nb))
    bb[::3, 1] = bb[::3, 0]
    bb[1:9] = rng.choice(np.flatnonzero(cnt <= 1), (8, nb))
    bb[0] = np.flatnonzero(cnt == 0)[0]
    qv = rng.random(Q) < 0.9
    qv[9] = False
    return [torch.as_tensor(a, device=device) for a in
            (q.astype(np.float32), qv, bb.astype(np.int32),
             cells.astype(np.float32), cnt.astype(np.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,cap,C", [(8, 64, 32), (27, 216, 32), (2, 9, 17)])
def test_select_kernel_matches_plain(cuda_device, nb, cap, C):
    """K3 (gather, selection and finishing in one launch) bit for bit equal
    to its plain version, for both d2C rules."""
    args = _select_grid(cuda_device, nb, nb=nb, cap=cap)
    for first_dropped in (True, False):
        before = select.select_candidates.launches
        got = select.select_candidates(*args, C, first_dropped=first_dropped)
        assert select.select_candidates.launches == before + 1
        want = select.select_candidates_plain(*args, C,
                                              first_dropped=first_dropped)
        assert torch.equal(got[1], want[1])
        for k in (0, 2, 3):
            assert torch.equal(got[k].view(torch.int32),
                               want[k].view(torch.int32))
        assert 0 < int(want[1].sum()) < want[1].numel()


@pytest.mark.cuda
def test_select_kernel_on_fused_supercell_grid(cuda_device):
    """K3 on a supercell grid from `build_grid_voxelized` (the reference's
    leaf 0.4 m, m 5, cap 128, nb 8; tests/test_mapping.py:256-268) bit for
    bit equal to its plain version, one launch through `gather_candidates`;
    the grid's counts those of the same build on the CPU and its centroids
    within 1e-6 m."""
    from lins_tpu_torch.ops import grid_nn

    rng = np.random.default_rng(3)
    centers = rng.uniform(-20, 20, (40, 3))
    pts = np.concatenate([c + rng.normal(scale=0.5, size=(30, 3))
                          for c in centers]).astype(np.float32)
    q = (pts[rng.integers(0, len(pts), 200)]
         + rng.normal(scale=0.3, size=(200, 3))).astype(np.float32)
    qv = rng.random(200) > 0.1
    kw = dict(leaf=0.4, m=5, table=4096, cap=128, nb=8)
    ok = np.ones(len(pts), bool)
    grid, n_vox = grid_nn.build_grid_voxelized(
        torch.as_tensor(pts, device=cuda_device),
        torch.as_tensor(ok, device=cuda_device), **kw)
    cpu, n_cpu = grid_nn.build_grid_voxelized(torch.as_tensor(pts),
                                              torch.as_tensor(ok), **kw)
    assert int(n_vox) == int(n_cpu) == int(grid.cnt.sum()) > 500
    assert torch.equal(grid.cnt.cpu(), cpu.cnt)
    assert float((grid.cells.cpu() - cpu.cells).abs().max()) <= 1e-6
    qt = torch.as_tensor(q, device=cuda_device)
    qvt = torch.as_tensor(qv, device=cuda_device)
    bb = grid_nn._bucket_of(grid_nn._neighborhood(qt, grid)[0], grid.table)
    args = (qt, qvt, bb, grid.cells, grid.cnt)
    for first_dropped in (True, False):
        before = select.select_candidates.launches
        got = select.select_candidates(*args, 64, first_dropped=first_dropped)
        assert select.select_candidates.launches == before + 1
        want = select.select_candidates_plain(*args, 64,
                                              first_dropped=first_dropped)
        assert torch.equal(got[1], want[1])
        for k in (0, 2, 3):
            assert torch.equal(got[k].view(torch.int32),
                               want[k].view(torch.int32))
        assert int(want[1].sum()) > 1000
    before = select.select_candidates.launches
    grid_nn.gather_candidates(qt, qvt, grid, 64, True)
    assert select.select_candidates.launches == before + 1


@pytest.mark.cuda
def test_select_kernel_refuses_bad_inputs(cuda_device):
    q, qv, bb, cells, cnt = _select_grid(cuda_device, 0, Q=16, nb=2, cap=8)
    with pytest.raises(TypeError, match="float32"):
        select.select_candidates(q.double(), qv, bb, cells.double(), cnt, 4)
    with pytest.raises(TypeError, match="int32"):
        select.select_candidates(q, qv, bb.long(), cells, cnt, 4)
    with pytest.raises(ValueError, match="shape"):
        select.select_candidates(q, qv[:-1], bb, cells, cnt, 4)
    with pytest.raises(ValueError, match="cpu"):
        select.select_candidates(q, qv, bb.cpu(), cells, cnt, 4)
    with pytest.raises(ValueError, match="C\\+1"):
        select.select_candidates(q, qv, bb, cells, cnt, 16)
    with pytest.raises(ValueError, match="contiguous"):
        select.select_candidates(q, qv, bb, cells.transpose(1, 2)
                                 .contiguous().transpose(1, 2), cnt, 4)
    with pytest.raises(ValueError, match="1 to 32 buckets"):
        select.select_candidates(q, qv, bb.repeat(1, 17), cells, cnt, 4)
    # the launcher's own refusals, with no launch: a sort buffer over 256
    # words, a block over the card's shared memory
    before = select.select_candidates.launches
    wide = _select_grid(cuda_device, 1, Q=16, nb=2, cap=200, table=11)
    with pytest.raises(ValueError, match="refused"):
        select.select_candidates(*wide, 300)
    big = _select_grid(cuda_device, 2, Q=16, nb=32, cap=2000, table=11)
    with pytest.raises(ValueError, match="refused"):
        select.select_candidates(*big, 4)
    assert select.select_candidates.launches == before
    # a row longer than the 47 KB of shared memory a K6 block gets unasked
    long_row = torch.zeros((1, 12100), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        select.topk_smallest(long_row, 4)


def _topk_rows(name):
    rng = np.random.default_rng(len(name))
    if name == "B = 1000":
        return rng.uniform(0, 100, (100, 1000))
    if name == "signed zeros":
        x = rng.uniform(-50, 50, (64, 1000))
        x[:, ::7], x[:, 3::7] = 0.0, -0.0
        x[0], x[1, 500:], x[2] = -0.0, np.inf, -np.inf
        return x
    if name == "one value a row":
        return np.repeat(rng.integers(-3, 4, (32, 1)), 1728, axis=1)
    return rng.uniform(0, 1, (8, 12032))       # longest accepted rows


@pytest.mark.cuda
@pytest.mark.parametrize("name,C", [
    ("B = 1000", 1), ("B = 1000", 64), ("B = 1000", 1000),
    ("signed zeros", 1), ("signed zeros", 143), ("signed zeros", 1000),
    ("one value a row", 1), ("one value a row", 1728),
    ("long rows", 64), ("long rows", 12032)])
def test_topk_kernel_edge_cases(cuda_device, name, C):
    """K6 bit for bit equal to its plain version (a stable sort: -0.0 and
    +0.0 equal, the lower index first) and equal in value to torch.topk,
    for C = 1 to B, rows not a multiple of 32, negative values, signed
    zeros, infinities, rows of one value and the longest rows."""
    x = torch.as_tensor(np.asarray(_topk_rows(name), np.float32),
                        device=cuda_device)
    got = select.topk_smallest(x, C)
    want = select.topk_smallest_plain(x, C)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, torch.topk(x, C, dim=1, largest=False).values)


@pytest.mark.cuda
@pytest.mark.parametrize("Q,B,C", [(128, 256, 8), (1024, 1728, 64)])
def test_topk_kernel_matches_plain(cuda_device, Q, B, C):
    rng = np.random.default_rng(Q)
    d2 = rng.uniform(0, 100, (Q, B)).astype(np.float32)
    d2[0] = np.inf
    d2[1, ::2] = 3.0
    x = torch.as_tensor(d2, device=cuda_device)
    before = select.topk_smallest.launches
    got = select.topk_smallest(x, C)
    assert select.topk_smallest.launches == before + 1
    assert torch.equal(got, select.topk_smallest_plain(x, C))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.sort(d2, axis=1)[:, :C])


@pytest.mark.cuda
def test_mapping_replay_on_card_matches_cpu(cuda_device):
    """With mapping, float32 on the card within 5 cm of float64 on the CPU
    (the reference's cross-backend gate), every selection through K3."""
    from lins_tpu_torch.slam import LinsSlam

    cfg = TINY.replace(use_pallas=True, use_pallas_select=True,
                       loop_attempts=False)
    kw = dict(corner_cap=256, surf_cap=1024, map_corner_cap=4096,
              map_surf_cap=8192)
    data = _sequence(cuda_device)
    before = select.select_candidates.launches
    plain_before = select.select_candidates_plain.calls
    card = LinsSlam(cfg, **kw).run_replay(data, chunk=6)
    assert select.select_candidates.launches > before
    assert select.select_candidates_plain.calls == plain_before
    cpu = LinsSlam(cfg, device="cpu", dtype=torch.float64, **kw).run_replay(
        data, chunk=6)
    _, pg, _ = card.trajectory_arrays()
    _, pc, _ = cpu.trajectory_arrays()
    assert np.isfinite(pg).all()
    np.testing.assert_allclose(pg, pc, rtol=0, atol=0.05)


@pytest.mark.cuda
def test_loop_replay_on_card(cuda_device):
    """Full SLAM with loop closure on the card (TINY sensor, the revisiting
    circuit of tests/test_slam_integration.py): every chunk's host syncs
    at the odometry's and the mapper's read sites, as many as its spans'
    `reads`, loop attempts that found a candidate aligned with K3, at
    least one loop closed, one edge per keyframe after the first plus one
    per loop; the first scans within 5 cm of float64 on the CPU."""
    from lins_tpu_torch.datasets.synthetic import generate_sequence
    from lins_tpu_torch.slam import LinsSlam

    cfg = TINY.replace(use_pallas=True, use_pallas_select=True,
                       loop_time_gate=4.0)
    kw = dict(corner_cap=256, surf_cap=1024, map_corner_cap=4096,
              map_surf_cap=8192)
    data = generate_sequence(cfg, n_scans=95, kind="loop", speed=2.2,
                             loop_scale=0.32, acc_noise=0.02,
                             gyr_noise=0.002, ba=(0.05, -0.03, 0.02),
                             bw=(0.002, -0.001, 0.0015), device=cuda_device)
    card = LinsSlam(cfg, **kw)
    jobs, tail = card.stage_replay(data, chunk=12)
    plain_before = (select.select_candidates_plain.calls,
                    label.label_components_plain.calls)
    for job in jobs:
        _assert_read_sites(*_host_syncs(
            lambda: card.run_chunk(job)))
    for j in tail:
        card.add_scan(float(data["scan_times"][j]) + cfg.scan_period,
                      data["scans_xyz"][j], data["scans_n"][j])
    assert (select.select_candidates_plain.calls,
            label.label_components_plain.calls) == plain_before
    m = card.mapper
    st = m.state
    n_loops = int(st.n_loops)
    assert len(m.loop_info) >= 8
    assert n_loops >= 1
    acc = [i for i in m.loop_info if bool(i["accepted"])]
    assert len(acc) == n_loops and all(float(i["fitness"]) < 0.3
                                       for i in acc)
    assert int(st.edges.count) == int(st.store.count) - 1 + n_loops
    _, pg, qg = card.trajectory_arrays()
    assert np.isfinite(pg).all() and np.isfinite(qg).all()
    cpu = LinsSlam(cfg, device="cpu", dtype=torch.float64, **kw).run_replay(
        data, n_scans=26, chunk=12)
    _, pc, _ = cpu.trajectory_arrays()
    np.testing.assert_allclose(pg[:len(pc)], pc, rtol=0, atol=0.05)


def _assoc_sets(device, seed, lattice=False, shapes=((96, 700), (40, 300)),
                on_rings=tuple(range(16)), one_reference=False):
    """Random K4 and K5 sets on the card: queries in a 40 m box, references
    about them on the rings `on_rings` (16 by default), about 10% of each
    invalid (their coordinates NaN); `lattice` puts every coordinate on a
    0.25 m lattice with no de-skew time, so distances tie exactly;
    `one_reference` leaves a single valid reference."""
    rng = np.random.default_rng(seed)
    sets = []
    for Q, R in shapes:
        q = rng.uniform(-20, 20, (Q, 3)) * np.asarray([1.0, 1.0, 0.2])
        about = q if Q else rng.uniform(-20, 20, (1, 3))
        r = about[rng.integers(0, len(about), R)] + rng.normal(0, 0.6, (R, 3))
        rel = rng.uniform(0, 1, Q)
        if lattice:
            q, r, rel = np.round(q * 4) / 4, np.round(r * 4) / 4, 0 * rel
        qv, rv = rng.random(Q) < 0.9, rng.random(R) < 0.9
        if one_reference:
            rv[:] = False
            rv[R // 2] = True
        q[~qv], r[~rv] = np.nan, np.nan
        ring = rng.choice(np.asarray(on_rings), R)

        def t(a, dt=torch.float32):
            return torch.as_tensor(a).to(device=device, dtype=dt)

        sets.append((assoc.Queries(t(q), t(rel), t(qv, torch.bool)),
                     assoc.references(t(r), t(ring, torch.int32),
                                      t(rv, torch.bool))))
    return sets


@pytest.mark.cuda
@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("form", ["ieskf", "gn"])
def test_assoc_kernel_matches_plain(cuda_device, form, lattice):
    """K4 and K5 in one launch against their plain versions: counts equal,
    each entry (a, b) of the Gram of [J6 | r] (JtJ, Jtr, Σr²) within
    2·Q·2⁻²⁴ of its own scale sqrt(G_aa·G_bb), by Cauchy-Schwarz a bound of
    its sum of |terms| (two float32 sums of Q rows in different orders;
    chip_smoke.py K45_TOL)."""
    surf, corner = _assoc_sets(cuda_device, 3 + lattice, lattice)
    rn = torch.tensor([0.2, -0.1, 0.03], device=cuda_device)
    qbn = torch.tensor([0.999, 0.012, -0.02, 0.03], device=cuda_device)
    qbn = qbn / torch.linalg.vector_norm(qbn)
    pose = assoc.pose_scalars(rn, qbn, form)
    scale = 1.0 if form == "ieskf" else assoc.GN_RES_SCALE
    kept = 0
    for weighted in (False, True):
        before = (assoc.surf_normal_equations.launches,
                  assoc.corner_normal_equations.launches)
        got = assoc.launch(surf, corner, pose, form, weighted, 25.0, scale)
        assert (assoc.surf_normal_equations.launches,
                assoc.corner_normal_equations.launches) == (
                    before[0] + 1, before[1] + 1)
        for k, (kind, pair) in enumerate(((assoc.SURF, surf),
                                          (assoc.CORNER, corner))):
            want = assoc._plain(kind, *pair, pose, form, weighted, 25.0,
                                scale)
            assert int(got[k][3]) == int(want[3])
            kept += int(want[3])
            g, w = _gram(got[k]), _gram(want)
            assert torch.isfinite(g).all()
            d = w.diagonal().clamp(min=0.0)
            tol = 2 * pair[0].xyz.shape[0] * 2.0 ** -24 * torch.sqrt(
                d[:, None] * d[None, :])
            assert bool(((g - w).abs() <= tol).all())
    assert kept > 20


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("two neighbouring rings", dict(on_rings=(7, 8))),
    ("five rings, the end ones two from their neighbours",
     dict(on_rings=(0, 2, 7, 13, 15))),
    ("first two and last two rings", dict(on_rings=(0, 1, 14, 15))),
    ("the layout's last rings", dict(on_rings=(253, 254, 255))),
    ("one valid ring", dict(on_rings=(5,))),
    ("a single valid reference", dict(one_reference=True)),
])
def test_assoc_kernel_ring_edge_cases(cuda_device, name, kw):
    """K4 and K5 on references on few rings, with i1 on the first or last
    ring (the ±2 window clipped), on one ring, and with one valid
    reference: counts equal the plain version's, blocks within its rule,
    and rows are kept wherever a ring has a neighbour within ±2; the
    card's layout equals the CPU's."""
    surf, corner = _assoc_sets(cuda_device, 9, **kw)
    for _, ref in (surf, corner):
        cpu = assoc.ring_layout(ref.xyz.cpu(), ref.ring.cpu(),
                                ref.valid.cpu())
        # bit for bit: the invalid rows past the valid ones hold NaN
        assert torch.equal(ref.packed.cpu().view(torch.int32),
                           cpu[0].view(torch.int32))
        assert torch.equal(ref.offsets.cpu(), cpu[1])
    rn = torch.tensor([0.2, -0.1, 0.03], device=cuda_device)
    qbn = torch.tensor([0.999, 0.012, -0.02, 0.03], device=cuda_device)
    qbn = qbn / torch.linalg.vector_norm(qbn)
    for form in ("ieskf", "gn"):
        pose = assoc.pose_scalars(rn, qbn, form)
        scale = 1.0 if form == "ieskf" else assoc.GN_RES_SCALE
        got = assoc.launch(surf, corner, pose, form, True, 25.0, scale)
        for k, (kind, pair) in enumerate(((assoc.SURF, surf),
                                          (assoc.CORNER, corner))):
            want = assoc._plain(kind, *pair, pose, form, True, 25.0, scale)
            assert int(got[k][3]) == int(want[3]), name
            if len(kw.get("on_rings", ())) > 1:
                assert int(want[3]) > 0, name
            g, w = _gram(got[k]), _gram(want)
            d = w.diagonal().clamp(min=0.0)
            tol = 2 * pair[0].xyz.shape[0] * 2.0 ** -24 * torch.sqrt(
                d[:, None] * d[None, :])
            assert bool(((g - w).abs() <= tol).all()), name


def _gram(blocks):
    """The (7, 7) float64 Gram of [J6 | r] from (JtJ, Jtr, Σr², n)."""
    G = torch.zeros((7, 7), dtype=torch.float64)
    G[:6, :6] = blocks[0].double().cpu()
    G[:6, 6] = G[6, :6] = blocks[1].double().cpu()
    G[6, 6] = blocks[2].double().cpu()
    return G


@pytest.mark.cuda
def test_assoc_wrappers_and_empty_sets(cuda_device):
    """The attic-named wrappers launch one set each; an empty query set
    gives zeros; float64 on the card is refused."""
    (sq, sr), (cq, cr) = _assoc_sets(cuda_device, 5,
                                     shapes=((64, 500), (0, 200)))
    rn = torch.zeros(3, device=cuda_device)
    qbn = torch.tensor([1.0, 0.0, 0.0, 0.0], device=cuda_device)
    args = (sq.xyz, sq.rel, sq.valid, sr.xyz, sr.ring, sr.valid, rn, qbn, 2)
    before = assoc.surf_normal_equations.launches
    got = assoc.surf_normal_equations(*args)
    assert assoc.surf_normal_equations.launches == before + 1
    want = assoc.surf_normal_equations_plain(*args)
    assert int(got[3]) == int(want[3]) > 0
    before = assoc.corner_normal_equations.launches
    empty = assoc.corner_normal_equations(cq.xyz, cq.rel, cq.valid, cr.xyz,
                                          cr.ring, cr.valid, rn, qbn, 2)
    assert assoc.corner_normal_equations.launches == before
    assert int(empty[3]) == 0 and float(empty[0].abs().max()) == 0.0
    with pytest.raises(TypeError, match="float32"):
        assoc.surf_normal_equations(sq.xyz.double(), sq.rel.double(),
                                    sq.valid, sr.xyz.double(), sr.ring,
                                    sr.valid, rn.double(), qbn.double(), 2)


@pytest.mark.cuda
def test_odometry_association_runs_through_k4_k5(cuda_device):
    """A card replay takes every trip's normal equations from K4 and K5
    (one launch a trip its IESKF and GN spans issued, at least one a
    RUNNING scan), with no plain association."""
    import chip_smoke

    from lins_tpu_torch.slam import LinsSlam

    cfg = TINY.replace(use_pallas=True)
    data = _sequence(cuda_device)
    before = (assoc.surf_normal_equations.launches,
              assoc.corner_normal_equations.launches,
              assoc.surf_normal_equations_plain.calls,
              assoc.corner_normal_equations_plain.calls)
    with chip_smoke.record_spans() as spans:
        LinsSlam(cfg, enable_mapping=False).run_replay(data, chunk=6)
    trips = chip_smoke.odometry_trips(spans)
    assert trips >= 8 - 2
    assert assoc.surf_normal_equations.launches - before[0] == trips
    assert assoc.corner_normal_equations.launches - before[1] == trips
    assert assoc.surf_normal_equations_plain.calls == before[2]
    assert assoc.corner_normal_equations_plain.calls == before[3]


@pytest.mark.cuda
def test_select_radius_on_card_ties(cuda_device):
    """The radius selection on the card keeps the CPU's ids exactly where
    distances tie (integer offsets: every distance exact) and across dead
    slots, for windows that cut through the ties."""
    from lins_tpu_torch.mapping import keyframes as kf
    from lins_tpu_torch.mapping import local_map as lmn

    rng = np.random.default_rng(0)
    cfg = TINY.replace(max_keyframes=512)
    store = kf.empty_store(cfg, 4, 8, 8)
    pos = rng.integers(-4, 5, size=(512, 3)).astype(np.float32)
    kf_id = (rng.permutation(512) + 600).astype(np.int32)
    kf_id[rng.random(512) < 0.25] = -1
    store = store._replace(pos=torch.as_tensor(pos),
                           kf_id=torch.as_tensor(kf_id),
                           count=torch.tensor(1112, dtype=torch.int32))
    card = store._replace(pos=store.pos.to(cuda_device),
                          kf_id=store.kf_id.to(cuda_device))
    cur = torch.tensor([0.0, 1.0, -1.0])
    for W in (1, 7, 50, 200):
        want = lmn.select_radius(store, cur, 4.0, W)
        got = lmn.select_radius(card, cur.to(cuda_device), 4.0, W)
        assert torch.equal(got[0].cpu(), want[0]), W
        assert torch.equal(got[1].cpu(), want[1]), W


@pytest.mark.cuda
def test_radius_mapping_on_card_matches_cpu(cuda_device):
    """The radius-selected map (loop closure off) on the card within 5 cm
    of float64 on the CPU over 14 scans, every selection through K3, and
    the same keyframes selected at the end."""
    from lins_tpu_torch.datasets.synthetic import generate_sequence
    from lins_tpu_torch.slam import LinsSlam

    cfg = TINY.replace(use_pallas=True, use_pallas_select=True,
                       loop_closure_enabled=False)
    kw = dict(corner_cap=256, surf_cap=1024, map_corner_cap=4096,
              map_surf_cap=8192)
    data = generate_sequence(cfg, n_scans=14, kind="gentle", speed=1.5,
                             device=cuda_device)
    before = select.select_candidates.launches
    card = LinsSlam(cfg, **kw).run_replay(data, chunk=6)
    assert select.select_candidates.launches > before
    cpu = LinsSlam(cfg, device="cpu", dtype=torch.float64, **kw).run_replay(
        data, chunk=6)
    _, pg, _ = card.trajectory_arrays()
    _, pc, _ = cpu.trajectory_arrays()
    assert np.isfinite(pg).all()
    np.testing.assert_allclose(pg, pc, rtol=0, atol=0.05)
    sel = cpu.mapper.state.lmap.sel
    assert (sel >= 0).sum() >= 2
    assert torch.equal(card.mapper.state.lmap.sel.cpu(), sel)


@pytest.mark.cuda
def test_exact_mode_labels_on_card_match_cpu(cuda_device):
    """The exact feature mode on the card: the greedy picking of each
    segmented TINY scan equals the CPU float32 picking of the same scan,
    and the whole front end's feature sets keep their counts."""
    from lins_tpu_torch.datasets.synthetic import generate_sequence
    from lins_tpu_torch.frontend import features as F
    from lins_tpu_torch.frontend.pipeline import process_cloud

    cfg = TINY.replace(feature_mode="exact")
    data = generate_sequence(cfg, n_scans=4, kind="gentle", speed=1.5,
                             device=cuda_device)
    for k in range(4):
        xyz = torch.as_tensor(np.asarray(data["scans_xyz"][k], np.float32))
        n = torch.tensor(int(data["scans_n"][k]), dtype=torch.int32)
        _, seg, feats = process_cloud(xyz.to(cuda_device),
                                      n.to(cuda_device), cfg)
        lab = F.extract_rings(seg, cfg)[0]
        seg_c = type(seg)(*(x.cpu() for x in seg))
        assert torch.equal(lab.cpu(), F.extract_rings(seg_c, cfg)[0])
        assert int((lab == 2).sum()) > 0 and int((lab == -1).sum()) > 0
        vox = F.voxel_downsample_ring(seg.xyz, seg.rel_time,
                                      F.extract_rings(seg, cfg)[1],
                                      cfg.surf_leaf_size)
        vox_c = F.voxel_downsample_ring(seg_c.xyz.double(),
                                        seg_c.rel_time.double(),
                                        F.extract_rings(seg_c, cfg)[1],
                                        cfg.surf_leaf_size)
        assert torch.equal(vox[2].cpu(), vox_c[2])
        np.testing.assert_allclose(vox[0].cpu().numpy(), vox_c[0].numpy(),
                                   rtol=0, atol=1e-5)
        assert int(feats.less_flat.valid.sum()) > 0


@pytest.mark.cuda
def test_optimize_cg_on_card_matches_cpu_float64(cuda_device):
    """The sparse solve in float32 on the card against float64 on the CPU
    on a drifted chain of 1200 slots with loop edges: within 1 mm."""
    from lins_tpu_torch.graph import pose_graph as pg

    rng = np.random.default_rng(0)
    K, n = 1200, 300
    gt = np.cumsum(rng.uniform(-1, 1, (n, 3)), axis=0)
    pos = np.zeros((K, 3))
    pos[:n] = gt + rng.normal(0, 0.02, (n, 3)).cumsum(axis=0)
    quat = np.zeros((K, 4))
    quat[:, 0] = 1.0
    pairs = [(k, k + 1) for k in range(n - 1)] + [(0, n - 1), (10, 200)]
    e = pg.empty_edges(len(pairs) + 8, torch.float64)
    one = torch.tensor([1.0, 0, 0, 0], dtype=torch.float64)
    for i, j in pairs:
        e = pg.add_edge(e, torch.tensor(i), torch.tensor(j),
                        torch.tensor(gt[j] - gt[i]), one, 1e4, 1e4)
    want = pg.optimize_cg(torch.tensor(pos), torch.tensor(quat),
                          torch.tensor(n), e, huber_delta=0.5)
    ef = pg.EdgeSet(*(x.to(cuda_device, torch.float32)
                      if x.is_floating_point() else x.to(cuda_device)
                      for x in e))
    got = pg.optimize_cg(torch.tensor(pos, dtype=torch.float32,
                                      device=cuda_device),
                         torch.tensor(quat, dtype=torch.float32,
                                      device=cuda_device),
                         torch.tensor(n, device=cuda_device), ef,
                         huber_delta=0.5)
    assert np.abs(want[0].numpy() - pos).max() > 0.01
    np.testing.assert_allclose(got[0].cpu().double().numpy(),
                               want[0].numpy(), rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_sharded_store_on_card_matches_unsharded(cuda_device):
    """A 64-slot store filled past the ring's wrap (70 keyframes), split
    over 4 parts of the one card: the window assembly, the window rebuild,
    the loop attempt's clouds and a write into each shard equal the
    unsharded ones on the card bit for bit, for windows across each seam
    and the wrap."""
    from lins_tpu_torch.graph import loop_closure as lc
    from lins_tpu_torch.mapping import keyframes as kf
    from lins_tpu_torch.mapping import local_map as lmn
    from lins_tpu_torch.parallel.multihost import Mesh
    from lins_tpu_torch.parallel.shard_map_store import shard_store

    def dev(x):
        return torch.as_tensor(x, device=cuda_device)

    K, count, W, caps = 64, 70, 8, (32, 64, 16)
    cfg = TINY.replace(max_keyframes=K, history_keyframe_search_num=5,
                       loop_time_gate=1.0)
    rng = np.random.default_rng(0)
    slots = np.arange(K)
    ids = slots + K * ((count - 1 - slots) // K)
    q = rng.normal(size=(K, 4))
    store = kf.empty_store(cfg, *caps, device=cuda_device)._replace(
        pos=dev(rng.uniform(-20, 20, (K, 3)).astype(np.float32)),
        quat=dev((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
            np.float32)),
        time=dev((0.1 * ids).astype(np.float32)),
        kf_id=dev(ids.astype(np.int32)),
        count=dev(np.int32(count)),
        **{f: dev(rng.uniform(-10, 10, (K, c, 3)).astype(np.float32))
           for f, c in zip(("corner", "surf", "outlier"), caps)},
        **{f + "_valid": dev(rng.random((K, c)) < 0.9)
           for f, c in zip(("corner", "surf", "outlier"), caps)})
    sharded = shard_store(store, Mesh([torch.device("cuda", 0)] * 4))
    gp = lmn.grid_params(cfg)
    lm = lmn.empty_local_map(cfg, W, *caps, torch.float32, gp, cuda_device)
    t_cur = dev(np.float32(100.0))

    def equal(a, b):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    for center in (18, 35, 50, 66, 69):
        c = dev(np.int32(center))
        win = dev(np.arange(center - W + 1, center + 1, dtype=np.int32))
        ok, wslots = win >= count - K, torch.remainder(win, W).int()
        equal(kf.assemble_local_map(sharded, c, W, 1024, 2048, 0.2, 0.4,
                                    True),
              kf.assemble_local_map(store, c, W, 1024, 2048, 0.2, 0.4, True))
        got = lmn.rebuild_window(lm, sharded, win, ok, wslots, gp)
        want = lmn.rebuild_window(lm, store, win, ok, wslots, gp)
        equal(got.dc, want.dc)
        equal(got.dsf, want.dsf)
        assert torch.equal(got.surf_vm.cells, want.surf_vm.cells)
        equal(lc.loop_clouds(sharded, c - 3, c, t_cur, cfg, 1024, 512),
              lc.loop_clouds(store, c - 3, c, t_cur, cfg, 1024, 512))
    for slot in (0, 15, 16, 40, 63):
        i = dev(np.int64(slot))
        row = dev(rng.normal(size=(caps[1], 3)).astype(np.float32))
        assert torch.equal(kf.put_row(sharded.surf, i, row).gather(),
                           kf.put_row(store.surf, i, row))
