"""Port parity for the blocked labelling of tall grids (kernel K2,
`label_components_blocked` of the reference package): the plain PyTorch
version the CPU runs (ops/label.label_blocked_plain) against the reference's
K2 in interpret mode and its exact union-find `label_from_edges`, labels
equal; the port's routing between K1 and K2; and 64-row odometry scans,
which route through K2, against the reference in float64.  The CUDA kernel
itself is held to the plain version on the card (tests/test_torch_card.py
and chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import SlamConfig as JConfig
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.frontend import projection as jP
from lins_tpu.frontend import segmentation as jS
from lins_tpu.odometry import LinsOdometry as JOdometry
from lins_tpu.ops.pallas_label import label_components_blocked
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.odometry import LinsOdometry as TOdometry
from lins_tpu_torch.ops import label as tlabel

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

# the 64-row raycast geometry of tests/test_pallas_label.py
SCAN_CFG = JConfig(line_num=64, scan_num=225, ang_res_x=1.6,
                   ang_res_y=26.9 / 63, ang_bottom=24.9, ground_scan_ind=50,
                   max_points=14400)


def _t(*arrs):
    return [torch.as_tensor(np.asarray(a)) for a in arrs]


def _blocked_plain(er, ed, el):
    return tlabel.label_blocked_plain(*_t(er, ed, el)).numpy()


def _random_edges(L, S, seed, p=0.55):
    """The random graphs of tests/test_pallas_label.py::TestBlockedLabel:
    edges only between eligible cells."""
    rng = np.random.default_rng(seed)
    el = rng.random((L, S)) < 0.7
    er = (rng.random((L, S)) < p) & el & np.roll(el, -1, axis=1)
    ed = rng.random((L, S)) < p
    ed &= el & np.concatenate([el[1:], np.zeros((1, S), bool)])
    return er, ed, el


def _from_edges(er, ed, el):
    return np.asarray(jS.label_from_edges(*(jnp.asarray(a)
                                            for a in (er, ed, el))))


def test_raycast_scan_matches_reference_kernel():
    """One 64x225 raycast scan: the reference's K2 (its production n_alt)
    and the port's plain K2 give the same labels."""
    data = jsyn.generate_sequence(SCAN_CFG, n_scans=1, kind="straight",
                                  speed=1.5)
    xyz = jnp.asarray(data["scans_xyz"][0])
    n = jnp.asarray(data["scans_n"][0])
    xyz_img, rng_img, valid, _, _ = jax.jit(
        lambda a, b: jP.project(a, b, SCAN_CFG))(xyz, n)
    ground = jax.jit(lambda a, b: jP.ground_removal(a, b, SCAN_CFG))(
        xyz_img, valid)
    el = valid & ~ground
    er, ed = jS.edge_masks(rng_img, el, SCAN_CFG)
    want = np.asarray(label_components_blocked(er, ed, el, interpret=True))
    got = _blocked_plain(er, ed, el)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _from_edges(er, ed, el))
    # components cross the row seams of the 16-row blocks
    rows = np.arange(15, 63, 16)
    np.testing.assert_array_equal(got[rows][np.asarray(ed)[rows]],
                                  got[rows + 1][np.asarray(ed)[rows]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_graphs_match_reference(seed):
    """Adversarial random 64x200 graphs: the reference's K2 reaches the
    fixpoint at n_alt=12; the port's plain K2 is exact by construction."""
    er, ed, el = _random_edges(64, 200, seed)
    got = _blocked_plain(er, ed, el)
    np.testing.assert_array_equal(got, np.asarray(label_components_blocked(
        *(jnp.asarray(a) for a in (er, ed, el)), n_alt=12, interpret=True)))
    np.testing.assert_array_equal(got, _from_edges(er, ed, el))


def test_tall_component_crossing_every_seam():
    L, S = 64, 64
    el = np.zeros((L, S), bool)
    el[:, 5] = True
    ed = np.zeros((L, S), bool)
    ed[:-1, 5] = True
    er = np.zeros((L, S), bool)
    lab = _blocked_plain(er, ed, el)
    assert (lab[:, 5] == 5).all()
    assert (lab[~el] == tlabel.BIG).all()


def test_component_wraps_the_column_seam_and_crosses_a_row_seam():
    """A ring segment across the column seam in row 15 joined down to row
    16 (across the first block seam) at the far end."""
    L, S = 32, 48
    el, er, ed = (np.zeros((L, S), bool) for _ in range(3))
    el[15, :4] = el[15, -4:] = True
    er[15, -4:] = True                 # S-4 .. S-1 -> 0, wrapping
    er[15, :3] = True
    el[16, S - 4] = True
    ed[15, S - 4] = True
    lab = _blocked_plain(er, ed, el)
    assert (lab[el] == 15 * S).all()
    np.testing.assert_array_equal(lab, _from_edges(er, ed, el))


def test_batch_labels_each_scan_alone():
    graphs = [_random_edges(32, 96, 10 + s) for s in range(3)]
    er, ed, el = (np.stack([g[i] for g in graphs]) for i in range(3))
    got = _blocked_plain(er, ed, el)
    assert got.shape == (3, 32, 96)
    for k, g in enumerate(graphs):
        np.testing.assert_array_equal(got[k], _from_edges(*g))


@pytest.mark.parametrize("shape,kernel", [((16, 1800), "K1"),
                                          ((64, 1800), "K2"),
                                          ((64, 1024), "K2"),
                                          ((64, 225), "K1"),
                                          ((8, 450), "K1")])
def test_route(shape, kernel):
    assert tlabel.route(*shape) == kernel


def test_route_refuses_tall_grids_not_in_16_row_blocks():
    with pytest.raises(ValueError, match="16-row"):
        tlabel.route(72, 1800)
    er, ed, el = (torch.zeros((72, 1800), dtype=torch.bool)
                  for _ in range(3))
    with pytest.raises(ValueError, match="16-row"):
        tlabel.label_components(er, ed, el)


def test_entry_point_takes_k2_for_tall_grids():
    """`label_components` on a 64x800 grid (too large for one block) runs
    K2's plain version on the CPU, and equals the exact labelling."""
    er, ed, el = _random_edges(64, 800, 5)
    assert tlabel.route(64, 800) == "K2"
    before = tlabel.label_blocked_plain.calls
    got = tlabel.label_components(*_t(er, ed, el)).numpy()
    assert tlabel.label_blocked_plain.calls == before + 1
    np.testing.assert_array_equal(got, _from_edges(er, ed, el))


# --- 64-row odometry through K2 -------------------------------------------
# 64 rings of 800 columns: 256,000 B of labels and flags, over one block's
# shared memory, so the port labels every scan and chunk with K2
ODO_CFG = JConfig(line_num=64, scan_num=800, ang_res_x=0.45,
                  ang_res_y=26.9 / 63, ang_bottom=24.9, ground_scan_ind=50,
                  max_points=51200)
N_SCANS = 6


def _drive(odo, data):
    """2 bootstrap scans and 2 streamed scans through add_scan, then the
    last 2 as one chunk."""
    imu_i = 0
    for k in range(N_SCANS):
        t_scan = data["scan_times"][k] + ODO_CFG.scan_period
        while (imu_i < len(data["imu_times"])
               and data["imu_times"][imu_i] <= t_scan + 1e-9):
            odo.add_imu(data["imu_times"][imu_i], data["imu_acc"][imu_i],
                        data["imu_gyr"][imu_i])
            imu_i += 1
        if k < 4:
            odo.add_scan(t_scan, data["scans_xyz"][k], data["scans_n"][k])
    ks = range(4, N_SCANS)
    odo.add_scan_chunk(
        np.asarray([data["scan_times"][k] + ODO_CFG.scan_period for k in ks]),
        np.stack([data["scans_xyz"][k] for k in ks]),
        np.asarray([data["scans_n"][k] for k in ks]))
    return odo


@pytest.fixture(scope="module")
def odometry_runs():
    data = jsyn.generate_sequence(ODO_CFG, n_scans=N_SCANS, kind="gentle",
                                  speed=1.5)
    jodo = _drive(JOdometry(ODO_CFG.replace(use_pallas=False),
                            dtype=jnp.float64), data)
    before = tlabel.label_blocked_plain.calls
    tcfg = SlamConfig.from_dict(ODO_CFG.replace(use_pallas=True).to_dict())
    todo = _drive(TOdometry(tcfg, dtype=torch.float64, device="cpu"), data)
    return jodo, todo, tlabel.label_blocked_plain.calls - before


def test_odometry_64_rows_matches_reference(odometry_runs):
    """Front end, features, association and filter at 64 rows, the labels
    from K2: positions within 1e-6 m of the reference."""
    jodo, todo, k2_calls = odometry_runs
    # the two RUNNING streamed scans and the chunk (once)
    assert k2_calls >= 3
    jt, jp, jq = jodo.trajectory_arrays()
    tt, tp, tq = todo.trajectory_arrays()
    assert len(tp) == N_SCANS - 1
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-7)
    assert np.linalg.norm(tp[-1] - tp[0]) > 0.3        # it moved


@pytest.mark.parametrize("key", ["iters", "n_surf", "n_corner", "diverged"])
def test_odometry_64_rows_metrics(odometry_runs, key):
    jodo, todo, _ = odometry_runs
    want = [int(np.asarray(m[key])) for m in jodo.metrics]
    got = [int(m[key]) for m in todo.metrics]
    assert got == want
    if key in ("n_surf", "n_corner"):
        assert min(got) > 20


def test_route_refuses_grids_over_one_cluster():
    """K2 joins a scan's 16-row blocks inside one thread-block cluster of
    at most 8 blocks: 128 rows go to K2, taller grids are refused, and a
    64-row scan runs in 8 blocks of 8 rows."""
    assert tlabel.route(128, 1800) == "K2"
    assert tlabel.piece_rows(64) == 8 and tlabel.piece_rows(128) == 16
    with pytest.raises(ValueError, match="at most 8 16-row blocks"):
        tlabel.route(144, 1800)
