"""Port parity: the connected-components labelling of lins_tpu_torch
(ops/label.py, the plain PyTorch version the CPU runs) against the reference
package's exact union-find `label_from_edges` and its Pallas kernel K1
`label_components_pallas` (interpret mode), exactly, on the cases of
tests/test_pallas_label.py.  The CUDA kernel itself is checked against the
plain version on the card (tests/test_torch_card.py and chip_smoke.py)."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import VLP16
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.frontend import projection as jP
from lins_tpu.frontend import segmentation as jS
from lins_tpu.ops.pallas_label import label_components_pallas
from lins_tpu_torch.ops import build
from lins_tpu_torch.ops import label as tlabel

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

CFG = VLP16.replace(max_points=28800)


def _port(er, ed, el):
    return tlabel.label_components(*(torch.as_tensor(np.asarray(a))
                                     for a in (er, ed, el))).numpy()


def _reference(er, ed, el):
    return np.asarray(jS.label_from_edges(jnp.asarray(er), jnp.asarray(ed),
                                          jnp.asarray(el)))


def _random_edges(L, S, seed, p_el=0.5, p_edge=0.5):
    """Production-consistent random graphs: edges only between eligible
    cells (tests/test_pallas_label.py)."""
    rng = np.random.default_rng(seed)
    el = rng.random((L, S)) < p_el
    er = (rng.random((L, S)) < p_edge) & el & np.roll(el, -1, axis=1)
    ed = (rng.random((L, S)) < p_edge) & el
    ed[:-1] &= el[1:]
    ed[-1] = False
    return er, ed, el


def _wrap_seam():
    L, S = 4, 64
    el = np.zeros((L, S), bool)
    el[1, :10] = el[1, -10:] = True
    er = np.zeros((L, S), bool)
    for j in list(range(0, 9)) + list(range(S - 10, S - 1)) + [S - 1]:
        er[1, j] = True
    return er, np.zeros((L, S), bool), el


def _vertical_chain():
    L, S = 8, 32
    el = np.zeros((L, S), bool)
    el[:, 5] = True
    ed = np.zeros((L, S), bool)
    ed[:-1, 5] = True
    return np.zeros((L, S), bool), ed, el


def _zigzag():
    L, S = 6, 16
    el, er, ed = (np.zeros((L, S), bool) for _ in range(3))
    for r in range(L):
        el[r, 2:14] = True
        er[r, 2:13] = True
        if r + 1 < L:
            ed[r, 13 if r % 2 == 0 else 2] = True
    return er, ed, el


def _piece_seams():
    """Components that cross the row seams of the card kernel's pieces
    (8 blocks of 2 rows a 16-row scan) many times: a snake of 5 vertical
    runs through all 16 rows, joined alternately in the last and the first
    row; a comb of 20 teeth joined only in the last row; runs that wrap from
    column S-1 to 0 on rows 3 and 4, joined down across a seam."""
    L, S = 16, 1800
    el, er, ed = (np.zeros((L, S), bool) for _ in range(3))
    for k in range(5):
        c = 8 + 4 * k
        el[:, c] = True
        ed[:-1, c] = True
        if k < 4:
            row = L - 1 if k % 2 == 0 else 0
            el[row, c:c + 5] = True
            er[row, c:c + 4] = True
    el[:, 100:160:3] = True
    ed[:-1, 100:160:3] = True
    el[L - 1, 100:158] = True
    er[L - 1, 100:157] = True
    for r in (3, 4):
        el[r, :2] = el[r, -3:] = True
        er[r, :1] = er[r, -3:] = True
    ed[3, S - 2] = True
    return er, ed, el


# (case, n_alt of the reference Pallas kernel that reaches the fixpoint)
CASES = {
    "wrap_seam": (_wrap_seam, 3),
    "vertical_chain": (_vertical_chain, 3),
    "zigzag": (_zigzag, 6),
    "random_16x256": (lambda: _random_edges(16, 256, 0), 5),
    "random_16x1800": (lambda: _random_edges(16, 1800, 1), 8),
    "random_64x360": (lambda: _random_edges(64, 360, 2), 8),
    "random_dense_64x200": (lambda: _random_edges(64, 200, 3, 0.7, 0.55), 12),
    "piece_seams_16x1800": (_piece_seams, 5),
}


@pytest.fixture(scope="module")
def scan_edges():
    """Edges of one raycast VLP-16 scan, from the reference front end."""
    data = jsyn.generate_sequence(CFG, n_scans=1, kind="straight", speed=1.5)
    xyz = jnp.asarray(data["scans_xyz"][0])
    n = jnp.asarray(data["scans_n"][0])
    xyz_img, rng_img, valid, _, _ = jax.jit(
        lambda a, b: jP.project(a, b, CFG))(xyz, n)
    ground = jax.jit(lambda a, b: jP.ground_removal(a, b, CFG))(xyz_img,
                                                                valid)
    eligible = valid & ~ground
    e_right, e_down = jS.edge_masks(rng_img, eligible, CFG)
    return tuple(np.asarray(a) for a in (e_right, e_down, eligible))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_label_from_edges(case):
    er, ed, el = CASES[case][0]()
    got = _port(er, ed, el)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _reference(er, ed, el))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case):
    """Equal to K1 in interpret mode wherever K1 reaches the fixpoint (its
    n_alt closure depth covers the case)."""
    make, n_alt = CASES[case]
    er, ed, el = make()
    want = np.asarray(label_components_pallas(
        jnp.asarray(er), jnp.asarray(ed), jnp.asarray(el), n_alt=n_alt,
        interpret=True))
    np.testing.assert_array_equal(want, _reference(er, ed, el))
    np.testing.assert_array_equal(_port(er, ed, el), want)


def test_raycast_scan_matches_both(scan_edges):
    er, ed, el = scan_edges
    got = _port(er, ed, el)
    np.testing.assert_array_equal(got, _reference(er, ed, el))
    np.testing.assert_array_equal(got, np.asarray(label_components_pallas(
        *(jnp.asarray(a) for a in scan_edges), n_alt=5, interpret=True)))


def test_batched_chunk_matches_per_scan():
    """A (K, L, S) chunk (one kernel launch on the card) labels each scan
    as it would alone."""
    graphs = [_random_edges(16, 300, seed) for seed in range(4)]
    er, ed, el = (np.stack([g[i] for g in graphs]) for i in range(3))
    got = _port(er, ed, el)
    assert got.shape == (4, 16, 300)
    for k, g in enumerate(graphs):
        np.testing.assert_array_equal(got[k], _reference(*g))


def test_representatives_are_least_members():
    er, ed, el = _random_edges(16, 400, 7, 0.7, 0.6)
    lab = _port(er, ed, el)
    ids = np.arange(lab.size).reshape(lab.shape)
    assert (lab[~el] == tlabel.BIG).all()
    for rep in np.unique(lab[el]):
        assert rep == ids[el & (lab == rep)].min()


def test_wrapper_rejects_other_devices():
    """Only CPU tensors take the plain version; any other device goes to
    the kernel path, which refuses what is not on the card."""
    er, ed, el = (torch.zeros((2, 16, 32), dtype=torch.bool, device="meta")
                  for _ in range(3))
    with pytest.raises(ValueError, match="device"):
        tlabel.label_components(er, ed, el)


def test_build_needs_nvcc():
    """Without the CUDA toolkit the kernel cannot be built, and loading it
    raises instead of falling back."""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build is checked on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("label_components")
