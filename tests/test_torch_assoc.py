"""Port parity of the fused association kernels K4 and K5 (`ops/assoc.py`)
on the CPU, through their plain versions:
  (a) float64 against the reference package's production route,
      `find_*_matches` + `_measurement_blocks` (and `_blocks_xla` for a
      whole trip), at iterations 0 and 3: counts equal, JtJ, Jtr and Σr²
      within 1e-9 of their scales;
  (b) float32 against the attic's TPU kernels in interpret mode, on random
      inputs without ties (the attic's query count padded with invalid rows
      to its 128-row tile): counts equal, blocks within 1e-5 of their
      scales;
  (c) built ties, on two rings and on one: the port equals `_blocks_xla`
      and differs from the attic, as the module docstring says;
  (d) the GN rows against `lins_tpu/odometry/gn_icp.py::gn_step`'s;
  (e) edge cases: no valid query, no valid reference, every query beyond
      max_d2, NaN coordinates in padded rows;
  (f) the card's reference layout (`ring_layout`) as a plain function, and
      a PyTorch emulation of the kernel's windowed search over it, which
      must pick `_tripod`'s neighbours (random, exact-tie and NaN-padded
      cases at 16 and 64 rings).
An entry's scale: entry (a, b) of the Gram G of the rows [J6 | r] (JtJ,
Jtr, Σr²) has the scale sqrt(G_aa·G_bb) of the expected diagonal, by
Cauchy-Schwarz a bound of its sum of |terms|."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lins_tpu.config import TINY
from lins_tpu.datasets import synthetic as jsyn
from lins_tpu.frontend import make_frontend
from lins_tpu.frontend.types import FeatureCloud as JCloud
from lins_tpu.odometry import association as jassoc
from lins_tpu.odometry import gn_icp as jgn
from lins_tpu.odometry import ieskf as jieskf
from lins_tpu_torch.config import SlamConfig
from lins_tpu_torch.odometry import gn_icp as tgn
from lins_tpu_torch.ops import assoc

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JCFG = TINY
TCFG = SlamConfig.from_dict(JCFG.to_dict())
KEYS = ("q_xyz", "q_rel", "q_valid", "r_xyz", "r_ring", "r_valid", "rn",
        "qbn")
TILE = 128


@pytest.fixture(scope="module")
def attic():
    """attic/pallas_assoc.py, loaded from its file (it is no package)."""
    spec = importlib.util.spec_from_file_location(
        "attic_pallas_assoc", ROOT / "attic" / "pallas_assoc.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quat(rng, scale):
    q = np.concatenate([[1.0], rng.normal(0, scale, 3)])
    return q / np.linalg.norm(q)


# (Q, R) of the random cases: one shape per kind keeps the reference's
# eager op compiles and the attic's interpret-mode traces few
SHAPES = {"surf": (100, 256), "corner": (150, 512)}


def _random_case(seed, kind, rings=16):
    """Query points in a 30 m box, references scattered about them on
    random rings; some rows invalid; a small pose."""
    Q, R = SHAPES[kind]
    rng = np.random.default_rng(seed)
    q = rng.uniform(-15, 15, (Q, 3)) * np.asarray([1.0, 1.0, 0.2])
    return dict(q_xyz=q, q_rel=rng.uniform(0, 1, Q),
                q_valid=rng.random(Q) < 0.85,
                r_xyz=q[rng.integers(0, Q, R)] + rng.normal(0, 0.6, (R, 3)),
                r_ring=rng.integers(0, rings, R).astype(np.int32),
                r_valid=rng.random(R) < 0.9,
                rn=rng.normal(0, 0.1, 3), qbn=_quat(rng, 0.01))


@pytest.fixture(scope="module")
def tiny_pair():
    """Scans 3 and 4 of a straight TINY sequence through the reference
    front end, scan 3's reference sets re-anchored by the true motion, at a
    perturbed pose (tests/test_torch_odometry.py does the same at VLP-16
    size)."""
    seq = jsyn.generate_sequence(JCFG, n_scans=5, kind="straight", speed=1.5)
    fe = make_frontend(JCFG)
    fA = fe(jnp.asarray(seq["scans_xyz"][3]), jnp.asarray(seq["scans_n"][3]))[2]
    fB = fe(jnp.asarray(seq["scans_xyz"][4]), jnp.asarray(seq["scans_n"][4]))[2]
    true_rn = np.asarray([0.15, 0.0, 0.0])
    true_q = np.asarray([1.0, 0.0, 0.0, 0.0])

    def ref_set(fc):
        return dict(xyz=np.asarray(jassoc.transform_to_end(
            fc.xyz.astype(jnp.float64), fc.rel_time.astype(jnp.float64),
            jnp.asarray(true_rn), jnp.asarray(true_q))),
            ring=np.asarray(fc.ring), valid=np.asarray(fc.valid))

    def cloud(fc):
        return {k: np.asarray(getattr(fc, k)) for k in JCloud._fields}

    return dict(flat=cloud(fB.flat), sharp=cloud(fB.sharp),
                surf=ref_set(fA.less_flat), corner=ref_set(fA.less_sharp),
                rn=true_rn + np.asarray([0.02, -0.01, 0.005]),
                qbn=np.asarray([0.99995, 0.002, -0.003, 0.009])
                / np.linalg.norm([0.99995, 0.002, -0.003, 0.009]))


def _pair_case(pair, kind):
    q = pair["flat" if kind == "surf" else "sharp"]
    r = pair[kind]
    return dict(q_xyz=q["xyz"].astype(np.float64),
                q_rel=q["rel_time"].astype(np.float64), q_valid=q["valid"],
                r_xyz=r["xyz"], r_ring=r["ring"], r_valid=r["valid"],
                rn=pair["rn"], qbn=pair["qbn"])


def _cast(case, dtype):
    """The case with its float arrays in `dtype`."""
    return {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in case.items()}


def _port(kind, case, it, cfg=TCFG, form="ieskf"):
    fn = getattr(assoc, f"{kind}_normal_equations_plain")
    out = fn(*(torch.as_tensor(np.array(case[k])) for k in KEYS), it,
             max_d2=cfg.nearest_feature_search_sq_dist,
             icp_freq=cfg.icp_freq, form=form, lidar_scale=cfg.lidar_scale)
    return tuple(np.asarray(x) for x in out)


def _reference(kind, case, it, cfg=JCFG):
    """The reference package's production route for one set: its matches
    and `_measurement_blocks` (Σr² = res_norm²)."""
    args = [jnp.asarray(case[k]) for k in KEYS]
    m = getattr(jassoc, f"find_{kind}_matches")(*args, it, cfg)
    JtJ, Jtr, res_norm = jieskf._measurement_blocks(m, args[6], args[7],
                                                    cfg, jnp.float64)
    return (np.asarray(JtJ), np.asarray(Jtr), float(res_norm) ** 2,
            int(jnp.sum(m.valid)))


def _attic_run(mod, kind, case, it):
    """The attic kernel in interpret mode, float32, its queries padded with
    invalid rows to a multiple of its tile."""
    Q = len(case["q_valid"])
    pad = -(-Q // TILE) * TILE - Q
    c = _cast(case, np.float32)
    q_xyz = np.concatenate([c["q_xyz"], np.zeros((pad, 3), np.float32)])
    q_rel = np.concatenate([c["q_rel"], np.zeros(pad, np.float32)])
    q_valid = np.concatenate([c["q_valid"], np.zeros(pad, bool)])
    fn = getattr(mod, f"{kind}_normal_equations")
    out = fn(q_xyz, q_rel, q_valid, c["r_xyz"], c["r_ring"], c["r_valid"],
             c["rn"], c["qbn"], it, max_d2=JCFG.nearest_feature_search_sq_dist,
             interpret=True, tile_q=TILE, icp_freq=JCFG.icp_freq)
    return tuple(np.asarray(x) for x in out)


def _gram(blocks):
    """The (7, 7) float64 Gram of [J6 | r] from (JtJ, Jtr, Σr², n)."""
    G = np.zeros((7, 7))
    G[:6, :6] = np.asarray(blocks[0], np.float64)
    G[:6, 6] = G[6, :6] = np.asarray(blocks[1], np.float64)
    G[6, 6] = float(blocks[2])
    return G


def _assert_blocks(got, want, rtol, what=""):
    assert int(got[3]) == int(want[3]), f"{what}: counts {got[3]} vs {want[3]}"
    g, w = _gram(got), _gram(want)
    d = np.maximum(np.diag(w), 0.0)
    tol = rtol * np.sqrt(d[:, None] * d[None, :])
    err = np.abs(g - w)
    bad = ~(err <= tol)
    assert not bad.any(), (f"{what}: entries {np.argwhere(bad).tolist()} of "
                           f"the Gram off by {err[bad]} > {tol[bad]}")


# (a) ----------------------------------------------------------------------

@pytest.mark.parametrize("it", [0, 3])
@pytest.mark.parametrize("kind", ["surf", "corner"])
@pytest.mark.parametrize("source", ["random", "random_scaled", "tiny_pair"])
def test_plain_matches_reference_route(tiny_pair, source, kind, it):
    jcfg = JCFG.replace(lidar_scale=1.7) if source == "random_scaled" else JCFG
    tcfg = SlamConfig.from_dict(jcfg.to_dict())
    if source == "tiny_pair":
        case = _pair_case(tiny_pair, kind)
    else:
        case = _random_case(1, kind)
    want = _reference(kind, case, it, jcfg)
    got = _port(kind, case, it, tcfg)
    assert want[3] > 10
    _assert_blocks(got, want, 1e-9, f"{source} {kind} it={it}")


@pytest.mark.parametrize("it", [0, 3])
def test_trip_matches_blocks_xla(tiny_pair, it):
    """One trip of the odometry's entry, both sets, against the reference
    package's `_blocks_xla`: JtJ and Jtr summed, res_norm, both counts."""
    p = tiny_pair
    lin_rn, lin_qbn = p["rn"], p["qbn"]

    class Lin:
        rn, qbn = jnp.asarray(lin_rn), jnp.asarray(lin_qbn)

    JtJ, Jtr, res_norm, ns, nc = jieskf._blocks_xla(
        JCloud(**{k: jnp.asarray(v) for k, v in p["flat"].items()}),
        JCloud(**{k: jnp.asarray(v) for k, v in p["sharp"].items()}),
        {k: jnp.asarray(v) for k, v in p["surf"].items()},
        {k: jnp.asarray(v) for k, v in p["corner"].items()}, Lin, it, JCFG,
        jnp.float64)
    f64 = torch.float64

    def qset(d):
        return assoc.Queries(torch.as_tensor(np.array(d["xyz"])).to(f64),
                             torch.as_tensor(np.array(d["rel_time"])).to(f64),
                             torch.as_tensor(np.array(d["valid"])))

    refs = assoc.reference_sets(
        {k: torch.as_tensor(np.array(v)) for k, v in p["surf"].items()},
        {k: torch.as_tensor(np.array(v)) for k, v in p["corner"].items()},
        f64)
    s, c = assoc.scan_normal_equations(
        qset(p["flat"]), qset(p["sharp"]), *refs, torch.as_tensor(lin_rn),
        torch.as_tensor(lin_qbn), it, TCFG, "ieskf")
    assert (int(s[3]), int(c[3])) == (int(ns), int(nc))
    got = ((s[0] + c[0]).numpy(), (s[1] + c[1]).numpy(),
           float(s[2] + c[2]), int(s[3]))
    want = (np.asarray(JtJ), np.asarray(Jtr), float(res_norm) ** 2, int(ns))
    _assert_blocks(got, want, 1e-9, f"trip it={it}")
    np.testing.assert_allclose(np.sqrt(got[2]), float(res_norm), rtol=1e-12)


# (b) ----------------------------------------------------------------------

@pytest.mark.parametrize("it", [0, 2])
@pytest.mark.parametrize("kind", ["surf", "corner"])
def test_plain_float32_matches_attic_kernel(attic, kind, it):
    case = _random_case(3, kind)
    want = _attic_run(attic, kind, case, it)
    got = _port(kind, _cast(case, np.float32), it)
    assert got[0].dtype == np.float32 and want[3] > 10
    _assert_blocks(got, want, 1e-5, f"{kind} it={it} vs the attic")


# (c) ----------------------------------------------------------------------

def _tie_case(refs):
    """One query at (10, 0, 0.5), no de-skew (rel 0, identity pose), and
    `refs` [(xyz, ring), ...] on a lattice, padded with invalid far
    references to 8: every distance is exact, so ties are exact."""
    xyz = [r[0] for r in refs] + [(1e3, 1e3, 1e3)] * (8 - len(refs))
    ring = [r[1] for r in refs] + [0] * (8 - len(refs))
    return dict(q_xyz=np.asarray([[10.0, 0.0, 0.5]]), q_rel=np.zeros(1),
                q_valid=np.ones(1, bool), r_xyz=np.asarray(xyz, float),
                r_ring=np.asarray(ring, np.int32),
                r_valid=np.arange(8) < len(refs), rn=np.zeros(3),
                qbn=np.asarray([1.0, 0.0, 0.0, 0.0]))


TIES = {
    # i1 ties between rings 3 and 5: the port takes the lower index (ring
    # 3), the attic averages the two onto ring 4, which has no reference
    "surf_two_rings": ("surf", [((10, 1, 0), 3), ((10, -1, 0), 5),
                                ((11, 1, 0), 3)]),
    # i1 ties on ring 3: the port's i2 is the other tied point, the attic
    # leaves out both and its plane degenerates to a line
    "surf_one_ring": ("surf", [((10, 1, 0), 3), ((10, -1, 0), 3),
                               ((12, 0, 0), 4), ((8, 0, 0), 3)]),
    # i1 ties between rings 3 and 5: the attic's P1 and P2 are both the
    # average, a line of length 0
    "corner_two_rings": ("corner", [((10, 1, 0), 3), ((10, -1, 0), 5)]),
}


@pytest.mark.parametrize("name", sorted(TIES))
def test_ties_follow_blocks_xla_not_the_attic(attic, name):
    kind, refs = TIES[name]
    case = _tie_case(refs)
    want = _reference(kind, case, 0)
    got = _port(kind, case, 0)
    assert want[3] == 1
    _assert_blocks(got, want, 1e-9, name)
    got32 = _port(kind, _cast(case, np.float32), 0)
    _assert_blocks(got32, want, 1e-6, f"{name}, float32")
    att = _attic_run(attic, kind, case, 0)
    assert int(att[3]) == 0, f"{name}: the attic kept {att[3]} rows"


# (d) ----------------------------------------------------------------------

@pytest.mark.parametrize("it", [0, 3])
def test_gn_rows_match_gn_step(tiny_pair, it):
    """The "gn" rows summed over both sets against the reference's gn_step
    rows (its J6ᵀJ6 and J6ᵀb, formed from its matches as gn_step forms
    them), and one GN step from each."""
    p = tiny_pair
    cases = [_pair_case(p, k) for k in ("surf", "corner")]
    ms = [getattr(jassoc, f"find_{k}_matches")(
        *(jnp.asarray(c[key]) for key in KEYS), it, JCFG)
        for k, c in zip(("surf", "corner"), cases)]
    m = jassoc.stack_matches(*ms)
    rel = jnp.concatenate([jnp.asarray(c["q_rel"]) for c in cases])
    rn, qbn = jnp.asarray(p["rn"]), jnp.asarray(p["qbn"])
    # gn_step's rows (lins_tpu/odometry/gn_icp.py:20-31)
    coeff = jnp.where(m.valid[:, None], m.coeff, 0.0)
    res = jnp.where(m.valid, m.resid, 0.0)
    from lins_tpu.geom import so3 as jso3
    R_s = jso3.quat_to_mat(jso3.exp_axis(rel[:, None]
                                         * jso3.log_quat(qbn)[None, :]))
    RS = -jnp.einsum("nij,njk->nik", R_s, jso3.skew(m.point))
    J6 = jnp.concatenate([jnp.einsum("ni,nij->nj", coeff, RS), coeff], -1)
    b = -0.05 * res
    want = (np.asarray(J6.T @ J6), np.asarray(J6.T @ b),
            float(jnp.sum(b * b)), int(jnp.sum(m.valid)))

    outs = [_port(k, c, it, form="gn") for k, c in zip(("surf", "corner"),
                                                       cases)]
    got = tuple(sum(o[i] for o in outs) for i in range(4))
    assert [int(o[3]) for o in outs] == [int(jnp.sum(x.valid)) for x in ms]
    _assert_blocks(got, want, 1e-9, f"gn it={it}")

    eye = np.eye(6)
    rn_j, q_j, conv_j, proj_j = jgn.gn_step(rn, qbn, m, rel, it,
                                            jnp.asarray(eye), JCFG,
                                            jnp.float64)
    rn_t, q_t, conv_t, proj_t = tgn.gn_step(
        torch.as_tensor(p["rn"]), torch.as_tensor(p["qbn"]),
        torch.as_tensor(got[0]), torch.as_tensor(got[1]), it,
        torch.as_tensor(eye))
    for g, w in ((rn_t, rn_j), (q_t, q_j), (proj_t, proj_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    assert bool(conv_t) == bool(conv_j)


# (e) ----------------------------------------------------------------------

def _edge(name, kind):
    case = _random_case(5, kind)
    if name == "no_valid_query":
        case["q_valid"][:] = False
    elif name == "no_valid_reference":
        case["r_valid"][:] = False
    elif name == "all_beyond_max_d2":
        case["q_xyz"] = case["q_xyz"] + np.asarray([100.0, 0.0, 0.0])
    return case


@pytest.mark.parametrize("kind", ["surf", "corner"])
@pytest.mark.parametrize("name", ["no_valid_query", "no_valid_reference",
                                  "all_beyond_max_d2"])
def test_empty_cases_give_zeros(kind, name):
    case = _edge(name, kind)
    for dtype in (np.float64, np.float32):
        got = _port(kind, _cast(case, dtype), 1)
        assert int(got[3]) == 0
        for x in got[:3]:
            assert np.all(np.asarray(x) == 0.0)
    want = _reference(kind, case, 1)
    assert want[3] == 0 and float(np.max(np.abs(want[0]))) == 0.0


@pytest.mark.parametrize("kind", ["surf", "corner"])
def test_nan_in_padded_rows(kind):
    """Invalid query and reference rows with NaN coordinates change
    nothing: the sums stay finite and equal those without the NaNs.  (The
    reference's `_measurement_blocks` multiplies a masked row's zero
    coefficients by its point, so its own blocks turn NaN here.)"""
    case = _edge("nan", kind)
    clean = _port(kind, case, 1)
    nan_case = {k: np.array(v) for k, v in case.items()}
    bad_q = np.flatnonzero(~case["q_valid"])[:5]
    bad_r = np.flatnonzero(~case["r_valid"])[:5]
    assert len(bad_q) and len(bad_r)
    nan_case["q_xyz"][bad_q] = np.nan
    nan_case["q_rel"][bad_q] = np.nan
    nan_case["r_xyz"][bad_r] = np.nan
    got = _port(kind, nan_case, 1)
    for g, w in zip(got, clean):
        assert np.all(np.isfinite(g))
        np.testing.assert_array_equal(g, w)
    _assert_blocks(got, _reference(kind, case, 1), 1e-9, "nan rows")
    assert not np.all(np.isfinite(_reference(kind, nan_case, 1)[0]))


def test_wrappers_take_the_plain_version_on_the_cpu():
    case = _random_case(7, "surf")
    args = [torch.as_tensor(np.array(case[k])) for k in KEYS]
    before = (assoc.surf_normal_equations_plain.calls,
              assoc.corner_normal_equations_plain.calls,
              assoc.surf_normal_equations.launches,
              assoc.corner_normal_equations.launches)
    s = assoc.surf_normal_equations(*args, 1)
    c = assoc.corner_normal_equations(*args, 1)
    after = (assoc.surf_normal_equations_plain.calls,
             assoc.corner_normal_equations_plain.calls,
             assoc.surf_normal_equations.launches,
             assoc.corner_normal_equations.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
    assert s[0].dtype == torch.float64 and c[3].dtype == torch.int32
    with pytest.raises(ValueError, match="unknown row form"):
        assoc.surf_normal_equations(*args, 1, form="pallas")


def test_launch_refuses_cpu_tensors():
    case = _random_case(8, "corner")
    args = [torch.as_tensor(np.array(case[k])) for k in KEYS]
    q = assoc.Queries(args[0].float(), args[1].float(), args[2])
    ref = assoc.references(args[3].float(), args[4], args[5])
    pose = assoc.pose_scalars(args[6].float(), args[7].float(), "ieskf")
    with pytest.raises(ValueError, match="unsupported device"):
        assoc.launch((q, ref), None, pose, "ieskf", True, 25.0, 1.0)


# (f) the card's reference layout ------------------------------------------

def _layout_case(seed, kind, rings, variant):
    """A float32 random case on `rings` rings: "random"; "lattice" (every
    coordinate on a 0.25 m lattice, no de-skew, so many distances tie
    exactly); "nan" (the invalid rows' coordinates NaN, and three valid
    references with a NaN or infinite coordinate)."""
    case = _random_case(seed, kind, rings)
    if variant == "lattice":
        for k in ("q_xyz", "r_xyz"):
            case[k] = np.round(case[k] * 4) / 4
        case["q_rel"] = 0 * case["q_rel"]
        case["qbn"] = np.asarray([1.0, 0.0, 0.0, 0.0])
    elif variant == "nan":
        case["q_xyz"][~case["q_valid"]] = np.nan
        case["r_xyz"][~case["r_valid"]] = np.nan
        good = np.flatnonzero(case["r_valid"])
        case["r_xyz"][good[0], 0] = np.nan
        case["r_xyz"][good[5], 2] = np.nan
        case["r_xyz"][good[9], 1] = np.inf
    return _cast(case, np.float32)


def _layout(case):
    return assoc.ring_layout(torch.as_tensor(case["r_xyz"]),
                             torch.as_tensor(case["r_ring"]),
                             torch.as_tensor(case["r_valid"]))


@pytest.mark.parametrize("rings", [16, 64])
@pytest.mark.parametrize("variant", ["random", "lattice", "nan"])
def test_ring_layout(variant, rings):
    """Every valid reference with finite coordinates appears once, under its
    original index, with its coordinates and ring; rings in order, each in
    ascending index; the offsets count the rows before each ring; invalid
    and non-finite rows are left out."""
    case = _layout_case(11, "surf", rings, variant)
    packed, offsets = _layout(case)
    xyz, ring, valid = case["r_xyz"], case["r_ring"], case["r_valid"]
    R = len(valid)
    assert packed.shape == (R, 4) and packed.dtype == torch.float32
    assert offsets.shape == (assoc._RINGS + 1,)
    assert offsets.dtype == torch.int32
    keep = valid & np.isfinite(xyz).all(axis=1)
    if variant == "nan":
        assert keep.sum() == valid.sum() - 3
    n = int(offsets[-1])
    assert n == int(keep.sum())
    word = packed[:n, 3].contiguous().view(torch.int32).numpy()
    idx, on = word >> 8, word & 255
    want = np.lexsort((np.arange(R), ring))      # ring order, stable
    want = want[keep[want]]
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(on, ring[want])
    np.testing.assert_array_equal(packed[:n, :3].numpy(), xyz[want])
    np.testing.assert_array_equal(
        offsets.numpy(), np.searchsorted(ring[want], np.arange(257)))


def _window_search(kind, p0, packed, offsets):
    """The kernel's two passes over the ring layout, in PyTorch: pass 1
    over the valid rows, pass 2 over the rows of rings ring[i1]-2 ..
    ring[i1]+2 found through the offsets, each minimum the least (d2,
    original index); a NaN distance is no candidate.  Returns (i1, d1)
    and the (i, d) of the same-ring (K4 only) and other-ring minima, as
    original indices, -1 and inf where there is none."""
    inf = torch.inf
    n = int(offsets[-1])
    rows = packed[:n]
    word = rows[:, 3].contiguous().view(torch.int32).long()
    idx, ring = word >> 8, word & 255
    pos = torch.arange(n)
    D = assoc.pairwise_d2(p0, rows[:, :3])
    cand = ~torch.isnan(D)

    def least(mask):
        Dm = torch.where(mask, D, inf)
        d = Dm.min(dim=1).values if n else torch.full((len(p0[0]),), inf)
        tie = mask & (Dm == d[:, None])
        i = torch.where(tie, idx[None, :], R_BIG).min(dim=1).values \
            if n else torch.full((len(p0[0]),), R_BIG)
        none = i == R_BIG
        return torch.where(none, -1, i), torch.where(none, inf, d)

    i1, d1 = least(cand)
    p1 = torch.where(i1[:, None] == idx[None, :], pos[None, :], -1).amax(1)
    r1 = ring[p1.clamp(min=0)]
    lo = offsets.long()[(r1 - 2).clamp(min=0)]
    hi = offsets.long()[(r1 + 3).clamp(max=assoc._RINGS)]
    window = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
    window &= cand & (i1 >= 0)[:, None]
    same = ring[None, :] == r1[:, None]
    far = least(window & ~same)
    if kind == "corner":
        return (i1, d1), far
    return (i1, d1), least(window & same & (pos[None, :] != p1[:, None])), far


R_BIG = 2 ** 40


@pytest.mark.parametrize("rings", [16, 64])
@pytest.mark.parametrize("variant", ["random", "lattice", "nan"])
@pytest.mark.parametrize("kind", ["surf", "corner"])
def test_windowed_search_picks_the_tripod(kind, variant, rings):
    """The kernel's search over the layout (emulated) picks the same i1,
    i2 (and i3) with the same distances as the plain version's full search
    (`_tripod`), exact ties included, wherever the plain version has a
    candidate, and none where it has none."""
    case = _layout_case(12, kind, rings, variant)
    t = {k: torch.as_tensor(np.array(v)) for k, v in case.items()}
    pose = assoc.pose_scalars(t["rn"], t["qbn"], "gn")
    p0, _ = assoc.deskew(t["q_xyz"], t["q_rel"], pose)
    ref = assoc.References(t["r_xyz"], t["r_ring"], t["r_valid"], None, None)
    want = assoc._tripod(kind, p0, ref)
    got = _window_search(kind, p0, *_layout(case))
    want_pairs = [want[:2]] + list(want[2:])
    assert len(got) == len(want_pairs)
    matched = torch.isfinite(want[1])
    assert int(matched.sum()) > 0
    for k, ((gi, gd), (wi, wd)) in enumerate(zip(got, want_pairs)):
        has = torch.isfinite(wd) & matched
        assert int(has.sum()) > 0 or k > 0
        assert torch.equal(gi[has], wi[has]), f"minimum {k}: indices differ"
        assert torch.equal(gd[has], wd[has]), f"minimum {k}: distances differ"
        assert bool(torch.isinf(gd[~has & matched]).all()), \
            f"minimum {k}: a candidate where the plain version has none"
    if variant == "lattice":
        # the ties were real: some query's tripod had two references at its
        # least distance
        D = assoc.pairwise_d2(p0, t["r_xyz"]).masked_fill(
            ~t["r_valid"][None, :], torch.inf)
        assert bool(((D == want[1][:, None]).sum(1) > 1)[matched].any())
