"""The port's span recorder (`utils/metrics.RECORDER`, `trace_scope`) and
the spans at the stage boundaries: ids, roots and scan indices on a TINY
replay and on streaming, the ring's bound, device attributes read only at
export, the `kept` flags, `reads` and the discarded time of the mapper's
branches and loops decided on the host against their computed-and-selected
form, the odometry's loops and fallback decided on the host against their
full-trip form, and the benchmark's seven readers of the spans on TINY
traced runs.  The `cuda` tests run a warm VLP-16 chunk on the card with the
recorder recording and count its host syncs by site, and hold a chunk to
its full-trip and selected forms bit for bit.  This file imports neither
JAX nor the reference package:

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""
import json
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from benchmark import harness
from benchmark.layer_metrics import _program
from benchmark.tests.tiny import run_tiny, tiny_cell
from lins_tpu_torch.config import TINY
from lins_tpu_torch.datasets import synthetic as syn
from lins_tpu_torch.frontend.pipeline import process_cloud
from lins_tpu_torch.graph import loop_closure
from lins_tpu_torch.imu import eskf
from lins_tpu_torch.mapping import scan2map
from lins_tpu_torch.odometry import estimator as est
from lins_tpu_torch.odometry import gn_icp, ieskf
from lins_tpu_torch.slam import LinsSlam, run_sequence
from lins_tpu_torch.utils import metrics, tree
from lins_tpu_torch.utils.tree import tree_map

# the port's CPU tests run many tiny ops: one intra-op thread each, so the
# test workers that share the cores do not oversubscribe them
torch.set_num_threads(1)

CHUNK = 4
N_SCANS = 16
F64 = torch.float64
# the spans the seven readers read, by reader
READS = {"odometry.frontend_ms_per_scan.replay": "odometry.frontend",
         "odometry.ieskf_ms_per_scan.replay": "odometry.ieskf",
         "mapper.ms_per_step.replay": "mapper.step",
         "loop.ms_per_attempt.replay": "loop.attempt",
         "loop.ms_per_attempt.live": "loop.attempt",
         "dispatch.discarded_ms_per_scan.replay": None,
         "dispatch.discarded_ms_per_scan.live": None}
# the loops, each stopped by the host's reads (every trip issued live), and
# their most trips
LOOPS = {"odometry.ieskf": TINY.num_iter, "odometry.gn_icp": TINY.num_iter,
         "mapper.scan_to_map": TINY.scan2map_iters,
         "loop.icp": TINY.loop_icp_iters}
# the spans of the mapper's and the loop closure's branches (`tree.cond`)
CONDS = ("mapper.radius_rebuild", "mapper.window_rebuild",
         "mapper.keyframe_add", "mapper.regather", "loop.align", "loop.solve")
# the host reads of a tensor, in `_Reads`' form
HOST_READS = {torch.Tensor.__bool__, torch.Tensor.item, torch.Tensor.tolist,
              torch.Tensor.__int__, torch.Tensor.__float__,
              torch.Tensor.__index__, torch.Tensor.numpy}


@pytest.fixture(scope="module")
def data():
    return syn.generate_sequence(TINY, n_scans=N_SCANS, kind="gentle",
                                 speed=1.5, device="cpu")


def _recorded(fn):
    """The spans `fn()` records in a fresh recorder."""
    rec = metrics.SpanRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "RECORDER", rec)
        fn()
    return rec.spans()


def _selected_form(mp):
    """The mapper's and the loop closure's branches computed and selected,
    their loops running all their trips with the carry frozen, as the card
    ran them before it decided them on the host."""
    mp.setattr(tree, "_decide", tree.select_cond)
    for mod in (scan2map, loop_closure):
        mp.setattr(mod, "may_stop", lambda active: False)


def _full_trips(mp):
    """The odometry as the card ran it before it decided on the host: the
    IESKF's and the GN's reads never stop their loops (every trip issued,
    the carry frozen on the device), and the fallback computed every scan
    and selected on the device."""
    mp.setattr(ieskf, "read_flags", lambda active, div: (True, bool(div)))
    mp.setattr(gn_icp, "read_active", lambda active: True)

    def selected(res, fallback):
        with metrics.trace_scope("odometry.fallback", kept=res.diverged):
            return tree.select_cond(res.diverged, fallback, res.state)

    mp.setattr(est, "fallback_or_keep", selected)


def _loop_reads(name, trips):
    """The host reads of a loop that issued `trips`: one before each trip
    after the first (the loop ICP's only once its gate is the finest), one
    more that stopped it before its last, and the IESKF's one after a last
    trip that did not stop it (it brings `diverged` for the fallback)."""
    if name == "odometry.ieskf":
        return trips
    if name == "loop.icp":
        n = TINY.loop_icp_iters
        decay = (1.0 / TINY.loop_icp_max_corr) ** (
            1.0 / max(n - 1 - min(6, n // 2), 1))
        gated = sum(TINY.loop_icp_max_corr * decay ** i > 1.001
                    for i in range(n))
        return max(trips - 1 - gated, 0) + (trips < n)
    return min(trips, LOOPS[name] - 1)


class _Reads(TorchFunctionMode):
    """Every host read of a tensor made inside, as (the innermost open
    span's id, the innermost call site in lins_tpu_torch)."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in HOST_READS:
            port = [f for f in traceback.extract_stack()[:-1]
                    if "lins_tpu_torch" in f.filename]
            site = (f"{port[-1].filename.split('lins_tpu_torch')[-1]}:"
                    f"{port[-1].name}" if port else "")
            opened = metrics.RECORDER._open
            self.reads.append((opened[-1][0] if opened else 0, site))
        return func(*args, **(kwargs or {}))


def _replay(data, form=None):
    """(the spans, the LinsSlam, the host reads by `_Reads`) of the TINY
    replay, in `form` when given."""
    out, reads = {}, _Reads()
    with pytest.MonkeyPatch.context() as mp:
        if form:
            form(mp)
        with reads:
            spans = _recorded(lambda: out.setdefault(
                "slam", LinsSlam(TINY, device="cpu", dtype=F64)
                .run_replay(data, chunk=CHUNK)))
    return spans, out["slam"], reads.reads


@pytest.fixture(scope="module")
def replay_run(data):
    """The TINY replay, its branches and loops decided on the host."""
    return _replay(data)


@pytest.fixture(scope="module")
def replay_spans(replay_run):
    return replay_run[0]


@pytest.fixture(scope="module")
def selected_run(data):
    """The TINY replay in `_selected_form`."""
    return _replay(data, _selected_form)


def _check_tree(spans):
    """Each span lies inside its parent, and carries its parent's root."""
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] == 0:
            assert s["root"] == s["id"]
            continue
        p = by_id[s["parent"]]
        assert s["root"] == p["root"]
        assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
        if p["scan"] is not None:
            assert s["scan"] == p["scan"]
    return by_id


def test_replay_ids_roots_and_scan_index(replay_spans):
    by_id = _check_tree(replay_spans)
    # roots: the staging, each chunk, each tail scan streamed after them
    roots = {s["name"] for s in replay_spans if s["parent"] == 0}
    assert roots == {"slam.stage_replay", "slam.chunk", "slam.scan"}
    chunks = [s for s in replay_spans if s["name"] == "slam.chunk"]
    assert chunks and all(c["attrs"]["K"] == CHUNK for c in chunks)
    for c in chunks:
        inside = [s for s in replay_spans if s["root"] == c["id"]]
        names = {s["name"] for s in inside}
        assert {"odometry.chunk", "mapper.chunk", "odometry.step",
                "odometry.ieskf", "odometry.fallback"} <= names
        # one per-scan odometry step per scan, indexed 0..K-1, and each
        # IESKF update inside its scan's step
        steps = [s for s in inside if s["name"] == "odometry.step"]
        assert [s["scan"] for s in steps] == list(range(CHUNK))
        for s in inside:
            if s["name"] == "odometry.ieskf":
                assert by_id[s["parent"]]["name"] == "odometry.step"
            if s["name"] in ("mapper.step", "loop.attempt"):
                assert by_id[s["parent"]]["name"] == "mapper.chunk"
                assert 0 <= s["scan"] < CHUNK
    # the bootstrap's scans are streamed inside the staging
    stage = next(s for s in replay_spans if s["name"] == "slam.stage_replay")
    assert any(s["name"] == "slam.scan" and s["parent"] == stage["id"]
               for s in replay_spans)


def test_streaming_ids_roots(data):
    spans = _recorded(lambda: run_sequence(
        LinsSlam(TINY, device="cpu", dtype=F64), data, n_scans=12))
    _check_tree(spans)
    roots = [s for s in spans if s["parent"] == 0]
    assert [s["name"] for s in roots] == ["slam.scan"] * 12
    assert len({s["root"] for s in spans}) == 12
    assert all(s["scan"] is None for s in spans)
    names = {s["name"] for s in spans}
    assert {"odometry.frontend", "odometry.ieskf", "odometry.gn_icp",
            "mapper.step", "mapper.scan_to_map", "loop.attempt"} <= names


def test_ring_bound_and_dropped():
    rec = metrics.SpanRecorder(capacity=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "RECORDER", rec)
        for i in range(10):
            with metrics.trace_scope("a" if i % 2 else "b", i=i):
                pass
    assert len(rec.ring) == 4 and rec.dropped == 6
    assert [s["attrs"]["i"] for s in rec.spans()] == [6, 7, 8, 9]
    assert {k: v[0] for k, v in rec.totals.items()} == {"a": 5, "b": 5}
    rec.clear()
    assert not rec.ring and rec.dropped == 0 and not rec.totals


class _Ops(TorchFunctionMode):
    """Every torch function and tensor method called inside."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(func)
        return func(*args, **(kwargs or {}))


def test_device_attributes_read_at_export_in_one_read(monkeypatch):
    """Recording touches no tensor; `spans()` reads every tensor attribute
    with one stack and one copy per device."""
    rec = metrics.SpanRecorder()
    monkeypatch.setattr(metrics, "RECORDER", rec)
    flags = [torch.tensor(True), torch.tensor(7, dtype=torch.int32),
             torch.tensor(2.5, dtype=F64)]
    ops = _Ops()
    with ops:
        with metrics.trace_scope("outer", kept=flags[0], n=3) as span:
            with metrics.trace_scope("inner", live=flags[1]):
                pass
            span["x"] = flags[2]
    assert ops.calls == []
    reads = []
    inner = metrics._read
    monkeypatch.setattr(metrics, "_read",
                        lambda ts: reads.append(len(ts)) or inner(ts))
    stacks = []
    stack = torch.stack
    monkeypatch.setattr(torch, "stack",
                        lambda ts, *a, **k: stacks.append(1) or stack(ts))
    got = rec.spans()
    assert reads == [3] and len(stacks) == 1
    assert [s["attrs"] for s in got] == [{"live": 7},
                                         {"kept": True, "n": 3, "x": 2.5}]
    assert type(got[1]["attrs"]["kept"]) is bool
    assert type(got[0]["attrs"]["live"]) is int


def test_card_cond_adds_no_operation(monkeypatch):
    """`cond` in its selected form calls what `select_cond` calls, no
    more."""
    pred = torch.tensor(False)
    keep = (torch.zeros(3), torch.ones(2))

    def branch():
        return keep[0] + 1, keep[1] * 2

    alone, spanned = _Ops(), _Ops()
    with alone:
        tree.select_cond(pred, branch, keep)
    monkeypatch.setattr(tree, "_decide", tree.select_cond)
    with spanned:
        tree.cond(pred, branch, keep, "probe")
    assert spanned.calls == alone.calls


def test_discarded_sum_counts_each_piece_once():
    """A dropped branch counts whole, its inner spans not again; a loop's
    frozen share is taken of its self time, less its branches."""
    def span(sid, parent, ns, **attrs):
        return dict(name=f"s{sid}", id=sid, parent=parent, root=1, scan=None,
                    start_ns=0, end_ns=ns, attrs=attrs)

    spans = [span(1, 0, 1000),
             span(2, 1, 300, kept=False),               # 300
             span(3, 2, 100, kept=False),               # inside 2: 0
             span(4, 2, 100, trips=10, live=2),         # inside 2: 0
             span(5, 1, 400, trips=10, live=6),         # (400 - 150) * 0.4
             span(6, 5, 100, kept=True),                # kept: 0
             span(7, 5, 50, kept=False)]                # 50
    assert _program.discarded_ns(spans) == pytest.approx(300 + 100 + 50)


def test_card_form_kept_flags_and_discarded(replay_run, selected_run):
    """The card's form, every branch and loop decided on the host: each
    `cond` span's `kept` a host bool with one read, each loop's trips all
    live with its reads as issued, nothing discarded but the reads of the
    branches not taken; the same run in the selected form computed and
    discarded some, and gives the same poses and state bit for bit."""
    spans, slam, _ = replay_run
    _check_tree(spans)
    conds = [s for s in spans if "kept" in s["attrs"]]
    assert {s["name"] for s in conds} >= {
        "odometry.fallback", "mapper.keyframe_add", "mapper.window_rebuild",
        "mapper.regather", "loop.align", "loop.solve"}
    assert all(type(s["attrs"]["kept"]) is bool for s in conds)
    assert any(s["attrs"]["kept"] for s in conds)
    assert not all(s["attrs"]["kept"] for s in conds)
    # every loop stopped on the host's reads, `live` its count
    for s in spans:
        a = s["attrs"]
        if s["name"] in LOOPS:
            assert 0 < a["trips"] == a["live"] <= LOOPS[s["name"]], s
            assert a["reads"] == _loop_reads(s["name"], a["trips"]), s
        elif s["name"] in CONDS:
            assert a["reads"] == 1 and a["read_ns"] >= 0, s
        elif s["name"] == "odometry.fallback":
            assert a["reads"] == 0 and a["kept"] is False, s
    # one IESKF update a RUNNING scan, streamed or chunked
    lives = [s["attrs"]["live"] for s in spans if s["name"] == "odometry.ieskf"]
    assert lives == [int(m["iters"]) for m in slam.odometry.metrics]
    # a step's n_refresh is the re-gathers its scan-to-map kept
    for s in spans:
        if s["name"] == "mapper.step":
            s2m = [c for c in spans if c["parent"] == s["id"]
                   and c["name"] == "mapper.scan_to_map"]
            kept = [c for c in spans if s2m and c["parent"] == s2m[0]["id"]
                    and c["attrs"].get("kept")]
            assert s["attrs"]["n_refresh"] == len(kept)
    # the discarded time: only the branches not taken (their spans hold
    # their read alone), where the selected form discards some, less than
    # its run
    decided = _program.discarded_ns(spans)
    dropped = sum(s["end_ns"] - s["start_ns"] for s in spans
                  if s["attrs"].get("kept") is False)
    assert decided == pytest.approx(dropped)
    sel_spans, sel_slam, _ = selected_run
    run_ns = sum(s["end_ns"] - s["start_ns"] for s in sel_spans
                 if s["parent"] == 0)
    assert decided < _program.discarded_ns(sel_spans) < run_ns
    assert any(s["attrs"]["trips"] > s["attrs"]["live"] for s in sel_spans
               if s["name"] == "mapper.scan_to_map")
    # and both forms give the same trajectories and mapper state
    for a, b in zip(slam.trajectory_arrays(), sel_slam.trajectory_arrays()):
        np.testing.assert_array_equal(a, b)
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0,
                                                     equal_nan=True),
             slam.mapper.state, sel_slam.mapper.state)


def test_mapper_reads_as_issued(replay_run):
    """Every host read inside a mapping step or a loop attempt is one its
    spans count in `reads`, made at `tree.cond`'s or `may_stop`'s site
    (the front end's `div_const` reads a constant made on the host, no
    device value), and the discarded time is under 1% of the mapper's."""
    spans, _, reads = replay_run
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)

    def inside(s):
        out = [s]
        for c in kids.get(s["id"], []):
            out += inside(c)
        return out

    mapper = [s for s in spans if s["name"] in ("mapper.step",
                                                "loop.attempt")]
    assert mapper
    said_all = 0
    for s in mapper:
        sub = inside(s)
        ids = {c["id"] for c in sub}
        made = [site for sid, site in reads if sid in ids
                and not site.endswith(":div_const")]
        said = sum(c["attrs"].get("reads", 0) for c in sub)
        assert len(made) == said, (s, made)
        assert set(made) <= {"/utils/tree.py:_decide",
                             "/utils/device.py:may_stop"}, made
        said_all += said
    assert said_all > len(mapper)
    mapper_ns = sum(s["end_ns"] - s["start_ns"] for s in mapper)
    assert _program.discarded_ns(spans) < 0.01 * mapper_ns


@pytest.mark.parametrize("taken", [False, True])
def test_cond_issues_only_the_taken_branch(monkeypatch, taken):
    """`cond` reads its predicate once and issues the branch only when it
    is taken; its span records the read."""
    rec = metrics.SpanRecorder()
    monkeypatch.setattr(metrics, "RECORDER", rec)
    keep = (torch.zeros(3), torch.ones(2))

    def branch():
        return keep[0] + 1, keep[1] * 2

    pred, ops = torch.tensor(taken), _Ops()
    with ops:
        out = tree.cond(pred, branch, keep, "probe")
    want = _Ops()
    with want:
        branch()
    assert ops.calls == [torch.Tensor.__bool__] + (want.calls if taken
                                                   else [])
    assert all(torch.equal(a, b) for a, b in zip(
        out, branch() if taken else keep))
    attrs, = [s["attrs"] for s in rec.spans()]
    assert attrs["kept"] is taken and attrs["reads"] == 1


def test_icp_stops_on_host_reads():
    """The loop ICP stops on the host's reads once its gate is the finest
    (reads as `_loop_reads` counts them) and gives what all its trips
    give, bit for bit."""
    gen = torch.Generator().manual_seed(3)
    dst = torch.rand(400, 3, generator=gen, dtype=F64) * 8.0
    ang = torch.tensor(0.05, dtype=F64)
    c, s_ = torch.cos(ang), torch.sin(ang)
    R0 = torch.stack([torch.stack([c, -s_, 0 * c]),
                      torch.stack([s_, c, 0 * c]),
                      torch.tensor([0.0, 0.0, 1.0], dtype=F64)])
    src = (dst[:300] - torch.tensor([0.2, -0.1, 0.05], dtype=F64)) @ R0
    ok_s, ok_d = torch.ones(300, dtype=torch.bool), torch.ones(
        400, dtype=torch.bool)

    def run():
        return loop_closure.icp_align(src, ok_s, dst, ok_d,
                                      iters=TINY.loop_icp_iters,
                                      max_corr=TINY.loop_icp_max_corr)

    out = []
    spans = _recorded(lambda: out.append(run()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_closure, "may_stop", lambda active: False)
        full_spans = _recorded(lambda: out.append(run()))
    a, = [s["attrs"] for s in spans if s["name"] == "loop.icp"]
    b, = [s["attrs"] for s in full_spans if s["name"] == "loop.icp"]
    assert a["trips"] == a["live"] < TINY.loop_icp_iters
    assert a["reads"] == _loop_reads("loop.icp", a["trips"]) > 0
    assert b["trips"] == TINY.loop_icp_iters and b["live"] == a["live"]
    for x, y in zip(*out):
        assert torch.equal(x, y)


# the scans of the full-trip comparison (its form costs 30 + 30 trips a scan)
N_FULL = 6


def _odometry_run(data, mode, full_trips=False):
    """(the LinsOdometry, its spans) of the TINY sequence's first N_FULL
    scans streamed or replayed in chunks with mapping off; with
    `full_trips` in the form of `_full_trips`."""
    out = {}

    def run():
        slam = LinsSlam(TINY, device="cpu", dtype=F64, enable_mapping=False)
        if mode == "chunked":
            slam.run_replay(data, n_scans=N_FULL, chunk=CHUNK)
        else:
            run_sequence(slam, data, n_scans=N_FULL)
        out["odo"] = slam.odometry

    with pytest.MonkeyPatch.context() as mp:
        if full_trips:
            _full_trips(mp)
        spans = _recorded(run)
    return out["odo"], spans


@pytest.mark.parametrize("mode", ["streamed", "chunked"])
def test_host_decided_equals_full_trips(data, mode):
    """The odometry's loops stopped and its fallback decided on the host
    give the full-trip form's trajectory, filter states and per-scan
    metrics bit for bit: a frozen trip and a fallback not kept change
    nothing."""
    decided, spans = _odometry_run(data, mode)
    full, full_spans = _odometry_run(data, mode, full_trips=True)

    def trips(spans, name):
        return [s["attrs"]["trips"] for s in spans if s["name"] == name]

    # the full form issued every trip, and the fallback every RUNNING scan
    # after the bootstrap's GN; the host-decided form stopped each IESKF
    # early and issued the GN for the bootstrap alone
    assert trips(full_spans, "odometry.ieskf") == [TINY.num_iter] * (
        N_FULL - 2)
    assert trips(full_spans, "odometry.gn_icp") == [TINY.num_iter] * (
        N_FULL - 1)
    assert max(trips(spans, "odometry.ieskf")) < TINY.num_iter
    assert len(trips(spans, "odometry.gn_icp")) == 1
    for a, b in zip(decided.trajectory_arrays(), full.trajectory_arrays()):
        np.testing.assert_array_equal(a, b)
    for name in ("filter_state", "global_state", "last_surf", "last_corner",
                 "rel_pose"):
        tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0,
                                                         atol=0),
                 getattr(decided, name), getattr(full, name))
    assert len(decided.metrics) == len(full.metrics) == N_FULL - 2
    for m, n in zip(decided.metrics, full.metrics):
        for key in ("iters", "n_surf", "n_corner", "residual", "diverged",
                    "enough"):
            assert torch.equal(torch.as_tensor(m[key]),
                               torch.as_tensor(n[key])), key


def test_divergence_takes_the_fallback(data):
    """A RUNNING scan whose IESKF diverges (a covariance that is not
    positive definite: the update is NaN at its first trip) records
    `odometry.fallback` kept, with the GN inside it, and fuses the GN ICP
    from the propagated pose."""
    slam = run_sequence(LinsSlam(TINY, device="cpu", dtype=F64,
                                 enable_mapping=False), data, n_scans=4)
    odo, k = slam.odometry, 4
    t = float(data["scan_times"][k]) + TINY.scan_period
    for ti, a, g in zip(data["imu_times"], data["imu_acc"], data["imu_gyr"]):
        if odo.time + 1e-9 < ti <= t + 1e-9:
            odo.add_imu(ti, a, g)
    imu = odo._imu_tensors(*odo._imu_batch_np(t))
    _, _, feats = process_cloud(*odo._scan_tensors(
        data["scans_xyz"][k], data["scans_n"][k]), TINY)
    fs0 = odo.filter_state._replace(P=-torch.eye(eskf.DIM, dtype=F64))
    state = (fs0, odo.global_state, feats, odo.last_surf, odo.last_corner)
    out = []
    spans = _recorded(lambda: out.append(est.running_step_impl(
        *state, *imu, TINY)))
    by_id = {s["id"]: s for s in spans}
    ieskf_span, = [s for s in spans if s["name"] == "odometry.ieskf"]
    assert ieskf_span["attrs"] == {"trips": 1, "reads": 1, "live": 1}
    fb, = [s for s in spans if s["name"] == "odometry.fallback"]
    assert fb["attrs"] == {"kept": True, "reads": 0}
    gn, = [s for s in spans if s["name"] == "odometry.gn_icp"]
    assert by_id[gn["parent"]] is fb
    metrics_ = out[0][6]
    assert bool(metrics_["diverged"]) and bool(metrics_["enough"])
    fs = eskf.propagate(fs0, *imu, TINY)
    rn, qbn, _ = gn_icp.estimate_transform(
        fs.rn, fs.qbn, feats.flat, feats.sharp, odo.last_surf,
        odo.last_corner, TINY)
    assert torch.equal(out[0][4], rn) and torch.equal(out[0][5], qbn)


def _traced(cell, mp):
    """A TINY `--trace 1` run of the cell and the Trace its readers got."""
    made = []

    class Trace(harness.Trace):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    mp.setattr(harness, "Trace", Trace)
    res, _ = run_tiny(tiny_cell(cell), trace=1)
    return res, made[0]


@pytest.mark.parametrize("cell", ["vlp16-replay", "vlp16-live"])
def test_readers_read_the_window(cell):
    rec = metrics.SpanRecorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "RECORDER", rec)
        res, trace = _traced(cell, mp)
    mine = [m["name"] for m in tiny_cell(cell).per_layer
            if m["name"] in READS]
    assert len(mine) == (5 if cell == "vlp16-replay" else 2)
    window = _program.window_spans(trace)
    assert window and len(window) < len(rec.ring)
    names = {s["name"] for s in window}
    for name in mine:
        value = harness.load_reader(name).read(trace)
        if READS[name] is None or READS[name] in names:
            assert value is not None and value > 0, name
            assert res["metrics"][name]["value"] == value
        else:
            assert value is None and name not in res["metrics"], name
    # a port that records no spans: every reader reads nothing
    trace.program_spans = None
    with pytest.MonkeyPatch.context() as mp:
        mp.delattr(metrics, "RECORDER")
        for name in mine:
            assert harness.load_reader(name).read(trace) is None


def _vlp16_chunks(n_chunks, **kw):
    """A VLP-16 LinsSlam on the card (`kw` to it) staged over a gentle
    drive of 6 streamed scans and `n_chunks` chunks of 32, and its jobs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from lins_tpu_torch.config import VLP16

    cfg = VLP16.replace(max_points=28800, use_pallas=True,
                        use_pallas_select=True)
    data = syn.generate_sequence(cfg, n_scans=6 + n_chunks * 32,
                                 kind="gentle", speed=1.5)
    slam = LinsSlam(cfg, **kw)
    slam.warmup()
    jobs, _ = slam.stage_replay(data, chunk=32, min_streamed=6)
    return slam, jobs


@pytest.mark.cuda
def test_warm_chunk_syncs_only_at_read_sites():
    """A warm VLP-16 chunk (K = 32) on the card under PyTorch's sync debug
    mode (`chip_smoke.count_host_syncs`) with the recorder recording: every
    host sync at the odometry's and the mapper's read sites, as many as
    their spans' `reads`, none in the front end; every loop stopped at its
    live trips; the spans read back after."""
    import chip_smoke

    slam, jobs = _vlp16_chunks(2)
    slam.run_chunk(jobs[0])
    torch.cuda.synchronize()
    with chip_smoke.record_spans() as spans, \
            chip_smoke.count_host_syncs() as sites:
        slam.run_chunk(jobs[1])
        torch.cuda.synchronize()
    names = {s["name"] for s in spans}
    assert {"slam.chunk", "odometry.ieskf", "odometry.fallback",
            "mapper.step", "mapper.scan_to_map", "mapper.regather",
            "mapper.keyframe_add", "loop.attempt", "loop.align",
            "loop.solve"} <= names
    reads = sum(s["attrs"].get("reads", 0) for s in spans)
    mapper = sum(s["attrs"].get("reads", 0) for s in spans
                 if s["name"].startswith(("mapper.", "loop.")))
    assert all(site.startswith(chip_smoke.READ_SITES)
               for site in sites), sites
    assert sum(sites.values()) == reads > mapper > 0
    ieskf_spans = [s["attrs"] for s in spans if s["name"] == "odometry.ieskf"]
    assert len(ieskf_spans) == 32
    for a in ieskf_spans:
        assert a["trips"] == a["live"] == a["reads"], a
    for s in spans:
        if s["name"] in LOOPS:
            assert s["attrs"]["trips"] == s["attrs"]["live"], s
        if s["name"] in CONDS:
            assert s["attrs"]["reads"] == 1, s
    json.dumps(spans)
    assert np.isfinite([s["end_ns"] - s["start_ns"] for s in spans]).all()


@pytest.mark.cuda
def test_card_chunk_equals_full_trips():
    """A warm VLP-16 chunk's odometry on the card, its loops and fallback
    decided on the host, against the same chunk in the full-trip form
    (`_full_trips`) from the same state: poses, filter state and per-scan
    metrics bit for bit."""
    slam, jobs = _vlp16_chunks(2, enable_mapping=False)
    slam.run_chunk(jobs[0])
    odo = slam.odometry
    names = ("filter_state", "global_state", "last_surf", "last_corner")
    start = {n: tree_map(torch.clone, getattr(odo, n)) for n in names}
    runs = []
    for full in (False, True):
        for n in names:
            setattr(odo, n, tree_map(torch.clone, start[n]))
        with pytest.MonkeyPatch.context() as mp:
            if full:
                _full_trips(mp)
            odo.add_scan_chunk(*jobs[1][0])
        runs.append(dict(poses=odo.last_chunk_poses,
                         state=tuple(getattr(odo, n) for n in names),
                         metrics=odo.metrics[-32:]))
    decided, full = runs
    for a, b in zip(decided["poses"], full["poses"]):
        assert torch.equal(a, b)
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0),
             decided["state"], full["state"])
    for m, n in zip(decided["metrics"], full["metrics"]):
        for key in ("iters", "n_surf", "n_corner", "residual", "diverged"):
            assert m[key] == n[key], key


def _mapper_forms(slam, job):
    """The mapper over one staged chunk (`job`) twice from the same state,
    its branches and loops decided on the host, then in `_selected_form`:
    the fused poses, the final mapper state, the steps' metrics and the
    attempts' infos of each."""
    (ts, xyz_k, n_k, imu), (ts_dev, mf, lf, rp_dev) = job
    odo, m = slam.odometry, slam.mapper
    odo.add_scan_chunk(ts, xyz_k, n_k, imu=imu)
    assert mf.any() and lf.any()
    start = tree_map(torch.clone, m.state)
    has_map, n_steps, n_loops = m._has_map, len(m.metrics), len(m.loop_info)
    runs = []
    for selected in (False, True):
        m.state, m._has_map = tree_map(torch.clone, start), has_map
        with pytest.MonkeyPatch.context() as mp:
            if selected:
                _selected_form(mp)
            pos, quat = m.process_chunk(ts, *odo.last_chunk_poses,
                                        odo.last_chunk_clouds, ts_dev, mf, lf,
                                        imu_rp_dev=rp_dev)
        runs.append(dict(pos=pos, quat=quat, state=m.state,
                         metrics=m.metrics[n_steps:],
                         loops=m.loop_info[n_loops:]))
        del m.metrics[n_steps:], m.loop_info[n_loops:]
        del m.trajectory[len(m.trajectory) - int(mf.sum()):]
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("drive", ["vlp16", "hdl64-circuit"])
def test_card_chunk_equals_selected_mapper(drive):
    """A warm chunk's mapping steps and loop attempts on the card, their
    branches and loops decided on the host, against the same chunk with
    every branch computed and selected and every trip run (the card's form
    before; `_selected_form`) from the same state, bit for bit: a VLP-16
    chunk with mapping steps and attempts that find nothing, and an HDL-64
    stretch of the revisiting circuit whose attempts find a loop."""
    if drive == "vlp16":
        slam, jobs = _vlp16_chunks(2)
        warm, job = jobs[:1], jobs[1]
    else:
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        from lins_tpu_torch.config import HDL64

        import chip_smoke

        cfg = HDL64.replace(use_pallas=True, use_pallas_select=True,
                            loop_time_gate=4.0)
        data = syn.generate_sequence(cfg, n_scans=6 + 3 * 32,
                                     **chip_smoke.SEQ_H)
        slam = LinsSlam(cfg)
        slam.warmup()
        jobs, _ = slam.stage_replay(data, chunk=32, min_streamed=6)
        warm, job = jobs[:2], jobs[2]
    for j in warm:
        slam.run_chunk(j)
    decided, selected = _mapper_forms(slam, job)
    found = [bool(i["found"]) for i in decided["loops"]]
    assert found and (any(found) if drive != "vlp16" else not any(found))
    assert torch.equal(decided["pos"], selected["pos"])
    assert torch.equal(decided["quat"], selected["quat"])
    same = dict(rtol=0, atol=0, equal_nan=True)
    tree_map(lambda x, y: torch.testing.assert_close(x, y, **same),
             decided["state"], selected["state"])
    for a, b in zip(decided["metrics"] + decided["loops"],
                    selected["metrics"] + selected["loops"], strict=True):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], **same)
