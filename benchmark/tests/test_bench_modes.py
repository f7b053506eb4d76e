"""Each mode's driver through `run.execute` on the CPU at the TINY size:
the result's keys and metrics, the traced run's per-layer metrics, and
(the correctness test) `correct` false under each fault a cell can have:
an odometry step that returns its state unchanged, a fused pose altered
where it is produced, half of a batch of streams left out; and a drive
that ends inside the window, followed by the next."""
import json

import pytest

from benchmark import compare
from benchmark.run import result_line
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = ("vlp16-replay", "hdl64-loop-replay", "vlp16-live",
         "vlp16-multistream-replay")
FAULTS = {"vlp16-replay": ("frozen", "altered"),
          "hdl64-loop-replay": ("frozen", "altered"),
          "vlp16-live": ("frozen", "altered"),
          "vlp16-multistream-replay": ("half",)}
_SOUND = {}


def sound(cell):
    """The cell's sound TINY run, once per process."""
    if cell not in _SOUND:
        _SOUND[cell] = run_tiny(tiny_cell(cell))
    return _SOUND[cell]


def tiny_limits(got):
    """Limits for the TINY size: the sound run's readings with room (the
    cells' own limits are set for their full sizes)."""
    lim = {k: {"max": 2.0 * v + 1e-9} for k, v in got.items()
           if k not in ("loops", "missing")}
    lim["missing"] = {"max": 0}
    return lim


@pytest.mark.parametrize("cell", CELLS)
def test_mode_runs_and_prints_the_contract_keys(cell):
    res, rec = sound(cell)
    c = tiny_cell(cell)
    line = json.loads(json.dumps(result_line(res, "cpu test", 1, False)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert res["got"]["missing"] == 0
    assert {"surf_end_p50_mm", "fused_ate_mm"} <= set(res["got"])
    assert rec["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_span_metrics(cell):
    res, _ = run_tiny(tiny_cell(cell), trace=1)
    c = tiny_cell(cell)
    spans = {m["name"] for m in c.per_layer if m["source"] == "host_clock"}
    # the profiler's metrics need a card: without one their readers
    # return nothing and the harness leaves them out
    assert set(res["metrics"]) == spans
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert "breakdown" not in res


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(cell, fault):
    got = sound(cell)[0]["got"]
    limits = tiny_limits(got)
    ok, _ = compare.judge(got, limits)
    assert ok, got
    res, _ = run_tiny(tiny_cell(cell), limits=limits, fault=fault)
    assert res["correct"] is False, (fault, res["got"], limits)


# window iterations (chunks, or scans) that outlast the TINY drive: replay
# runs 2 chunks after the warm one, stages the next drive, runs 2 more;
# live streams past the drive's end into the next drive's first poses
OUTLAST = {"vlp16-replay": 5, "vlp16-live": 50}


@pytest.mark.parametrize("cell", sorted(OUTLAST))
def test_a_drive_that_ends_in_the_window_is_followed(cell, monkeypatch):
    """A port fast enough to reach its drive's end inside the window: the
    next drive starts in the window, every scan handed over gets its
    answer, and the run is correct."""
    from benchmark import drive

    got = sound(cell)[0]["got"]
    calls = []

    def window_open(self):
        calls.append(None)
        return len(calls) <= OUTLAST[cell]

    monkeypatch.setattr(drive.Context, "window_open", window_open)
    res, rec = run_tiny(tiny_cell(cell), limits=tiny_limits(got))
    assert rec["drives"] >= 2
    assert res["got"]["missing"] == 0 and res["failed"] == 0
    assert rec["produced"] > 0
    assert res["correct"] is True, res["compared"]
