"""The harness finds every part of a cell by name in files of its own, and
a cell can be added from new files alone."""
import json
import shutil

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.traffic["mode"] in ("replay", "live", "multistream")
    assert callable(harness.load_mode(c.traffic["mode"]).run)
    assert harness.slam_config(c.config).line_num > 0
    assert c.limits and all(("max" in v) ^ ("min" in v)
                            for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
        assert m["moves"] in e2e


def test_spec_names_are_files():
    for conf in SPEC["configs"]:
        assert (harness.ROOT / conf["file"]).is_file()
    for w in SPEC["workloads"]:
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in SPEC["per_layer"]:
        assert (harness.BENCH / "layer_metrics" / f"{m['name']}.py").is_file()


def test_a_cell_from_new_files_alone(tmp_path):
    """A new mix, a new mode, a new reader and a new cell's limits, each a
    new file; no file that is there changes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    mix = dict(harness.load_json(bench / "traffic" / "gentle-replay.json"),
               mode="probe")
    (bench / "traffic" / "probe-mix.json").write_text(json.dumps(mix))
    (bench / "modes" / "probe.py").write_text(
        "def run(ctx):\n    return 'probe ran'\n")
    (bench / "layer_metrics" / "probe.metric.py").write_text(
        "def read(trace):\n    return 42.0\n")
    (bench / "limits" / "probe-cell.json").write_text(
        json.dumps({"missing": {"max": 0}}))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "probe-cell", "config": "vlp16-lins",
                              "traffic": "probe-mix", "chips": 1,
                              "why": "a probe"})
    spec["per_layer"].append({"name": "probe.metric", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "driver", "moves": "setup_s",
                              "workloads": ["probe-cell"]})
    c = harness.load_cell("probe-cell", spec=spec, bench=bench)
    assert c.traffic["mode"] == "probe"
    assert harness.load_mode("probe", bench).run(None) == "probe ran"
    assert [m["name"] for m in c.per_layer] == ["probe.metric"]
    assert harness.load_reader("probe.metric", bench).read(None) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())
