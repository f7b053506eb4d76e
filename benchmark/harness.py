"""The benchmark's data-driven core: it finds a cell's configuration,
traffic mix, mode driver, per-layer readers and limits by name in files of
their own, runs the mode, and reduces what it recorded to the result line.

Nothing here imports JAX or the JAX package; the program under test is
`lins_tpu_torch`, reached only through its public entries.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "lins_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of BENCHMARK.json's `workloads`, with what it names."""

    name: str
    chips: int
    config_name: str
    config: dict       # the configuration file
    traffic_name: str
    traffic: dict      # the traffic file
    end_to_end: list   # the end-to-end metrics this cell reports
    per_layer: list    # the per-layer metrics this cell reports
    limits: dict       # {number: limit} of the comparison


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None,
              bench: Path = BENCH) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `spec`), its files read
    from the benchmark's folders under `bench`."""
    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(ROOT / conf["file"]), traffic_name=w["traffic"],
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        limits=load_json(bench / "limits" / f"{name}.json"))


def slam_config(conf: dict, **extra):
    """The port's SlamConfig of a configuration file: its preset with its
    overrides (and `extra`, which the CPU tests use to shrink the sensor)."""
    from lins_tpu_torch import config as lc

    base = getattr(lc, conf["preset"])
    return base.replace(**{**conf.get("overrides", {}), **extra})


def load_mode(name: str, bench: Path = BENCH):
    """The driver module benchmark/modes/<name>.py: `run(ctx)`."""
    return _module(bench / "modes" / f"{name}.py", f"bench_mode_{name}")


def load_reader(metric: str, bench: Path = BENCH):
    """The reader benchmark/layer_metrics/<metric>.py of a per-layer
    metric: a module with `read(trace) -> float | None`."""
    return _module(bench / "layer_metrics" / f"{metric}.py",
                   "bench_metric_" + metric.replace(".", "_"))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The benchmark's own spans around calls into the port's public
    entries.  Off (the `--trace 0` runs) it records nothing and adds
    nothing; on, each span is fenced by a synchronize at both ends and
    kept as (name, start ns, end ns, phase), on `time.time_ns`, the clock
    of the profiler's events."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = device
        self.phase = "setup"
        self.spans = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        sync(self.device)
        t0 = time.time_ns()
        try:
            yield
        finally:
            sync(self.device)
            self.spans.append((name, t0, time.time_ns(), self.phase))

    def wrap(self, obj, attr: str, name: str):
        """Put a span around every call of `obj.attr` (an instance
        attribute shadows the method; nothing of the port changes)."""
        if not self.on:
            return
        inner = getattr(obj, attr)

        def call(*args, **kw):
            with self.span(name):
                return inner(*args, **kw)

        setattr(obj, attr, call)

    def seconds(self, name: str, phase: str = "window") -> float:
        return sum(t1 - t0 for n, t0, t1, p in self.spans
                   if n == name and p == phase) / 1e9


@dataclasses.dataclass
class Trace:
    """What a `--trace 1` run hands the per-layer readers."""

    tracer: Tracer
    window_scans: int = 0          # fused poses the window produced
    profile: dict | None = None    # harness.reduce_profile's result
    assoc_bound_s: float | None = None   # K4/K5 bound over the profile
    assoc_calls: int = 0           # K4/K5 launches recorded there


class Profiled:
    """One torch.profiler session (CUDA activity) over a stretch of the
    window, opened once per process: the profiler records no launch of the
    port's ctypes kernels after a process's first session.  While it is
    open every K4/K5 launch's inputs are kept (by reference, nothing is
    copied) for `work.assoc_bound_s` after the window."""

    def __init__(self, tracer: Tracer, scans: int):
        self.tracer = tracer
        self.scans = scans
        self.result = None
        self.assoc_calls = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from lins_tpu_torch.ops import assoc

        self._assoc = assoc
        self._inner = inner = assoc.scan_normal_equations
        calls = self.assoc_calls

        def record(flat, sharp, surf, corner, rn, qbn, iter_count, cfg,
                   form):
            calls.append((flat, sharp, surf, corner, rn, qbn, form,
                          cfg.nearest_feature_search_sq_dist))
            return inner(flat, sharp, surf, corner, rn, qbn, iter_count, cfg,
                         form)

        assoc.scan_normal_equations = record
        sync(self.tracer.device)
        self._prof = None
        if self.tracer.device.type == "cuda":
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        sync(self.tracer.device)
        self.t1 = time.time_ns()
        if self._prof is not None:
            self._prof.__exit__(*exc)
        self._assoc.scan_normal_equations = self._inner
        return False


def reduce_profile(prof: Profiled) -> dict:
    """None without a card; else launches, busy seconds (the union of the device intervals), the
    profiled wall seconds, the top device operations by time, the idle
    time by the benchmark span the host was in, and the K4/K5 launches'
    device seconds."""
    from torch.autograd import DeviceType

    if prof._prof is None:
        return None
    evs = [(e.start_ns(), e.end_ns(), e.name())
           for e in prof._prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    evs.sort()
    busy, end, by_name, assoc_s = 0, None, {}, 0.0
    gaps = []
    for s, e, name in evs:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
        key = name[:80]
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
        if "assoc_normal_equations" in name:
            assoc_s += (e - s) / 1e9
    if evs:
        gaps = [(prof.t0, evs[0][0])] + gaps + [(end, prof.t1)]
    idle = {}
    spans = sorted(prof.tracer.spans, key=lambda s: s[2] - s[1])
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        # the innermost (shortest) span the host was in at the gap's middle
        label = next((n for n, s0, s1, _ in spans if s0 <= mid < s1),
                     "outside the benchmark's spans")
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(launches=len(evs), busy_s=busy / 1e9,
                window_s=(prof.t1 - prof.t0) / 1e9, scans=prof.scans,
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[f"idle in {n}", s] for n, s in
                           sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
                assoc_device_s=assoc_s,
                assoc_launches=sum(1 for _, _, n in evs
                                   if "assoc_normal_equations" in n))


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: `lins_tpu_torch` is not
    `lins_tpu`."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
