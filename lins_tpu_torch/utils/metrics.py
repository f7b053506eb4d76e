"""Structured per-scan metrics and timing scopes (port of
`lins_tpu/utils/metrics.py`; reference C26, tic_toc.h).

Every stage records structured records that dump as JSON lines, and
`trace_scope` wraps a stage in a `torch.profiler.record_function` range,
which a profiler session shows beside the stage's device work.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

from lins_tpu_torch.utils.lazy import to_numpy


class MetricsLog:
    """Append-only structured metrics with running averages."""

    def __init__(self):
        self.records = []
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def record(self, stage: str, **fields):
        rec = {"stage": stage, "t_wall": time.time()}
        for k, v in fields.items():
            if hasattr(v, "shape"):
                v = to_numpy(v).tolist()
            rec[k] = v
            if isinstance(v, (int, float)):
                self._sums[f"{stage}/{k}"] += v
                self._counts[f"{stage}/{k}"] += 1
        self.records.append(rec)

    def mean(self, key: str) -> float:
        c = self._counts.get(key, 0)
        return self._sums.get(key, 0.0) / c if c else float("nan")

    def dump(self, path: str):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    def summary(self) -> dict:
        return {k: self.mean(k) for k in self._counts}


@contextlib.contextmanager
def trace_scope(name: str, enabled: bool = True):
    """Named profiler range (torch.profiler.record_function) and a wall
    timer; the scope's milliseconds are left in `trace_scope.last_ms`."""
    t0 = time.perf_counter()
    if enabled:
        import torch

        with torch.profiler.record_function(name):
            yield
    else:
        yield
    trace_scope.last_ms = (time.perf_counter() - t0) * 1e3


class Stopwatch:
    """TicToc equivalent (tic_toc.h:7-21)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def toc_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3
