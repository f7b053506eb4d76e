"""Structured per-scan metrics and the port's span recorder (port of
`lins_tpu/utils/metrics.py`; reference C26, tic_toc.h).

Every stage records structured records that dump as JSON lines
(`MetricsLog`), and `trace_scope` records a host-clock span around each
stage of a scan in `RECORDER`, with the flags that say whether the work
the card computed was kept; `RECORDER.export` writes them as JSON lines.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict, deque

import torch

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


class SpanRecorder:
    """The spans of the port's stages, kept in memory on the host.

    A span is (name, start ns, end ns, id, parent id, root id, scan index,
    attributes), both times on `time.time_ns()`, the clock of the
    profiler's events.  The root is the outermost span open when it opened
    (a chunk, or one streamed scan); the scan index is the scan's place in
    its chunk, inherited from the enclosing span unless given.  Attributes
    are host numbers or 0-dim tensors the caller already holds: a tensor is
    kept by reference and read only by `spans()`, so recording adds no
    device operation and no host read.  The newest `capacity` spans are
    kept and the older ones counted in `dropped`; the per-name totals
    (count, ns) count every span.  One host thread records."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._open = []       # (id, root, scan) of each open span
        self._last_id = 0
        self.clear()

    def clear(self):
        """Forget the recorded spans and totals (ids keep counting)."""
        self.ring = deque(maxlen=self.capacity)
        self.dropped = 0
        self.totals = {}      # name -> [count, ns]

    def add(self, span: tuple):
        if len(self.ring) == self.capacity:
            self.dropped += 1
        self.ring.append(span)
        tot = self.totals.get(span[0])
        if tot is None:
            self.totals[span[0]] = [1, span[2] - span[1]]
        else:
            tot[0] += 1
            tot[1] += span[2] - span[1]

    def spans(self) -> list:
        """The kept spans, oldest first, as dicts (name, start_ns, end_ns,
        id, parent (0 for a root), root, scan, attrs) with every tensor
        attribute read: one copy to the host per device."""
        kept = list(self.ring)
        tensors = [v for s in kept for v in s[7].values()
                   if isinstance(v, torch.Tensor)]
        values = iter(_read(tensors))
        out = []
        for name, t0, t1, sid, parent, root, scan, attrs in kept:
            out.append(dict(
                name=name, start_ns=t0, end_ns=t1, id=sid, parent=parent,
                root=root, scan=scan,
                attrs={k: next(values) if isinstance(v, torch.Tensor) else v
                       for k, v in attrs.items()}))
        return out

    def export(self, path: str) -> list:
        """`spans()` written to `path` as JSON lines; returns them."""
        out = self.spans()
        with open(path, "w") as f:
            for s in out:
                f.write(json.dumps(s) + "\n")
        return out


def _read(tensors) -> list:
    """Python numbers of 0-dim tensors, in order: per device one stack and
    one copy to the host."""
    by_dev = defaultdict(list)
    for i, t in enumerate(tensors):
        by_dev[t.device].append(i)
    out = [None] * len(tensors)
    for idx in by_dev.values():
        block = torch.stack([tensors[i].detach().reshape(())
                             for i in idx]).double().cpu().tolist()
        for i, v in zip(idx, block):
            dt = tensors[i].dtype
            out[i] = (bool(v) if dt == torch.bool else
                      v if dt.is_floating_point else int(v))
    return out


# the port's one recorder (always on); a test may swap in a fresh one
RECORDER = SpanRecorder()


@contextlib.contextmanager
def trace_scope(name: str, scan: int | None = None, **attrs):
    """A span named `name` around the block, recorded in `RECORDER`; yields
    its attribute dict, to which the block may add (say, a loop's live
    trips once it has run).  Two clock reads and an append: nothing goes
    onto the device's timeline."""
    rec = RECORDER
    rec._last_id += 1
    sid = rec._last_id
    if rec._open:
        parent, root, outer_scan = rec._open[-1]
        if scan is None:
            scan = outer_scan
    else:
        parent, root = 0, sid
    rec._open.append((sid, root, scan))
    t0 = time.time_ns()
    try:
        yield attrs
    finally:
        t1 = time.time_ns()
        rec._open.pop()
        rec.add((name, t0, t1, sid, parent, root, scan, attrs))


@contextlib.contextmanager
def host_read(span: dict):
    """A host read of device values made inside the block (a copy that
    waits for the work that set them), counted in the attributes `span` of
    an open `trace_scope`: one more `reads`, and its wait added to
    `read_ns`."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        span["reads"] = span.get("reads", 0) + 1
        span["read_ns"] = span.get("read_ns", 0) + time.time_ns() - t0
