"""Shared arithmetic of the readers of the port's own spans
(`lins_tpu_torch.utils.metrics.RECORDER`, recorded whether or not the run
is traced): the spans that lie inside a window-phase span of the
benchmark around one of the port's entries, their device attributes read
once.  Every reader returns None where nothing was read, as with a port
that records no spans."""
from __future__ import annotations

import bisect

# the benchmark's spans around the port's entries that the window holds
ENTRIES = ("odometry.add_scan_chunk", "mapper.process_chunk",
           "driver.restage", "odometry.add_scan", "mapper.process",
           "mapper.maybe_close_loop", "replay.sharded_step")


def window_spans(trace) -> list:
    """The port's spans inside the window's entry spans (dicts of
    `SpanRecorder.spans`), read once per trace."""
    if getattr(trace, "program_spans", None) is None:
        trace.program_spans = _read(trace)
    return trace.program_spans


def _read(trace) -> list:
    from lins_tpu_torch.utils import metrics

    rec = getattr(metrics, "RECORDER", None)
    if rec is None:
        return []
    boxes = sorted((t0, t1) for name, t0, t1, phase in trace.tracer.spans
                   if phase == "window" and name in ENTRIES)
    if not boxes:
        return []
    starts = [b[0] for b in boxes]
    out = []
    for s in rec.spans():
        i = bisect.bisect_right(starts, s["start_ns"]) - 1
        if i >= 0 and s["end_ns"] <= boxes[i][1]:
            out.append(s)
    return out


def _ns(s) -> int:
    return s["end_ns"] - s["start_ns"]


def named(trace, name: str) -> list:
    return [s for s in window_spans(trace) if s["name"] == name]


def ms_per_scan(trace, name: str):
    """The window's time in the spans `name`, per fused pose."""
    spans = named(trace, name)
    if not spans or trace.window_scans <= 0:
        return None
    return sum(map(_ns, spans)) / 1e6 / trace.window_scans


def ms_per_span(trace, name: str):
    """The mean time of a span `name` in the window."""
    spans = named(trace, name)
    if not spans:
        return None
    return sum(map(_ns, spans)) / 1e6 / len(spans)


def discarded_ns(spans) -> float:
    """Host time spent issuing work the card computed and then discarded:
    each `cond` span whose `kept` is false, whole, and each fixed-trip
    loop span with a `live` count, its self time (less its `cond` spans)
    times (trips - live) / trips; only spans with no discarded ancestor."""
    by_id = {s["id"]: s for s in spans}
    conds_ns = {}
    for s in spans:
        if "kept" in s["attrs"]:
            conds_ns[s["parent"]] = conds_ns.get(s["parent"], 0) + _ns(s)

    def dropped(s):
        return "kept" in s["attrs"] and not s["attrs"]["kept"]

    def under_dropped(s):
        p = by_id.get(s["parent"])
        while p is not None:
            if dropped(p):
                return True
            p = by_id.get(p["parent"])
        return False

    total = 0.0
    for s in spans:
        a = s["attrs"]
        if dropped(s):
            if not under_dropped(s):
                total += _ns(s)
        elif a.get("trips") and "live" in a and not under_dropped(s):
            own = _ns(s) - conds_ns.get(s["id"], 0)
            total += own * (a["trips"] - a["live"]) / a["trips"]
    return total


def discarded_ms_per_scan(trace):
    spans = window_spans(trace)
    if not spans or trace.window_scans <= 0:
        return None
    return discarded_ns(spans) / 1e6 / trace.window_scans
