"""Shared arithmetic of the span readers: a span's window seconds in
milliseconds per fused pose of the window (None when nothing was read)."""


def ms_per_scan(trace, *names):
    total = sum(trace.tracer.seconds(n) for n in names)
    if total <= 0 or trace.window_scans <= 0:
        return None
    return 1e3 * total / trace.window_scans
