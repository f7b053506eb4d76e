"""Shared arithmetic of the profiler readers (None when the profiler
recorded no device activity)."""


def launches_per_scan(trace):
    p = trace.profile
    if not p or not p["launches"] or not p["scans"]:
        return None
    return p["launches"] / p["scans"]


def idle_share(trace):
    p = trace.profile
    if not p or not p["launches"] or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
