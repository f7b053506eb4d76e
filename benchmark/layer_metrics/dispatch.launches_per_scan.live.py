"""dispatch.launches_per_scan.live: device operations (kernels, copies,
fills) the profiler recorded over its stretch of the window, per scan it
covered.  Moves live_p50_ms."""
from benchmark.layer_metrics._profile import launches_per_scan


def read(trace):
    return launches_per_scan(trace)
