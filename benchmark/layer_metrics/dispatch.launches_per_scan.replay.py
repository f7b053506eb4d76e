"""dispatch.launches_per_scan.replay: device operations (kernels, copies,
fills) the profiler recorded over its stretch of the window, per scan it
covered.  Moves replay_scans_per_s."""
from benchmark.layer_metrics._profile import launches_per_scan


def read(trace):
    return launches_per_scan(trace)
