"""odometry.ms_per_scan.live: the window's time in
`LinsOdometry.add_scan`, per fused pose.  Moves live_p50_ms."""
from benchmark.layer_metrics._spans import ms_per_scan


def read(trace):
    return ms_per_scan(trace, "odometry.add_scan")
