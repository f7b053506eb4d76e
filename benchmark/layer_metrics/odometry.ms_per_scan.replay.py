"""odometry.ms_per_scan.replay: the window's time in
`LinsOdometry.add_scan_chunk`, per fused pose.  Moves replay_scans_per_s."""
from benchmark.layer_metrics._spans import ms_per_scan


def read(trace):
    return ms_per_scan(trace, "odometry.add_scan_chunk")
