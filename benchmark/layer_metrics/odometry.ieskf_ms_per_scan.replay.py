"""odometry.ieskf_ms_per_scan.replay: the window's time in the port's
`odometry.ieskf` spans (the iterated update, every fixed trip), per fused
pose.  Moves replay_scans_per_s."""
from benchmark.layer_metrics._program import ms_per_scan


def read(trace):
    return ms_per_scan(trace, "odometry.ieskf")
