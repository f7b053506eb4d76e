"""odometry.frontend_ms_per_scan.replay: the window's time in the port's
`odometry.frontend` spans (projection, segmentation and features: a
chunk's pre-label half and its one label launch, each scan's post-label
half), per fused pose.  Moves replay_scans_per_s."""
from benchmark.layer_metrics._program import ms_per_scan


def read(trace):
    return ms_per_scan(trace, "odometry.frontend")
