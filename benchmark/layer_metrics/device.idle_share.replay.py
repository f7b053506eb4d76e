"""device.idle_share.replay: 1 - (union of the device intervals / wall
time) over the profiler's stretch of the window, as chip_smoke's
profile_call reckons it.  Moves replay_scans_per_s."""
from benchmark.layer_metrics._profile import idle_share


def read(trace):
    return idle_share(trace)
