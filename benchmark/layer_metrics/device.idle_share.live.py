"""device.idle_share.live: 1 - (union of the device intervals / wall
time) over the profiler's stretch of the window, as chip_smoke's
profile_call reckons it.  Moves live_p50_ms."""
from benchmark.layer_metrics._profile import idle_share


def read(trace):
    return idle_share(trace)
