"""loop.ms_per_attempt.live: the mean time of the port's `loop.attempt`
spans in the window (detection, alignment, solve and rewrite, each
computed whether or not it is kept).  Moves live_p95_ms."""
from benchmark.layer_metrics._program import ms_per_span


def read(trace):
    return ms_per_span(trace, "loop.attempt")
