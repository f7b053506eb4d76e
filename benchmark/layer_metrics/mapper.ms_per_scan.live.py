"""mapper.ms_per_scan.live: the window's time in `LinsMapper.process` and
`LinsMapper.maybe_close_loop`, per fused pose.  Moves live_p95_ms."""
from benchmark.layer_metrics._spans import ms_per_scan


def read(trace):
    return ms_per_scan(trace, "mapper.process", "mapper.maybe_close_loop")
