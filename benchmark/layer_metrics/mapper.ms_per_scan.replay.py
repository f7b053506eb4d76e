"""mapper.ms_per_scan.replay: the window's time in
`LinsMapper.process_chunk` (mapping steps, loop attempts and solves), per
fused pose.  Moves replay_scans_per_s."""
from benchmark.layer_metrics._spans import ms_per_scan


def read(trace):
    return ms_per_scan(trace, "mapper.process_chunk")
