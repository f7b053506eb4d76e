"""mapper.ms_per_step.replay: the mean time of the port's `mapper.step`
spans in the window (one mapping step: downsampling, scan-to-map, keyframe
gate and window upkeep).  Moves replay_scans_per_s."""
from benchmark.layer_metrics._program import ms_per_span


def read(trace):
    return ms_per_span(trace, "mapper.step")
