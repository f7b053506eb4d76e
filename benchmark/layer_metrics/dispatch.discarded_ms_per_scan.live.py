"""dispatch.discarded_ms_per_scan.live: host milliseconds per fused pose
spent issuing work the card computed and then discarded (`_program.
discarded_ns`: branches not kept, and the frozen trips of fixed-trip
loops), an upper bound on what deciding on the host could save before the
cost of its reads.  Moves live_p50_ms."""
from benchmark.layer_metrics._program import discarded_ms_per_scan


def read(trace):
    return discarded_ms_per_scan(trace)
