"""assoc_roofline: the odometry's association kernel (K4/K5, one
`assoc_normal_equations` launch a trip) as a share of its roofline, in
percent: the sum of each launch's bound over the launches in the
profiler's stretch (benchmark/work.py: the larger of its bytes at 3.35
TB/s and its operations at 67 TFLOP/s float32, the NVIDIA H100 SXM data
sheet's peaks at 700 W), over their device time in the trace.  None when
the trace holds no such launch, or not one for each recorded call.  Moves
replay_scans_per_s."""


def read(trace):
    p = trace.profile
    if not p or not p["assoc_launches"] or p["assoc_device_s"] <= 0 \
            or not trace.assoc_bound_s \
            or p["assoc_launches"] != trace.assoc_calls:
        return None
    return 100.0 * trace.assoc_bound_s / p["assoc_device_s"]
