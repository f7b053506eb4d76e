"""driver.stage_s: seconds of the first drive's `LinsSlam.stage_replay`
(bootstrap streaming, IMU buffering, chunk prefetch), which runs in
set-up.  Moves setup_s."""


def read(trace):
    s = trace.tracer.seconds("driver.stage_replay", phase="setup")
    return s if s > 0 else None
