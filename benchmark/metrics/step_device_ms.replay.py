"""Device time a step: the union of the device intervals of the traced
stretch over its steps (a batched step counts once)."""

NAME, UNIT = "step_device_ms.replay", "ms"
LAYER = "step (odometry/pipeline, mapping/service under runtime/aot)"
MOVES, SOURCE = "scans_per_s", "device_trace"


def read(run):
    tr = run.trace
    if tr is None or tr.frames <= 0 or tr.busy_s <= 0:
        return None
    return 1e3 * tr.busy_s / tr.frames
