"""Host-side profiler events a frame at the live rate: the eager step's
operators and the CUDA runtime calls they make (the benchmark's own
labels left out)."""

NAME, UNIT = "host_ops_per_frame.live", "ops/frame"
LAYER = "step (odometry/pipeline, mapping/service under runtime/aot)"
MOVES, SOURCE = "pose_latency_p95_ms", "device_trace"


def read(run):
    tr = run.trace
    if tr is None or tr.frames <= 0 or tr.host_ops <= 0:
        return None
    return tr.host_ops / tr.frames
