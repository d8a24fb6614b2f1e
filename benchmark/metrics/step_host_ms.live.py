"""Median host ms a frame in the eager ``step`` span: the host's dispatch of
the step, its layers' spans inside. ``None`` without the program's record
(``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "step_host_ms.live", "ms"
LAYER = "step (odometry/pipeline, mapping/service under runtime/aot)"
MOVES, SOURCE = "pose_latency_p95_ms", "program_span"


def read(run):
    return spans.host_median_ms(run, ("step",))
