"""Median device ms a frame of the captured step's replay (``aot.graph``).
``None`` without the program's record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "graph_device_ms.replay", "ms"
LAYER = "step (odometry/pipeline, mapping/service under runtime/aot)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(run, ("aot.graph",), in_graph=False)
