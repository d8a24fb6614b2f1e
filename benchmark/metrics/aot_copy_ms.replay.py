"""Median device ms a frame of the warm start's copies into the graph's inputs
and out of its outputs (``aot.copy_in`` + ``aot.clone_out``), stream time:
the host's pacing between the copies included. ``None`` without the
program's record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "aot_copy_ms.replay", "ms"
LAYER = "step (odometry/pipeline, mapping/service under runtime/aot)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(run, ("aot.copy_in", "aot.clone_out"),
                                   in_graph=False)
