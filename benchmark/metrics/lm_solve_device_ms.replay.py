"""Median over the sampled frames of the LM solves' device ms inside the
captured step (``lm_solve``, once an outer iteration). ``None`` without the
program's record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "lm_solve_device_ms.replay", "ms"
LAYER = "step (odometry/pipeline, mapping/service under runtime/aot)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(run, ("lm_solve",), in_graph=True)
