"""MB a frame the warm start copies into the captured step's inputs and
clones out of its outputs (``aot.copy_bytes``, a host count a replay),
over the window. ``None`` without the program's record or the counter
(``benchmark/program.py``)."""

from benchmark import program, spans

NAME, UNIT = "state_copy_mb.newground", "MB/frame"
LAYER = "step (odometry/pipeline, mapping/service under runtime/aot)"
MOVES, SOURCE = "scans_per_s", "program_counter"


def read(run):
    got = spans.count_per_frame(program.view(run), "aot.copy_bytes")
    return None if got is None else got / 1e6
