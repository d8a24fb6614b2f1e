"""Share of the window in which no device span of the program ran: the stage
copies, the captured step with its copies in and out, the pose fetches; read
at the untraced rate (no profiler). ``None`` without the program's record
(``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT, LAYER = "device_idle.program", "%", "device (H100)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.idle_share(run)
