"""Device idle ms a frame whose gaps fall to the host being in the loader
(``loader.next``) or the staging (``stage.put``): the card waiting for the
next frame. ``None`` without the program's record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "loader_idle_ms.replay", "ms"
LAYER = "app frame loop (runtime/native, runtime/device_io)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.idle_ms_in(run, ("loader.next", "stage.put"))
