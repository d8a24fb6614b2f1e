"""Mean probe rounds a frame over the window (``map.probe_rounds``: the
rounds ``csrc/probe_insert.cu`` writes, counted on the card inside the
captured step). ``None`` without the program's record or the counter
(``benchmark/program.py``)."""

from benchmark import program, spans

NAME, UNIT = "probe_rounds.newground", "rounds/frame"
LAYER = "map (K7 csrc/local_map_compact.cu, probe csrc/probe_insert.cu)"
MOVES, SOURCE = "scans_per_s", "program_counter"


def read(run):
    return spans.count_per_frame(program.view(run), "map.probe_rounds")
