"""Mean rows a frame of the local map handed to the kNN (``local_map.rows``,
counted on the card inside the captured step). ``None`` without the
program's record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "local_map_rows.replay", "rows"
LAYER = "map (K7 csrc/local_map_compact.cu, probe csrc/probe_insert.cu)"
MOVES, SOURCE = "scans_per_s", "program_counter"


def read(run):
    return spans.count_per_frame(run, "local_map.rows")
