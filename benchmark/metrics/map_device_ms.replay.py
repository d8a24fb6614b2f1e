"""Median over the sampled frames of the map's device ms inside the captured
step (``map.update`` with the probe, ``map.local`` with K7). ``None``
without the program's record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "map_device_ms.replay", "ms"
LAYER = "map (K7 csrc/local_map_compact.cu, probe csrc/probe_insert.cu)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(run, ("map.update", "map.local"),
                                   in_graph=True)
