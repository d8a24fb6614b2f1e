"""Share of its roofline of the kernel counted by
``benchmark/counts/probe_insert.py``, over the traced stretch (the least
time of the traced frames' work over the kernel's time on the card)."""

from benchmark import roofline

NAME, UNIT = "probe_insert.roofline", "%"
LAYER = "map (K7 csrc/local_map_compact.cu, probe csrc/probe_insert.cu)"
MOVES, SOURCE = "scans_per_s", "device_trace"


def read(run):
    return roofline.share(run, "probe_insert")
