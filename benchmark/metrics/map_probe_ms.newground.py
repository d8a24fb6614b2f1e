"""Median over the sampled frames of the device ms of ``map.probe`` inside
the captured step: the frame to the world, its codes, the probe with its
copy of the whole table (``grid.insert_frame``). ``None`` without the
program's record or the span (``benchmark/program.py``)."""

from benchmark import program, spans

NAME, UNIT = "map_probe_ms.newground", "ms"
LAYER = "map (K7 csrc/local_map_compact.cu, probe csrc/probe_insert.cu)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(program.view(run), ("map.probe",),
                                  in_graph=True)
