"""Median over the sampled frames of the device ms of ``map.fold`` inside
the captured step: the per-slot sums folded into the centroids, ``key`` and
``valid`` decoded over the whole table (``grid.fold_frame``). ``None``
without the program's record or the span (``benchmark/program.py``)."""

from benchmark import program, spans

NAME, UNIT = "map_fold_ms.newground", "ms"
LAYER = "map (K7 csrc/local_map_compact.cu, probe csrc/probe_insert.cu)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(program.view(run), ("map.fold",),
                                  in_graph=True)
