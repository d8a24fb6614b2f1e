"""Median over the sampled frames of the kNN's device ms inside the captured
step (``knn``: the matching map and its sort, then each outer iteration's
transform, prepare, walk and line fit). ``None`` without the program's
record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "knn_device_ms.replay", "ms"
LAYER = "kNN (K3, K4 csrc/knn_coords.cu)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(run, ("knn",), in_graph=True)
