"""Median over the sampled frames of the features' device ms inside the
captured step (``features``: K1, K2 and the edges' compaction). ``None``
without the program's record (``benchmark/spans.py``)."""

from benchmark import spans

NAME, UNIT = "features_device_ms.replay", "ms"
LAYER = "features (K1 csrc/smoothness.cu, K2 csrc/select.cu)"
MOVES, SOURCE = "scans_per_s", "program_span"


def read(run):
    return spans.device_median_ms(run, ("features",), in_graph=True)
