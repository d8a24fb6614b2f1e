"""Share of its roofline of the kernel counted by
``benchmark/counts/knn_coords.py``, over the traced stretch (the least
time of the traced frames' work over the kernel's time on the card)."""

from benchmark import roofline

NAME, UNIT = "knn_coords.roofline", "%"
LAYER = "kNN (K3, K4 csrc/knn_coords.cu)"
MOVES, SOURCE = "scans_per_s", "device_trace"


def read(run):
    return roofline.share(run, "knn_coords")
