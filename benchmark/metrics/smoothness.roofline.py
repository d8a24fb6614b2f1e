"""Share of its roofline of the kernel counted by
``benchmark/counts/smoothness.py``, over the traced stretch (the least
time of the traced frames' work over the kernel's time on the card)."""

from benchmark import roofline

NAME, UNIT = "smoothness.roofline", "%"
LAYER = "features (K1 csrc/smoothness.cu, K2 csrc/select.cu)"
MOVES, SOURCE = "scans_per_s", "device_trace"


def read(run):
    return roofline.share(run, "smoothness")
