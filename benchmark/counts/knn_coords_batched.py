"""K4, the kNN of ``batch_image_step``: one launch over the lanes, each
lane K3's inputs (``benchmark/counts/knn_coords.py``); the bytes are the
lanes' sum."""

from benchmark import spec

KERNEL = "knn_coords_kernel"


def applies(frame: dict) -> bool:
    return "lanes" in frame


def count(frame: dict):
    solo = spec.count("knn_coords")
    return (sum(solo.count(lane)[0] for lane in frame["lanes"]), 0)
