"""K3, the exact kNN of the edges in the matching map
(``csrc/knn_coords.cu``): the bytes one launch's inputs need.

It reads each edge slot's mask and each live edge's point, each map slot's
mask and each live map point, and writes k squared distances and k
neighbour points for every edge slot.  An exact search has no operation
count fixed by its inputs (how many pairs it must look at depends on the
scene), so the bound is the bytes alone.  Nothing here reads the kernel's
tiles, flags or sort."""

KERNEL = "knn_coords_kernel"


def applies(frame: dict) -> bool:
    return "edges" in frame


def count(frame: dict):
    refs = frame["window_slots"] + frame["received_slots"]
    live = frame["window_points"] + frame["received"]
    return (frame["edge_slots"] + frame["edges"] * 12 + refs + live * 12
            + frame["edge_slots"] * frame["k"] * (4 + 12), 0)
