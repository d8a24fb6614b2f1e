"""K2, the greedy edge selection (``csrc/select.cu``): bytes and
operations one launch's inputs need, a lower bound.

Any selection reads the counts and the smoothness of every column in the
regions of the rings that take part (``count >= regions * (picks - 1) +
10``: the columns ``[5, count - 5)``), reads each pick's point, and writes
every slot (12 bytes of point and a mask byte); it compares each such
column at least once.  The suppression's reads of the neighbours, which
depend on the order of the picks, are not counted."""

import numpy as np

KERNEL = "select_kernel"


def applies(frame: dict) -> bool:
    return "counts" in frame


def count(frame: dict):
    counts = np.minimum(np.asarray(frame["counts"], np.int64),
                        frame["ring_width"])
    active = counts >= frame["regions"] * (frame["picks"] - 1) + 10
    columns = int(np.clip(counts[active] - 10, 0, None).sum())
    slots = frame["rings"] * frame["regions"] * frame["picks"]
    return (frame["rings"] * 4 + columns * 4 + frame["edges"] * 12
            + slots * (12 + 1), columns)
