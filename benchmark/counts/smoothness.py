"""K1, the smoothness stencil (``csrc/smoothness.cu``): bytes and
operations one launch's inputs need.

It reads the points below each ring's count (12 bytes each) and the
counts, and writes the whole (rings, width) float32 plane; each interior
point (``[5, count - 5)``) takes 33 adds for the 11 taps, 3 multiplies
for ``-11 p`` and 5 for the squared norm.  Nothing here reads how the
kernel tiles the rings."""

import numpy as np

KERNEL = "smooth_kernel"


def applies(frame: dict) -> bool:
    return "counts" in frame


def count(frame: dict):
    counts = np.minimum(np.asarray(frame["counts"], np.int64),
                        frame["ring_width"])
    r, w = frame["rings"], frame["ring_width"]
    interior = int(np.clip(counts - 10, 0, None).sum())
    return (int(counts.sum()) * 12 + r * 4 + r * w * 4,
            interior * (33 + 3 + 5))
