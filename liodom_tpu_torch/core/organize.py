"""Row-organised (Ouster-style) clouds from unorganised ones: the port's
copy of the numpy helper ``organized_from_unorganized`` of
``liodom_tpu/core/io.py`` (the port's ``core/io.py`` re-exports it).  It
turns a synthetic spin into the input of
:func:`liodom_tpu_torch.ops.features.split_scan_ouster`."""

from __future__ import annotations

import numpy as np


def organized_from_unorganized(xyz: np.ndarray, rings: int,
                               width: int) -> np.ndarray:
    """Arrange an unorganised (N, 3) cloud into a (rings, width, 3)
    row-organised image by elevation and azimuth binning; empty cells are
    zeros, and a later point wins a shared cell.  (A real Ouster driver
    emits row-major organised clouds already; feature_extractor.cc:158-175
    relies on that.)"""
    d = np.linalg.norm(xyz[:, :2], axis=1)
    elev = np.arctan2(xyz[:, 2], np.maximum(d, 1e-9))
    az = np.arctan2(xyz[:, 1], xyz[:, 0])
    lo, hi = elev.min(), elev.max() + 1e-6
    row = np.clip(((hi - elev) / (hi - lo) * rings).astype(int), 0, rings - 1)
    col = np.clip(((az + np.pi) / (2 * np.pi) * width).astype(int),
                  0, width - 1)
    img = np.zeros((rings, width, 3), np.float32)
    img[row, col] = xyz
    return img
