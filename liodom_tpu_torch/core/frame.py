"""Fixed-shape scan containers (torch tensors).

* :class:`RawScan` — padded (N, 3) points straight from the sensor/loader.
* :class:`RingImage` — points routed into rings, padded to (rings, width, 3),
  the layout every downstream op consumes.
* :class:`EdgeCloud` — extracted edge features, padded (E, 3) + mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RawScan(NamedTuple):
    xyz: torch.Tensor    # (N, 3) padded point coordinates
    valid: torch.Tensor  # (N,) bool — padding mask from the loader

    @staticmethod
    def from_points(xyz, capacity: int, device=None) -> "RawScan":
        xyz = torch.as_tensor(xyz, device=device)
        n = xyz.shape[0]
        if n > capacity:
            raise ValueError(f"scan has {n} points > capacity {capacity}")
        out = xyz.new_zeros((capacity, 3))
        out[:n] = xyz
        valid = torch.zeros(capacity, dtype=torch.bool, device=xyz.device)
        valid[:n] = True
        return RawScan(out, valid)


class RingImage(NamedTuple):
    """Scan split into rings (reference: splitPointCloud,
    feature_extractor.cc:104-179), as a dense padded image.  Within a ring,
    points keep their input order — the smoothness stencil and neighbour
    suppression depend on it."""

    xyz: torch.Tensor     # (rings, width, 3)
    count: torch.Tensor   # (rings,) int32 — points routed into each ring


def ring_mask(img: RingImage) -> torch.Tensor:
    w = img.xyz.shape[1]
    cols = torch.arange(w, dtype=img.count.dtype, device=img.count.device)
    return cols[None, :] < img.count[:, None]


class EdgeCloud(NamedTuple):
    xyz: torch.Tensor    # (..., E, 3)
    valid: torch.Tensor  # (..., E) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)
