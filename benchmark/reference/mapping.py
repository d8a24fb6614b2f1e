"""The map's semantics (map.cc): a VoxelGrid of ``resolution`` leaves kept
per cell of ``voxel_xysize`` x ``voxel_xysize`` x ``voxel_zsize`` metres,
each leaf one point, and the neighbourhood of cells around a pose that is
handed to the odometer (plain PyTorch over a set of rows)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.linalg import Pose, transform


class MapParams(NamedTuple):
    voxel_xysize: float
    voxel_zsize: float
    resolution: float
    cells_xy: int
    cells_z: int

    @staticmethod
    def of(config: dict) -> "MapParams":
        return MapParams(**{k: config[k] for k in MapParams._fields})


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as one float32 division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def identity(xyz: torch.Tensor, mp: MapParams) -> torch.Tensor:
    """(N, 6) int64: the cell (floor of x / size, per axis) and the leaf
    (floor of x / resolution) of each point: the leaf a point falls in,
    split where a cell boundary cuts it."""
    size = (mp.voxel_xysize, mp.voxel_xysize, mp.voxel_zsize)
    cells = [torch.floor(_div(xyz[:, a], size[a])) for a in range(3)]
    leaves = [torch.floor(_div(xyz[:, a], mp.resolution)) for a in range(3)]
    return torch.stack(cells + leaves, -1).to(torch.int64)


def update(rows: torch.Tensor, edges: torch.Tensor, evalid: torch.Tensor,
           pose: Pose, mp: MapParams, precision: str) -> torch.Tensor:
    """Map::updateMap (map.cc:90-129) on the map's points ``rows`` (M, 3),
    each the centroid of its leaf: the frame's edges to the world, and each
    leaf they touch re-filtered over {its stored point} + {the new points}
    (VoxelGrid: the mean).  Returns the new rows (M', 3)."""
    new = transform(pose, edges[evalid], precision)
    pts = torch.cat([rows, new])
    ident = identity(pts, mp)
    _, group = torch.unique(ident, dim=0, return_inverse=True)
    n = int(group.max()) + 1 if len(group) else 0
    sums = torch.zeros((n, 3), dtype=torch.float64, device=pts.device)
    sums.index_add_(0, group, pts.double())
    cnt = torch.zeros(n, dtype=torch.float64, device=pts.device)
    cnt.index_add_(0, group, torch.ones_like(group, dtype=torch.float64))
    return (sums / cnt[:, None]).to(rows.dtype)


def _int_range(init: float, end: float, step: float) -> list:
    """The C++ loop ``for (double i = init; (int)i <= (int)end; i = (int)i
    + step)`` of map.cc:160-178, as ints."""
    vals, i = [], float(init)
    while int(i) <= int(end):
        vals.append(int(i))
        i = int(i) + step
    return vals


def neighbourhood(mp: MapParams) -> np.ndarray:
    """Key offsets of getLocalMap (map.cc:141-189): the XY block of
    ``2 cells_xy + 1`` cells a side at the pose's level, and the vertical
    column whose bounds use the XY size and whose step the Z size."""
    xy, zs, cxy, cz = (mp.voxel_xysize, mp.voxel_zsize, mp.cells_xy,
                       mp.cells_z)
    offs = [(dx, dy, 0) for dx in _int_range(-cxy * xy, cxy * xy, xy)
            for dy in _int_range(-cxy * xy, cxy * xy, xy)]
    offs += [(0, 0, dz) for dz in _int_range(-cz * xy, cz * xy, zs)]
    return np.asarray(offs, np.int64)


def cell_key(xyz: torch.Tensor, mp: MapParams) -> torch.Tensor:
    """The metre-valued key of map.cc:103-105, ``int(floor(p / size) *
    size + size / 2)`` per axis, (N, 3) int64."""
    size = (mp.voxel_xysize, mp.voxel_xysize, mp.voxel_zsize)
    return torch.stack([torch.trunc(torch.floor(_div(xyz[:, a], size[a]))
                                    * size[a] + size[a] / 2.0)
                        for a in range(3)], -1).to(torch.int64)


def local_map(rows: torch.Tensor, position: torch.Tensor, mp: MapParams
              ) -> torch.Tensor:
    """Map::getLocalMap (map.cc:141-189): the rows whose cell key is the
    key of the truncated position plus one of :func:`neighbourhood`."""
    base = cell_key(torch.trunc(position)[None], mp)[0]
    want = base[None] + torch.as_tensor(neighbourhood(mp),
                                        device=rows.device)
    keys = cell_key(rows, mp)
    hit = (keys[:, None, :] == want[None]).all(-1).any(-1)
    return rows[hit]


def set_gap(a: torch.Tensor, b: torch.Tensor, mp: MapParams) -> float:
    """How far two maps' rows lie apart (m): the rows are paired by the
    leaf they fall in, and the gap is the median distance of a pair; 0 for
    equal sets, inf when fewer than 90 % of the smaller set's rows find a
    partner (the sets then differ by more than a row on a leaf's boundary,
    which lands in the next leaf on one side only; the counts catch a
    missing or extra row)."""
    if len(a) == 0 or len(b) == 0:
        return 0.0 if len(a) == len(b) else float("inf")
    ids, inv = torch.unique(torch.cat([identity(a, mp), identity(b, mp)]),
                            dim=0, return_inverse=True)
    slot_a = torch.full((len(ids),), -1, dtype=torch.int64, device=a.device)
    slot_b = slot_a.clone()
    slot_a[inv[:len(a)]] = torch.arange(len(a), device=a.device)
    slot_b[inv[len(a):]] = torch.arange(len(b), device=a.device)
    both = (slot_a >= 0) & (slot_b >= 0)
    if int(both.sum()) < 0.9 * min(len(a), len(b)):
        return float("inf")
    d = torch.linalg.norm(a[slot_a[both]].double() - b[slot_b[both]].double(),
                          dim=-1)
    return float(d.median())


def received_rows(xyz: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, int]:
    """A received local map's live rows and their count."""
    rows = xyz[valid]
    return rows, len(rows)
