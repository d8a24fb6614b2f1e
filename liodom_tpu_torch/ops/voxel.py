"""Voxel-grid downsampling, a centroid per occupied leaf (port of
``liodom_tpu/ops/voxel.py``).

Replaces ``pcl::VoxelGrid`` for the optional local-map filter
(laser_odometry.cc:286-295): quantise each point to its leaf, pack the leaf
coordinate into one int32 key, stable-sort the keys and average each run.
The output keeps the padded capacity with a validity mask, the leaves in
key order (the kNN consumer does not depend on the order).  On CUDA it is
a few torch operations with no host synchronisation.  The segment sums run
over each leaf's points in sorted order, one after another
(``segment_reduce``), as JAX's ``segment_sum`` does on the CPU: the
centroids are the same on the card and on the CPU, bit for bit, and the
same from run to run (an ``index_add_`` on CUDA would sum in atomic
order).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# 10 bits an axis: up to 1,024 leaves an axis a call.  At the reference's
# 0.4 m leaf that spans 409 m, beyond the 75 m range gate plus the window's
# motion; the grid is re-anchored at the valid minimum before quantising.
_BITS = 10
_SPAN = 1 << _BITS
_INVALID_KEY = 1 << 30


def voxel_keys(xyz: torch.Tensor, valid: torch.Tensor,
               leaf: float) -> torch.Tensor:
    """The leaf key of each point, (..., N) int32: ``floor(p / leaf)``
    against the global grid, offset by the leaf of the valid points'
    minimum and clipped to 10 bits an axis; invalid points get
    ``1 << 30``, above every leaf.

    ``p / leaf`` is taken as ``p`` times the float32 reciprocal of the
    leaf: XLA compiles JAX's divide by the constant so (and PCL multiplies
    by ``inverse_leaf_size_``); a true divide puts some points that lie on
    a leaf boundary into the next leaf."""
    inv = float(np.float32(1.0) / np.float32(leaf))
    inf = torch.full((), float("inf"), dtype=xyz.dtype, device=xyz.device)
    anchor = torch.where(valid[..., None], xyz, inf).amin(dim=-2)
    anchor = torch.where(torch.isfinite(anchor), anchor,
                         torch.zeros_like(anchor))
    q_abs = torch.floor(xyz * inv).to(torch.int32)
    q0 = torch.floor(anchor * inv).to(torch.int32)
    q = torch.clamp(q_abs - q0[..., None, :], 0, _SPAN - 1)
    key = (q[..., 0] << (2 * _BITS)) | (q[..., 1] << _BITS) | q[..., 2]
    return torch.where(valid, key, torch.full_like(key, _INVALID_KEY))


def voxel_downsample(xyz: torch.Tensor, valid: torch.Tensor, leaf: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroid-per-leaf downsample, PCL VoxelGrid's semantics: leaf index
    ``floor(p / leaf)``, one output point a leaf, the mean of its points.

    xyz (..., N, 3), valid (..., N) -> (out_xyz (..., N, 3), out_valid
    (..., N)): the leaves compacted to the front in key order, the rest
    zero.  Leading dimensions are independent clouds (a batched window)."""
    lead, n = xyz.shape[:-2], xyz.shape[-2]
    dev = xyz.device
    key = voxel_keys(xyz, valid, leaf)
    order = torch.argsort(key, dim=-1, stable=True)
    key_s = key.gather(-1, order)
    xyz_s = xyz.gather(-2, order[..., None].expand(xyz.shape))
    valid_s = valid.gather(-1, order)

    head = torch.cat([torch.ones(lead + (1,), dtype=torch.bool, device=dev),
                      key_s[..., 1:] != key_s[..., :-1]], dim=-1)
    seg = torch.cumsum(head.to(torch.int64), dim=-1) - 1      # (..., N)
    # one index space over the leading dimensions: cloud b's segments at
    # b * n + seg, each a run of consecutive sorted rows; the rows past the
    # last segment are empty segments
    b = math.prod(lead)
    seg_flat = (seg.reshape(b, n)
                + torch.arange(b, device=dev)[:, None] * n).reshape(-1)
    lengths = torch.zeros(b * n, dtype=torch.int64, device=dev).index_add_(
        0, seg_flat, torch.ones_like(seg_flat))
    w = valid_s.to(xyz.dtype)[..., None]
    payload = torch.cat([xyz_s * w, w], dim=-1).reshape(b * n, 4)
    # unsafe: the lengths sum to b * n by construction; checking it would
    # read them back to the host
    acc = torch.segment_reduce(payload, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    means = (acc[:, :3] / torch.clamp(acc[:, 3:], min=1.0)).reshape(xyz.shape)

    nseg_valid = (head & valid_s).sum(dim=-1)
    out_valid = (torch.arange(n, device=dev) < nseg_valid[..., None])
    out_xyz = torch.where(out_valid[..., None], means, torch.zeros_like(means))
    return out_xyz, out_valid
