"""Correspondence search: exact kNN (kernels K3-K6) + PCA line fit.

Port of ``liodom_tpu/ops/neighbors.py``.  The reference rebuilds a kd-tree
over the local map and runs a 5-NN query per edge (laser_odometry.cc:318-
323); here the search is the exact brute force of ops/knn_pallas.py.  The
line test (laser_odometry.cc:325-357) — centroid and covariance of the 5
neighbours, accept when lambda_max > 3 lambda_mid, endpoints = the 2 nearest
neighbours — uses a closed-form symmetric 3x3 eigenvalue solve.  Every
function takes a leading batch dimension (``batch_image_step``).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from liodom_tpu_torch.ops.knn_pallas import (knn_coords, knn_index,
                                             knn_index_plain, knn_lines)

# The index-returning exact kNN under the JAX package's names: ``knn_auto``
# (neighbors.py:69) runs K5 for CUDA tensors and ``knn`` (neighbors.py:87),
# K5's plain version, for CPU tensors; any other device raises.  Contract:
# query (..., E, 3), qmask, ref (..., M, 3), rmask -> (d2 (..., E, k)
# ascending, idx (..., E, k) int32 into ref).
knn_auto = knn_index
knn = knn_index_plain

# The kNN implementations a caller may choose (knn_impl, LIODOM_KNN_IMPL).
# The JAX package's "xla" and "*_interpret" values are test hooks of the
# reference (its XLA search off the TPU, the Pallas kernels in interpret
# mode); here a CPU tensor always takes the kernels' plain versions.
KNN_IMPLS = ("pallas_coords", "pallas_lines")


def sym3_eigenvalues(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric 3x3 matrices (..., 3, 3), ascending, by the
    closed-form trigonometric (Cardano) method."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))

    b00, b11, b22 = (a00 - q) / safe_p, (a11 - q) / safe_p, (a22 - q) / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min
    eigs = torch.stack([e_min, e_mid, e_max], dim=-1)
    # p == 0: A = q I, all eigenvalues equal q
    return torch.where((p > 0)[..., None], eigs, q[..., None].expand_as(eigs))


class LineCorrespondences(NamedTuple):
    """Per-edge line-correspondence data for the point-to-line factors."""

    lpa: torch.Tensor    # (..., E, 3) first line point (nearest neighbour)
    lpb: torch.Tensor    # (..., E, 3) second line point (2nd nearest)
    valid: torch.Tensor  # (..., E) bool — passed distance + eigenvalue gates


def _line_fit(near: torch.Tensor, dk: torch.Tensor, emask: torch.Tensor,
              max_sq_dist: float, eig_ratio: float,
              min_line_sep: float) -> LineCorrespondences:
    """Line acceptance + endpoints from the (..., E, k, 3) neighbour
    coordinates (laser_odometry.cc:325-357).  ``dk`` is the k-th (worst)
    squared neighbour distance; rows that fail the gates carry meaningless
    coordinates, which the solver masks by ``valid``."""
    center = near.mean(dim=-2, keepdim=True)
    zm = near - center
    # un-normalised, like the ref
    cov = torch.einsum("...ki,...kj->...ij", zm, zm)
    eigs = sym3_eigenvalues(cov)
    sep_sq = ((near[..., 0, :] - near[..., 1, :]) ** 2).sum(dim=-1)
    ok = (dk < max_sq_dist) & (eigs[..., 2] > eig_ratio * eigs[..., 1])
    ok = ok & emask & (sep_sq > min_line_sep * min_line_sep)
    return LineCorrespondences(near[..., 0, :], near[..., 1, :], ok)


def resolve_knn_impl(knn_impl: str = "auto") -> str:
    """``"auto"`` reads ``LIODOM_KNN_IMPL`` at call time (A/B runs without
    editing call sites) and defaults to ``"pallas_coords"``, as
    ``neighbors.py:231-238`` does; anything outside :data:`KNN_IMPLS`
    raises."""
    if knn_impl == "auto":
        knn_impl = os.environ.get("LIODOM_KNN_IMPL", "pallas_coords")
    if knn_impl not in KNN_IMPLS:
        raise ValueError(f"knn_impl {knn_impl!r}: the port has {KNN_IMPLS}")
    return knn_impl


def line_correspondences(edges_world: torch.Tensor, emask: torch.Tensor,
                         map_pts: torch.Tensor, mmask: torch.Tensor,
                         k: int = 5, max_sq_dist: float = 1.0,
                         eig_ratio: float = 3.0, min_line_sep: float = 0.01,
                         map_presorted: bool = False,
                         knn_impl: str = "auto") -> LineCorrespondences:
    """Full correspondence stage (laser_odometry.cc:318-362): 5-NN of every
    transformed edge in the matching map, accept when the k-th neighbour is
    within ``max_sq_dist``, the neighbourhood is a line (lambda_max >
    eig_ratio * lambda_mid) and the two endpoints are at least
    ``min_line_sep`` apart.  Radius pruning at ``sqrt(max_sq_dist)`` is
    gate-exact: farther edges are rejected either way.

    ``knn_impl`` (:func:`resolve_knn_impl`): ``"pallas_coords"`` runs K3
    (edges (E, 3)) or K4 (a batch, edges (B, E, 3)) and the line fit here;
    ``"pallas_lines"`` runs K6, the search with the line fit in its
    epilogue.  CPU tensors take the plain versions either way."""
    if resolve_knn_impl(knn_impl) == "pallas_lines":
        # K6's valid already includes the edge mask (knn_pallas.py:785)
        return LineCorrespondences(*knn_lines(
            edges_world, emask, map_pts, mmask, k=k, max_sq_dist=max_sq_dist,
            eig_ratio=eig_ratio, min_line_sep=min_line_sep,
            ref_presorted=map_presorted))
    d2, near = knn_coords(edges_world, emask, map_pts, mmask, k=k,
                          max_radius=float(max_sq_dist) ** 0.5,
                          ref_presorted=map_presorted)
    return _line_fit(near, d2[..., k - 1], emask, max_sq_dist, eig_ratio,
                     min_line_sep)
