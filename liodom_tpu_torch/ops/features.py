"""Feature extraction: ring routing, smoothness, region-wise edge selection.

Port of ``liodom_tpu/ops/features.py`` (reference feature_extractor.cc):

* ``splitPointCloud`` (:104-179) — each point is classified into its ring
  (Velodyne: :func:`split_scan`, the ring from the elevation angle; Ouster:
  :func:`split_scan_ouster`, the row of an organised cloud) and one stable
  sort packs the rings into a dense padded ``(rings, width)`` image, input
  order kept within a ring.  No step synchronises with the host: the ring
  counts are a scatter-add into a fixed ``(rings + 1,)`` tensor.
  :func:`~liodom_tpu_torch.odometry.pipeline.image_step` starts from the
  ring image; ``full_step`` and ``combined_step`` split on the device.
* :func:`smoothness` — the 11-tap stencil, kernel K1
  (ops/smoothness_pallas.py).
* :func:`select_edges` — the greedy region-wise pick chain, kernel K2
  (ops/select_pallas.py).
* :func:`extract_features` — split, smoothness, select: raw scan in, edges
  out.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from liodom_tpu_torch.core.config import LiodomConfig
from liodom_tpu_torch.core.frame import EdgeCloud, RawScan, RingImage
from liodom_tpu_torch.ops.select_pallas import f32, select_edges_kernel
from liodom_tpu_torch.ops.smoothness_pallas import smoothness_kernel

_RAD2DEG = 180.0 / math.pi


def xy_range(xyz: torch.Tensor) -> torch.Tensor:
    """Horizontal (XY) range — the reference gates and weights by this, not
    by 3-D range (feature_extractor.cc:96, factors.hpp:91-93)."""
    return torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)


def valid_points(xyz: torch.Tensor, cfg: LiodomConfig) -> torch.Tensor:
    """isValidPoint (feature_extractor.cc:84-102): finite and XY-range
    gated."""
    finite = torch.isfinite(xyz).all(dim=-1)
    d = xy_range(xyz)
    return finite & (d >= f32(cfg.min_range)) & (d <= f32(cfg.max_range))


def ring_id_velodyne(xyz: torch.Tensor, cfg: LiodomConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring index from elevation angle — the hard-coded 64/32/16-line
    formulas of feature_extractor.cc:127-151.  Returns (ring_id int32,
    in_fov bool)."""
    d = xy_range(xyz)
    # the divide is guarded for padded zeros, which valid_points gates out
    angle = torch.atan(xyz[..., 2] / torch.clamp(d, min=1e-9)) * _RAD2DEG
    n = cfg.scan_lines
    if n == 64:
        upper = angle >= f32(-8.83)
        rid = torch.where(
            upper,
            ((2.0 - angle) * 3.0 + 0.5).to(torch.int32),
            n // 2 + ((f32(-8.83) - angle) * 2.0 + 0.5).to(torch.int32),
        )
        ok = ((angle <= 2.0) & (angle >= f32(-24.33)) & (rid >= 0)
              & (rid <= 63))
    elif n == 32:
        rid = ((angle + f32(92.0 / 3.0)) * 3.0 / 4.0).to(torch.int32)
        ok = (rid >= 0) & (rid <= n - 1)
    elif n == 16:
        rid = ((angle + 15.0) / 2.0 + 0.5).to(torch.int32)
        ok = (rid >= 0) & (rid <= n - 1)
    else:
        raise ValueError(f"unsupported scan_lines: {n}")
    return rid, ok


def _ring_counts(ring: torch.Tensor, ok: torch.Tensor,
                 r: int) -> torch.Tensor:
    """Points routed to each of the ``r`` rings, (r,) int64, unclamped.

    A scatter-add into a fixed ``(r + 1,)`` tensor whose last slot takes the
    unrouted points: ``torch.bincount`` reads its input's maximum back to the
    host to size its output, which would synchronise the step."""
    slot = torch.where(ok, ring, torch.full_like(ring, r))
    counts = torch.zeros(r + 1, dtype=torch.int64, device=ring.device)
    return counts.index_add_(0, slot, torch.ones_like(slot))[:r]


def _pack_rings(xyz: torch.Tensor, ring: torch.Tensor, ok: torch.Tensor,
                cfg: LiodomConfig) -> RingImage:
    """Stable-sort points by ring and scatter them into the (rings, width)
    image: the reference's sequential push_back routing
    (feature_extractor.cc:153-156), input order kept within a ring."""
    n = xyz.shape[0]
    r, w = cfg.scan_lines, cfg.ring_width
    dev = xyz.device
    ring = ring.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    key = torch.where(ok, ring * n + idx, r * n + idx)
    order = torch.argsort(key, stable=True)
    ring_s = torch.where(ok, ring, torch.full_like(ring, r))[order]
    ok_s = ok[order]
    xyz_s = xyz[order]
    raw_counts = _ring_counts(ring, ok, r)
    counts = torch.clamp(raw_counts, max=w).to(torch.int32)
    # offsets over the *unclamped* counts: a ring that overflows the padded
    # width must not shift the packing of the rings after it
    offsets = torch.cat([raw_counts.new_zeros(1), torch.cumsum(raw_counts, 0)])
    pos = idx - offsets[torch.clamp(ring_s, 0, r - 1)]
    keep = ok_s & (pos < w)
    flat_idx = torch.where(keep, ring_s * w + pos,
                           torch.full_like(pos, r * w))   # overflow slot
    out = xyz.new_zeros((r * w + 1, 3))
    out[flat_idx] = xyz_s   # dropped points all land in the overflow row
    return RingImage(out[:-1].reshape(r, w, 3), counts)


def split_scan(raw: RawScan, cfg: LiodomConfig) -> RingImage:
    """Velodyne-mode splitPointCloud (feature_extractor.cc:113-157)."""
    ok = raw.valid & valid_points(raw.xyz, cfg)
    rid, in_fov = ring_id_velodyne(raw.xyz, cfg)
    return _pack_rings(raw.xyz, rid, ok & in_fov, cfg)


def split_overflow(raw: RawScan, cfg: LiodomConfig) -> torch.Tensor:
    """Routed points DROPPED by the ``ring_width`` clamp for this scan (int
    tensor).  The reference's ring vectors are unbounded
    (feature_extractor.cc:153-156), so a non-zero value is a lossy deviation
    the caller must report."""
    ok = raw.valid & valid_points(raw.xyz, cfg)
    rid, in_fov = ring_id_velodyne(raw.xyz, cfg)
    ok = ok & in_fov
    raw_counts = _ring_counts(rid.to(torch.int64), ok, cfg.scan_lines)
    return torch.clamp(raw_counts - cfg.ring_width, min=0).sum()


def split_scan_ouster(organized_xyz: torch.Tensor,
                      cfg: LiodomConfig) -> RingImage:
    """Ouster-mode splitPointCloud (feature_extractor.cc:158-175): the cloud
    (H, W0, 3) is row-organised and the row index is the ring; invalid
    points are dropped and rows are left-compacted."""
    h, w0, _ = organized_xyz.shape
    if h > cfg.scan_lines:
        raise ValueError(f"organised cloud of {h} rows for "
                         f"{cfg.scan_lines} scan lines")
    flat = organized_xyz.reshape(h * w0, 3)
    ok = valid_points(flat, cfg)
    rid = torch.div(torch.arange(h * w0, dtype=torch.int64,
                                 device=flat.device), w0,
                    rounding_mode="floor")
    return _pack_rings(flat, rid, ok, cfg)


def smoothness(img: RingImage, cfg: LiodomConfig) -> torch.Tensor:
    """11-tap second-difference smoothness (feature_extractor.cc:195-232):
    kernel K1 on CUDA, its plain version on the CPU.  A batch of images
    (B, R, W, 3) is folded into B*R rings, one launch (the custom_vmap rule
    of ``features.py:52-57``): rings are independent."""
    del cfg  # the stencil has no parameters; kept for the JAX signature
    if img.xyz.ndim == 4:
        b, r, w, _ = img.xyz.shape
        return smoothness_kernel(img.xyz.reshape(b * r, w, 3),
                                 img.count.reshape(b * r)).reshape(b, r, w)
    return smoothness_kernel(img.xyz, img.count)


def select_edges(img: RingImage, smooth: torch.Tensor,
                 cfg: LiodomConfig) -> EdgeCloud:
    """Region-wise greedy edge selection (feature_extractor.cc:181-313):
    kernel K2 on CUDA, its plain version on the CPU.  Slot layout
    ``ring * S + region * (edges_per_region + 1) + pick``.  A batch of
    images is folded into B*R rings, one launch, and comes back as
    (B, R*S) slots (``features.py:78-86``): the pick chain never crosses
    rings, so each element matches its solo selection bit for bit."""
    if img.xyz.ndim == 4:
        b, r, w, _ = img.xyz.shape
        ec = select_edges_kernel(
            RingImage(img.xyz.reshape(b * r, w, 3), img.count.reshape(b * r)),
            smooth.reshape(b * r, w), cfg)
        return EdgeCloud(ec.xyz.reshape(b, -1, 3), ec.valid.reshape(b, -1))
    return select_edges_kernel(img, smooth, cfg)


def extract_features(raw: RawScan, cfg: LiodomConfig) -> EdgeCloud:
    """The Velodyne-mode extractor: :func:`split_scan`, then K1, then K2.
    Raw scan in, edge slots out; on CUDA without a host synchronisation."""
    img = split_scan(raw, cfg)
    return select_edges(img, smoothness(img, cfg), cfg)
